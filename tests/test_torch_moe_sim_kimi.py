"""Training Kimi-K2 (GQA 8 / 2 at hd 32 in its reduced config, MoE with a shared
expert) through the port's ``SimulatedRun`` against the reference
simulator, on the CPU: the run, bounds, AdamW eps and torch thread of
``test_torch_moe_sim.py`` (split from it to keep each file near 30 s),
and the same run at AdamW's default eps with every leaf but the untied
embedding table held to the bounds."""

import pytest

pytest.importorskip("torch")

from test_torch_moe_sim import (one_torch_thread,  # noqa: E402,F401
                                simulated_run_at_default_eps, simulated_run_vs_reference)


def test_kimi_simulated_run_matches_reference():
    simulated_run_vs_reference("kimi-k2-1t-a32b")


def test_kimi_simulated_run_at_default_eps():
    simulated_run_at_default_eps("kimi-k2-1t-a32b")
