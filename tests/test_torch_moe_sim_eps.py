"""Training DeepSeek-V2-236B through the port's ``SimulatedRun`` against the
reference simulator at AdamW's default eps (1e-8): the run of
``test_torch_moe_sim.py``, with every leaf but the untied embedding table
held to its bounds (split from it to keep each file near 30 s; why the
table is not held is in its docstring)."""

import pytest

pytest.importorskip("torch")

from test_torch_moe_sim import (one_torch_thread,  # noqa: E402,F401
                                simulated_run_at_default_eps)


def test_deepseek_simulated_run_at_default_eps():
    simulated_run_at_default_eps("deepseek-v2-236b")
