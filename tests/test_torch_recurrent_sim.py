"""Training RecurrentGemma-9B through the port's ``SimulatedRun`` against
the reference simulator, on the CPU (xLSTM-1.3B in
``test_torch_recurrent_sim_xlstm.py``, through the same helper).

12 steps at G = 2, flat fp32 outer sync, at delay 0 and 1, at the reduced
configs in fp32, from the reference's initial parameters and the same
numpy batches (``test_torch_moe_sim.py``'s helper: lazy start, the switch
to groups, outer syncs every second step; at delay 1 each outer target
installs a step late with the stale-delta correction). The bounds are
those of ``test_torch_qwen3.py``'s 12-step run: every loss within 1e-5;
each final leaf's difference within 1e-4 of how far the leaf moved (L2
norms) and every element within 1.5e-4, at AdamW eps 1e-6 as the MoE runs
(the helper's docstring). sLSTM's input-gate bias ``b_i`` has a zero
gradient in exact arithmetic, so AdamW steps it on rounding noise on both
sides: it is held to the element bound alone
(``test_torch_recurrent_train.py``).
"""

import pytest

pytest.importorskip("torch")

from test_torch_moe_sim import (one_torch_thread,  # noqa: E402,F401
                                assert_within_bounds, run_vs_reference)

import repro_torch.configs as pt_configs  # noqa: E402


def _noise_leaves(arch):
    cfg = pt_configs.get_reduced_config(arch)
    return {f"layers.{i}.mix.b_i" for i in range(cfg.num_layers)
            if cfg.block_kind(i) == "slstm"}


@pytest.mark.parametrize("delay", [0, 1])
def test_recurrentgemma_simulated_run_matches_reference(delay):
    simulated_run_vs_reference("recurrentgemma-9b", delay)


def simulated_run_vs_reference(arch, delay):
    ploss, jloss, _, gaps = run_vs_reference(arch, sync_delay=delay)
    for name in _noise_leaves(arch):
        assert gaps.pop(name)[0] <= 1.5e-4, name
    assert_within_bounds(ploss, jloss, gaps, f"{arch} at delay {delay}")
