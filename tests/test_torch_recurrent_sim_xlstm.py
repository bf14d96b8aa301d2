"""Training xLSTM-1.3B (its reduced config: one mLSTM and one sLSTM
layer) through the port's ``SimulatedRun`` against the reference
simulator, on the CPU: ``test_torch_recurrent_sim.py``'s run and bounds,
at delay 0 and 1.
"""

import pytest

pytest.importorskip("torch")

from test_torch_recurrent_sim import (one_torch_thread,  # noqa: E402,F401
                                      simulated_run_vs_reference)


@pytest.mark.parametrize("delay", [0, 1])
def test_xlstm_simulated_run_matches_reference(delay):
    simulated_run_vs_reference("xlstm-1.3b", delay)
