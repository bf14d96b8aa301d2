"""DeepSeek-V2-236B's reduced config (MLA + MoE) through the port's
``SimulatedRun`` with every outer strategy it runs, on the CPU: flat at
delay 1, quantize at int8 and int4, int8-wire at delay 1, rs-ag,
Hierarchical over 4 groups in 2 pods, Chunked. Each strategy's numbers
are held against the reference on dense models (``test_torch_compress.py``)
and the flat and int8-wire ones on this model against the reference
simulator and the Trainer (``test_torch_moe_sim.py``,
``test_torch_trainer.py``); here the MoE and MLA leaves (the experts'
(E, D, F) tensors, the router, the latent norms) go through each one's
plan, reduce and apply.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's tests, the count restored after:
    this model's operations are too small to share (a run took 8 s on 8
    threads and 1 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# every outer strategy the simulator runs: (OuterCommConfig kwargs, groups,
# pods, sync_delay)
OUTER_CASES = [
    pytest.param({}, 2, 1, 1, id="flat-d1"),
    pytest.param({"compression": "quantize"}, 2, 1, 0, id="quantize-int8"),
    pytest.param({"compression": "quantize", "bits": 4, "block": 64}, 2, 1, 0,
                 id="quantize-int4"),
    pytest.param({"compression": "int8-wire"}, 2, 1, 1, id="int8-wire-d1"),
    pytest.param({"compression": "rs-ag"}, 2, 1, 0, id="rs-ag"),
    pytest.param({"compression": "int8-wire", "hierarchical": True}, 4, 2, 0,
                 id="hierarchical-g4-p2"),
    pytest.param({"compression": "quantize", "chunks": 2}, 2, 1, 0, id="chunked2"),
]


@pytest.mark.parametrize("comm,G,P,delay", OUTER_CASES)
def test_simulated_run_takes_every_outer_strategy(comm, G, P, delay):
    """DeepSeek-V2 reduced (MLA + MoE) through ``SimulatedRun`` with each
    outer strategy: lazy start, the switch to G groups and three outer
    syncs, finite losses, every leaf moved, and every group's parameters
    the anchor's after the last apply at delay 0."""
    cfg = pt_configs.get_reduced_config("deepseek-v2-236b").replace(
        dtype="float32", param_dtype="float32")
    tc = pt_config.TrainConfig(total_steps=20, global_batch_size=2 * G, seq_len=8,
                               sync_interval=2, warmup_frac=0.1, sync_delay=delay,
                               outer_comm=pt_config.OuterCommConfig(**comm))
    run = SimulatedRun(cfg, tc, num_groups=G, num_pods=P, device="cpu", seed=4)
    before = [t.detach().clone() for _, t in param_leaves(run.state.params)]
    hist = run.run(8)
    run.flush()
    assert np.isfinite(hist["train_loss"]).all() and len(hist["train_loss"]) == 8
    assert run.state.outer.num_syncs >= 3 and run.state.group_params is not None
    after = param_leaves(run.eval_params())
    moved = [float((t.detach() - b).abs().max()) for (_, t), b in zip(after, before)]
    assert min(moved) > 0  # every leaf trained, the experts' and the router's too
    if delay == 0:  # the last sync's apply left every group on the anchor
        for g in run.state.group_params:
            for t, a in zip([t for _, t in param_leaves(g)], run.state.outer.anchor):
                assert torch.equal(t.detach().float(), a.float())
