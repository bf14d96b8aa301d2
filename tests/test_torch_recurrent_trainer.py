"""The port's multi-process Trainer on the recurrent families, against the
port's simulator, on the CPU.

One spawned world of 2 CPU ranks (the port's launcher with gloo and a
``FileStore`` under the test's ``tmp_path``, as ``test_torch_trainer.py``
spawns them; deadline 30 s plus 15 s a job) runs three jobs one after
another: xLSTM-1.3B's reduced config (an mLSTM and an sLSTM layer) with
the int8 wire at delay 1 and with rs-ag at delay 0, and RecurrentGemma-9B's
(RG-LRU and local attention) with the int8 wire at delay 0; fp32, inner
steps from the start and four outer syncs in 8 steps, numpy batches from a
seed fed to every side. Each equals the port's ``SimulatedRun`` on the
same parameters and batches bit for bit: every loss, every final
parameter of both groups and both error-feedback residuals (the
exchange reduces in canonical source order, as the simulator's stacked
model does). The simulator runs here with the ranks' thread count.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from test_torch_trainer import (STEPS, _base_params, _group_params, _pc,  # noqa: E402
                                _sim, _spawn, _state_dict, _tc, _torch_batches)

# (name, arch, OuterCommConfig kwargs, sync_delay)
JOBS = [("xlstm-int8-wire-d1", "xlstm-1.3b", {"compression": "int8-wire"}, 1),
        ("xlstm-rs-ag-d0", "xlstm-1.3b", {"compression": "rs-ag"}, 0),
        ("recurrentgemma-int8-wire-d0", "recurrentgemma-9b", {"compression": "int8-wire"}, 0)]


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")
    return jcfg, pt_config.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(3)
    nb = [rng.integers(0, 512, (4, 17)).astype(np.int32) for _ in range(STEPS)]
    batches = _torch_batches(nb)
    bases, jobs = {}, []
    for _, arch, comm, d in JOBS:
        if arch not in bases:
            jcfg, pcfg = _cfgs(arch)
            assert pcfg.vocab_size == 512
            # jitted: the eager init's bits without its per-operation compiles
            bases[arch] = _base_params(jcfg, pcfg, jax.jit(JR.init_params, static_argnums=1))
        jobs.append(((_cfgs(arch)[1], _tc(comm, sync_delay=d, warmup_frac=0.0), _pc(2, 2),
                      STEPS),
                     dict(params=_state_dict(bases[arch]), batches=batches, keep_params=True)))
    got = _spawn(jobs, 2, tmp_path_factory.mktemp("recurrent_world2"))
    return batches, bases, got


@pytest.mark.parametrize("i", range(len(JOBS)), ids=[j[0] for j in JOBS])
def test_recurrent_trainer_equals_simulator_bit_for_bit(world, i):
    batches, bases, got = world
    _, arch, comm, d = JOBS[i]
    run, hist = _sim(_tc(comm, sync_delay=d, warmup_frac=0.0), 2, batches, bases[arch],
                     mc=_cfgs(arch)[1])
    ranks = [r[i] for r in got]
    assert [h["loss"] for h in ranks[0]["history"]] == hist["train_loss"]
    for g, r in enumerate(ranks):
        assert r["num_syncs"] == 4
        for a, b in zip(r["params"], _group_params(run, g), strict=True):
            assert torch.equal(a, b)
        for name in ("residual", "residual2"):
            sim_res = getattr(run.state.outer, name)
            if sim_res is None:
                assert r[name] is None
                continue
            for a, b in zip(r[name], sim_res):
                assert torch.equal(a, b[g])
    names = [n for n, _ in param_leaves(run.state.group_params[0])]
    want = ("layers.1.mix.r_i", "layers.0.mix.w_igate") if arch.startswith("xlstm") else (
        "layers.0.mix.lambda", "layers.2.mix.wq")
    assert set(want) <= set(names)
