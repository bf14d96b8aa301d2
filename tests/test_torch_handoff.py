"""The train-to-serve handoff against the reference's, on the CPU.

``ServeEngine.set_params`` and ``serve/handoff.py:CheckpointPoller`` of the
port, held against the reference's on one swap schedule: both engines
serve the same requests from the same weights; after ``K`` decode steps a
newer checkpoint appears in the directory both pollers watch (written by
the reference's ``CheckpointManager``: a Trainer's (G,)-stacked ``state``,
the pollers serving group 1, or a plain ``params`` tree), and both engines
run on until they drain. They must swap at the same step, give the same
greedy tokens and logits within 1e-4 (fp32, reduced Granite-8B: GQA 4:1
and an untied ``lm_head``), and leave their pools empty. Also: what
``set_params`` and the poller refuse, and ``launch/serve.py --ckpt-dir``.
The reference's poller serving the port Trainer's checkpoint is in
tests/test_torch_checkpoint.py.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.config import ParallelConfig  # noqa: E402
from repro.launch import mesh as M  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.parallel.steps import TrainState as JaxTrainState  # noqa: E402
from repro.parallel.steps import build_paged_serve_steps as jax_build_steps  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.handoff import CheckpointPoller as JaxPoller  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves, with_leaves  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_steps  # noqa: E402
from repro_torch.serve import (CheckpointPoller, EngineConfig, PagedCacheConfig,  # noqa: E402
                               ServeEngine)

ARCH = "granite-8b"
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
K = 2  # decode steps before the newer checkpoint appears
STEP = 7


def _jcfg():
    return dataclasses.replace(jax_configs.get_reduced_config(ARCH), dtype="float32",
                               param_dtype="float32")


def _tree(jcfg, seed, gain=4.0):
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


def _write(directory, layout, tree, G=2, group=1):
    """The newer checkpoint, by the reference's manager: a Trainer's
    (G,)-stacked state whose row ``group`` is ``tree`` (the other rows
    other numbers), or a plain params tree."""
    params = jax.tree.map(jnp.asarray, tree)
    if layout == "params":
        JaxManager(directory).save(STEP, {"params": params})
        return
    stacked = jax.tree.map(lambda x: jnp.stack([x * (g - group + 1.5) if g != group else x
                                                for g in range(G)]), params)
    zeros = jax.tree.map(jnp.zeros_like, stacked)
    JaxManager(directory).save(STEP, {"state": JaxTrainState(params=stacked, opt=JaxAdamWState(
        count=jnp.zeros((G,), jnp.int32), mu=zeros, nu=zeros))},
        metadata={"step": STEP, "optimizer": "pier"})


def _recording(engine, log, to_np):
    """Wrap the engine's bundle so that every step's logits of live slots
    are kept (a prefill's one row, a decode step's live rows)."""
    b = engine.bundle

    def prefill(*args):
        logits, pools = b.prefill_step(*args)
        log.append(to_np(logits)[:1])
        return logits, pools

    def decode(*args):
        logits, pools = b.decode_step(*args)
        live = [i for i, s in enumerate(engine.slots) if s is not None]
        log.append(to_np(logits)[live])
        return logits, pools

    engine.bundle = dataclasses.replace(b, prefill_step=prefill, decode_step=decode)


@pytest.mark.parametrize("layout", ["state", "params"])
def test_swap_schedule_matches_the_reference(layout, tmp_path):
    jcfg = _jcfg()
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jcfg))
    old, new = _tree(jcfg, seed=1), _tree(jcfg, seed=2)
    ekw = dict(max_slots=3, max_new_tokens=6, max_blocks_per_seq=6)
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    jpcfg = JKC.PagedCacheConfig(num_blocks=20, block_size=4, dtype="float32")
    jparams = jax.tree.map(jnp.asarray, old)
    jeng = JServeEngine(jparams, jcfg, jax_build_steps(jcfg, pc, mesh, pcfg=jpcfg), jpcfg,
                        JEngineConfig(**ekw))
    pcfg = PagedCacheConfig(num_blocks=20, block_size=4, dtype="float32")
    params = params_from_jax(old, cfg, device="cpu")
    eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"),
                      pcfg, EngineConfig(**ekw))
    logs = ([], [])
    _recording(jeng, logs[0], np.asarray)
    _recording(eng, logs[1], lambda t: t.numpy())
    rng = np.random.default_rng(0)
    for n in (5, 7, 3, 8, 6, 4):
        p = rng.integers(0, cfg.vocab_size, size=n)
        jeng.submit(p, 6)
        eng.submit(p, 6)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    pollers = (JaxPoller(ck, jparams, group=1), CheckpointPoller(ck, params, group=1))
    swapped_at = ([], [])
    engines, alive = (jeng, eng), [True, True]
    while any(alive):  # both engines in lockstep: the checkpoint appears once, between steps
        if eng.stats["decode_steps"] == K and not os.listdir(ck):
            _write(ck, layout, new)
        for i, (e, pl) in enumerate(zip(engines, pollers)):
            if alive[i]:
                before = len(pl.swapped_steps)
                pl.on_step(e)
                if len(pl.swapped_steps) > before:
                    swapped_at[i].append(e.stats["decode_steps"])
        alive = [e.step() if a else False for e, a in zip(engines, alive)]
    assert pollers[0].swapped_steps == pollers[1].swapped_steps == [STEP]
    assert swapped_at[0] == swapped_at[1] == [K]
    want = [r.tokens for r in sorted(jeng.finished, key=lambda r: r.uid)]
    assert [r.tokens for r in sorted(eng.finished, key=lambda r: r.uid)] == want
    assert eng.stats == jeng.stats
    assert len(logs[0]) == len(logs[1])
    assert max(float(np.abs(a - b).max()) for a, b in zip(logs[0], logs[1])) <= 1e-4
    assert eng.alloc.num_free == jeng.alloc.num_free == pcfg.num_blocks - 1
    served = [t for _, t in param_leaves(eng.params)]
    assert all(torch.equal(a, b) for a, b in zip(
        served, [t for _, t in param_leaves(params_from_jax(new, cfg, device="cpu"))]))
    # the requests admitted after the swap ran on the new weights alone
    fresh = ServeEngine(params_from_jax(new, cfg, device="cpu"), cfg,
                        build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"), pcfg,
                        EngineConfig(**ekw))
    rng = np.random.default_rng(0)
    for n in (5, 7, 3, 8, 6, 4):
        fresh.submit(rng.integers(0, cfg.vocab_size, size=n), 6)
    fresh.run()
    # requests 4-6 take the slots of the first three when they finish (after
    # 5 decode steps), so after the swap
    by_uid = {r.uid: r.tokens for r in fresh.finished}
    late = [r for r in eng.finished if r.uid > ekw["max_slots"]]
    assert len(late) == 3 and all(by_uid[r.uid] == r.tokens for r in late)


def _cfg_params(seed=0, **kw):
    """Reduced Granite-8B in its own dtypes (bf16 compute: serving storage
    keeps the matmul weights in bf16)."""
    cfg = pt_config.ModelConfig(**dataclasses.asdict(
        jax_configs.get_reduced_config(ARCH))).replace(**kw)
    return cfg, PR.init_params(cfg, seed=seed, device="cpu")


def test_set_params_refuses_another_layout():
    """Another shape, the training storage's fp32 matmul weights, or another
    set of leaves (no ``lm_head``: a tied table) is refused; an accepted
    tree is served from the next step boundary on."""
    cfg, params = _cfg_params()
    pcfg = PagedCacheConfig(num_blocks=8, block_size=4)
    eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"), pcfg,
                      EngineConfig(max_slots=1, max_new_tokens=2))
    leaves = dict(param_leaves(params))
    tied = copy.deepcopy(params)
    del tied["embed"]["lm_head"]
    for other in (with_leaves(params, {**leaves, "layers.0.mlp.w_up": torch.zeros(3, 4)}),
                  with_leaves(params, {n: t.float() for n, t in leaves.items()}), tied):
        with pytest.raises(ValueError, match="do not match"):
            eng.set_params(other)
    fresh = with_leaves(params, {n: t.clone() for n, t in leaves.items()})
    eng.set_params(fresh)
    assert eng.params is params  # not before the next step boundary
    eng.submit(np.arange(5), 2)
    eng.run()
    assert eng.params is fresh


def test_poller_refuses_what_it_cannot_serve(tmp_path):
    """A checkpoint without the template's leaf, with another shape, with a
    group out of range, or with neither tree raises, as the reference's."""
    cfg, params = _cfg_params()
    small_cfg, small = _cfg_params(d_ff=64)
    cases = [("ck_shape", {"params": small}, 0, "shape"),
             ("ck_tree", {"outer": {"a": np.zeros(2)}}, 0, "neither"),
             ("ck_group", {"state": {"params": _stacked(params, 2)}}, 2, "row 2"),
             ("ck_missing", {"params": {"embed": {"tokens": np.zeros(3)}}}, 0, "missing")]
    for d, trees, group, match in cases:
        CheckpointManager(str(tmp_path / d)).save(1, trees)
        with pytest.raises(ValueError, match=match):
            CheckpointPoller(str(tmp_path / d), params, group=group).poll()


def _stacked(params, G):
    from repro_torch.checkpoint import Rows

    return {n.replace(".", "/"): Rows(G, t.shape, t.dtype, [t] * G)
            for n, t in param_leaves(params)}


def test_launcher_serves_from_a_checkpoint_dir(tmp_path, capsys):
    """``--ckpt-dir``: the newest complete checkpoint (a Trainer-layout
    ``state`` written by the port's manager) is swapped in at the first step
    boundary; group 0's parameters are then served."""
    jcfg = jax_configs.get_reduced_config(ARCH)
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jcfg))
    trained = PR.init_params(cfg, seed=9, device="cpu", training=True)
    CheckpointManager(str(tmp_path)).save(5, {"state": {"params": _stacked(trained, 2)}},
                                          metadata={"step": 5, "optimizer": "pier"})
    out, info = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                                   "--prompt-len", "5", "--tokens", "3",
                                   "--ckpt-dir", str(tmp_path)])
    assert out.shape == (2, 3) and info["poller"].swapped_steps == [5]
    served = dict(param_leaves(info["engine"].params))
    for n, t in param_leaves(trained):
        assert torch.equal(served[n], t.detach().to(served[n].dtype)), n
    assert "hot-swapped params at checkpoint steps [5]" in capsys.readouterr().out
