"""Checkpoints, and the Trainer's new paths, on the CPU.

- ``repro_torch.checkpoint.CheckpointManager`` reads what
  ``repro.checkpoint.CheckpointManager`` writes and the reverse (a params
  tree, the same values bit for bit; bf16 leaves the same bytes under the
  same dtype string), skips crash debris (a ``.tmp`` step, a missing
  manifest, a truncated archive) and keeps ``keep`` checkpoints;
- one spawned world of 2 CPU ranks (gloo, a ``FileStore`` under
  ``tmp_path``; deadline 30 s plus 15 s a job) runs the Trainer: saved
  after 6 steps, restored by fresh Trainers and run to step 10, it gives
  the bits of an uninterrupted run (with ``offload_outer_state``, which is
  a no-op on the CPU, too); with ``drop:1@1,rejoin:1@2`` (int8-wire,
  delay 1) and with a scripted flat -> int8-wire switch it equals the
  port's simulator bit for bit; a checkpoint-donor rejoin bootstraps from
  the saved step's anchor;
- a world of 1 rank: the measured controller samples the warmup windows
  (``tests/test_event_engine.py:test_warmup_windows_feed_measured_controller``).
  The port's accumulate exchanges nothing (the warmup's replicas are the
  same on every rank), so those windows time the local accumulate.
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch import sync as PS  # noqa: E402

MC_KW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
PMC = pt_config.ModelConfig(**MC_KW)


def _params(seed=0):
    return PR.init_params(PMC, seed=seed, device="cpu", training=True)


def _tree(params):
    """The port's parameters as the reference's nested pytree of numpy arrays."""
    tree = {}
    for name, t in param_leaves(params):
        node, keys = tree, name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.detach().numpy().copy()

    def lists(node):  # "layers" holds a list, as the reference's tree does
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node
    return lists(tree)


# ===========================================================================
# the format, both ways
# ===========================================================================


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params = _params(1)
    tree = _tree(params)
    JaxManager(str(tmp_path)).save(3, {"params": jax.tree.map(jnp.asarray, tree)},
                                   metadata={"step": 3})
    template = _params(2)
    trees, meta = CheckpointManager(str(tmp_path)).restore(3, {"params": template})
    assert meta == {"step": 3}
    got = trees["params"]
    assert list(got) == [n.replace(".", "/") for n, _ in param_leaves(template)]
    for (_, want), t in zip(param_leaves(params), got.values()):
        assert torch.equal(t, want.detach())


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = _params(3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"params": params}, metadata={"step": 4})
    template = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), _tree(_params(5)))
    trees, meta = JaxManager(str(tmp_path)).restore(4, {"params": template})
    assert meta == {"step": 4}
    want = [t.detach().numpy() for _, t in param_leaves(params)]
    for a, b in zip(jax.tree_util.tree_leaves(trees["params"]), want):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(os.path.join(mgr._path(4), "manifest.json")) as f:
        assert '"embed/tokens"' in f.read()  # under the reference's pytree path


def test_bf16_leaves_round_trip_with_the_references_bytes(tmp_path):
    """The reference stores a bf16 leaf as its raw two-byte values under the
    dtype string ``<V2``; the port writes the same header and bytes, and
    restores either into a bf16 template bit for bit."""
    x = (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7).to(torch.bfloat16)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    JaxManager(str(ref_dir)).save(1, {"t": {"w": jnp.asarray(x.float().numpy(),
                                                                jnp.bfloat16)}})
    CheckpointManager(str(port_dir)).save(1, {"t": {"w": x}})
    import zipfile

    raw = [zipfile.ZipFile(os.path.join(d, "step_00000001", "t.npz")).read("w.npy")
           for d in (ref_dir, port_dir)]
    assert raw[0] == raw[1] and b"'<V2'" in raw[1]
    for d in (ref_dir, port_dir):
        trees, _ = CheckpointManager(str(d)).restore(1, {"t": {"w": torch.zeros(3, 4,
                                                                               dtype=torch.bfloat16)}})
        assert torch.equal(trees["t"]["w"].view(torch.int16), x.view(torch.int16))
    with pytest.raises(ValueError, match="bf16"):
        CheckpointManager(str(port_dir)).restore(1, {"t": {"w": torch.zeros(3, 4)}})


def test_template_dtype_wins_and_shapes_are_checked(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"t": {"a": torch.arange(4, dtype=torch.float32), "n": 7}})
    trees, _ = mgr.restore(1, {"t": {"a": torch.zeros(4, dtype=torch.bfloat16), "n": 0}})
    assert trees["t"]["a"].dtype == torch.bfloat16 and trees["t"]["n"] == 7
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"t": {"a": torch.zeros(5), "n": 0}})


def test_crash_debris_is_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = {"p": {"a": torch.ones(3)}}
    mgr.save(1, tree)
    mgr.save(2, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))  # a crashed save
    os.remove(os.path.join(mgr._path(2), "manifest.json"))  # not complete
    mgr.save(3, tree)
    with open(os.path.join(mgr._path(3), "p.npz"), "r+b") as f:  # truncated
        f.truncate(40)
    fresh = CheckpointManager(str(tmp_path), keep=5)
    with pytest.warns(UserWarning, match="skipping corrupt"):
        assert fresh.latest_step() == 1
    assert fresh.all_steps() == [1]
    with pytest.raises(ValueError, match="incomplete"):
        fresh.restore(3, tree)
    # the reference agrees on what survives
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert JaxManager(str(tmp_path), keep=5).latest_step() == 1


def test_keep_garbage_collects_complete_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": {"a": torch.full((2,), float(s))}})
    assert mgr.all_steps() == [3, 4]
    trees, _ = mgr.restore(mgr.latest_step(), {"p": {"a": torch.zeros(2)}})
    assert torch.equal(trees["p"]["a"], torch.full((2,), 4.0))


# ===========================================================================
# the Trainer: save / restore / continue, churn, a scripted switch
# ===========================================================================

TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)
STEPS = 10


def _batches(n=STEPS):
    rng = np.random.default_rng(7)
    return [{"tokens": torch.from_numpy(b[:, :-1].copy()),
             "labels": torch.from_numpy(b[:, 1:].copy())}
            for b in (rng.integers(0, 128, (4, 17)).astype(np.int32) for _ in range(n))]


def _tc(**kw):
    comm = kw.pop("comm", {})
    return pt_config.TrainConfig(**{**TC_KW, **kw},
                                 outer_comm=pt_config.OuterCommConfig(**comm))


PC2 = pt_config.ParallelConfig(data_axis_size=2, data_outer=2)
CHURN = "drop:1@1,rejoin:1@2"
SWITCH = {2: PS.Int8Wire(8, 256)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    ck, ck_off, ck_donor = (str(tmp / d) for d in ("ck", "ck_off", "ck_donor"))
    base = {k: v.detach().clone() for k, v in _params().state_dict().items()}
    batches = _batches()
    wire = _tc(comm={"compression": "int8-wire"})
    churn_tc = _tc(comm={"compression": "int8-wire"}, sync_delay=1, warmup_frac=0.0,
                   membership=pt_config.MembershipConfig())
    donor_tc = _tc(membership=pt_config.MembershipConfig(rejoin_bootstrap="checkpoint"))
    kw = {"params": base, "batches": batches, "keep_params": True}
    jobs = [
        ((PMC, wire, PC2, STEPS), kw),  # 0: uninterrupted
        ((PMC, wire, PC2, 6), {**kw, "checkpoint_dir": ck, "save": True}),  # 1: save at 6
        ((PMC, wire, PC2, 4), {**kw, "checkpoint_dir": ck, "restore": True}),  # 2: go on
        ((PMC, wire.replace(offload_outer_state=True), PC2, 6),
         {**kw, "checkpoint_dir": ck_off, "save": True}),  # 3: offload, save at 6
        ((PMC, wire.replace(offload_outer_state=True), PC2, 4),
         {**kw, "checkpoint_dir": ck_off, "restore": True}),  # 4: go on
        ((PMC, churn_tc, PC2, STEPS), {**kw, "churn": CHURN}),  # 5: churn
        ((PMC, _tc(warmup_frac=0.0), PC2, STEPS),
         {**kw, "sync_controller": PS.ScriptedSyncController(0, SWITCH)}),  # 6: switch
        ((PMC, donor_tc, PC2, 6), {**kw, "checkpoint_dir": ck_donor, "save": True}),  # 7
        ((PMC, donor_tc, PC2, 2), {**kw, "checkpoint_dir": ck_donor, "restore": True,
                                   "churn": "drop:1@0,rejoin:1@2"}),  # 8: rejoin from it
    ]
    outs = LT.spawn(LT.train_jobs, (jobs,), nproc=2, device="cpu",
                    timeout=30 + 15 * len(jobs), workdir=str(tmp))
    return {"outs": outs, "base": base, "batches": batches, "ck_donor": ck_donor}


def _sim(tc, world, steps=STEPS, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(LT.CPU_THREADS)
    try:
        params = PR.init_params(PMC, seed=0, device="cpu", training=True)
        params.load_state_dict(world["base"])
        run = SimulatedRun(PMC, tc, num_groups=2, device="cpu", params=params, **kw)
        run._global_batch = lambda s: world["batches"][s]
        hist = run.run(steps)
        run.flush()
    finally:
        torch.set_num_threads(threads)
    return run, hist


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_trainer_save_restore_continue_is_bitwise(world):
    outs = world["outs"]
    for first, second in ((1, 2), (3, 4)):  # plain, and with offload_outer_state
        for r in range(2):
            full, rest = outs[r][0], outs[r][second]
            assert outs[r][first]["final_step"] == 6 and rest["final_step"] == STEPS
            assert _same(full["params"], rest["params"])
            assert _same(full["residual"], rest["residual"])
            assert full["num_syncs"] == rest["num_syncs"]
        want = [h["loss"] for h in outs[0][0]["history"]]
        got = [h["loss"] for h in outs[0][first]["history"] + outs[0][second]["history"]]
        assert got == want
        assert "save_s" in outs[0][first] and "restore_s" in outs[0][second]


def test_trainer_churn_equals_the_simulator(world):
    """int8-wire at delay 1, no lazy start (as the bitwise cases of
    tests/test_torch_trainer.py), group 1 absent at event 1 and bootstrapped
    after it: every loss and every rank's parameters bit for bit those of
    the port's simulator."""
    tc = _tc(comm={"compression": "int8-wire"}, sync_delay=1, warmup_frac=0.0,
             membership=pt_config.MembershipConfig())
    run, hist = _sim(tc, world, membership=PS.MembershipController(
        2, cfg=tc.membership, schedule=PS.ChurnSchedule.parse(CHURN)))
    assert run.membership.elastic
    for r in range(2):
        out = world["outs"][r][5]
        mine = [t.detach() for _, t in param_leaves(run.state.group_params[r])]
        assert _same(out["params"], mine)
    assert [h["loss"] for h in world["outs"][0][5]["history"]] == hist["train_loss"]


def test_trainer_scripted_switch_equals_the_simulator(world):
    """Flat fp32, then the int8 wire from window 2 (the residual appears on
    every rank, the wire's buffers are built at the switch). The flat
    windows mean Δθ in the Trainer and θ in the simulator, so they part in
    the last bits (tests/test_torch_trainer.py: 7.2e-7), which the int8
    windows may turn into a neighbouring int8 value: parameters and
    residuals within three quantization steps, 5e-5."""
    run, _ = _sim(_tc(warmup_frac=0.0), world,
                  sync_controller=PS.ScriptedSyncController(0, SWITCH))
    assert run.strategy.name == "int8-wire(block=256)"
    for r in range(2):
        out = world["outs"][r][6]
        assert out["strategy"] == run.strategy.name
        assert out["decisions"] == [(2, None, "int8-wire(block=256)")]
        mine = [t.detach() for _, t in param_leaves(run.state.group_params[r])]
        assert max(float((a - b).abs().max()) for a, b in zip(out["params"], mine)) <= 5e-5
        res = [x[r] for x in run.state.outer.residual]
        assert max(float((a - b).abs().max()) for a, b in zip(out["residual"], res)) <= 5e-5
        assert any(float(x.abs().max()) > 0 for x in out["residual"])


def test_trainer_checkpoint_donor_bootstraps_from_the_saved_anchor(world):
    """Job 7 saves step 6; job 8 restores it with group 1 absent and
    rejoining at event 2, so right after event 1's apply (step 7, the last
    of its two steps) group 1 bootstraps from the checkpoint: its
    parameters are the saved anchor bit for bit, while group 0 installed
    the new one."""
    names = [n.replace(".", "/") for n, _ in param_leaves(_params())]
    mgr = CheckpointManager(os.path.join(world["ck_donor"], "rank00001"))
    assert mgr.latest_step() == 6
    with np.load(os.path.join(mgr._path(6), "outer.npz")) as data:
        saved = [torch.from_numpy(data["anchor/" + n]) for n in names]
    g0, g1 = world["outs"][0][8], world["outs"][1][8]
    assert g1["final_step"] == 8 and _same(g1["params"], saved)
    assert not _same(g0["params"], saved)


@pytest.mark.parametrize("comm", [{}, {"compression": "int8-wire", "block": 64}])
def test_warmup_windows_feed_measured_controller(comm, tmp_path):
    """Warmup 12 of 24 steps, interval 4: the accumulate windows at steps
    3, 7, 11 are all sampled (``warmup=True``), so measurement completes
    inside the warmup; t_inner is measured between synchronizes."""
    tc = _tc(total_steps=24, sync_interval=4, warmup_frac=0.5, sync_delay=0, comm=comm)
    pc = pt_config.ParallelConfig(data_axis_size=1, data_outer=1)
    mdc = PS.MeasuredDelayController(tc, min_windows=2, max_windows=3, skip_windows=1)
    out = LT.spawn(LT.train_job, (PMC, tc, pc, 12),
                   {"sync_controller": PS.DelayDecisionAdapter(mdc)}, nproc=1, device="cpu",
                   timeout=60, workdir=str(tmp_path))[0]
    ctrl = out["controller"]
    assert ctrl["measured_windows"] == 3 and not ctrl["wants_measurement"]
    assert ctrl["t_comm_s"] is not None and ctrl["t_inner_s"] > 0
