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
- the Trainer's checkpoints are the reference Trainer's: one ``step_*``
  directory of the whole world, its (G,)-stacked ``TrainState`` and its
  ``OuterState`` (residual rows stacked by group). The reference
  ``CheckpointManager`` restores one that the port's ranks saved into
  templates from the reference's own state constructors, its
  ``CheckpointPoller`` serves group 1 of it, and a checkpoint that the
  reference manager wrote restores into the port's ranks, each its row;
- the measured controller's warmup windows: in the same world, while the
  controller measures, an accumulate window holds exactly one world
  all-reduce of the parameters' bytes (the reference's ``_global_pmean``),
  none otherwise, and the run's bits are those of the run without that
  exchange; a world of 1 rank samples the warmup windows
  (``tests/test_event_engine.py:test_warmup_windows_feed_measured_controller``).
"""

import os
import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.core.outer import outer_init as jax_outer_init  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.parallel.steps import TrainState as JaxTrainState  # noqa: E402
from repro.serve.handoff import CheckpointPoller as JaxPoller  # noqa: E402
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


def _reference_state(tree, seed=11, G=2):
    """A (G,)-stacked ``TrainState`` and its ``OuterState`` (int8-wire's
    residual rows) built by the reference's own constructors over ``tree``,
    every leaf then filled with numbers from ``seed`` (each group's rows
    different)."""
    rng = np.random.default_rng(seed)
    jtc = jax_config.TrainConfig(**TC_KW, outer_comm=jax_config.OuterCommConfig(
        compression="int8-wire"))
    params = jax.tree.map(jnp.asarray, tree)
    stack = lambda t: jax.tree.map(lambda x: jnp.zeros((G, *x.shape), x.dtype), t)  # noqa: E731
    state = JaxTrainState(params=stack(params), opt=JaxAdamWState(
        count=jnp.zeros((G,), jnp.int32), mu=stack(params), nu=stack(params)))
    outer = jax_outer_init(params, jtc, num_groups=G, needs_residual=True)
    fill = lambda x: (jnp.asarray(rng.integers(1, 9, x.shape), x.dtype)  # noqa: E731
                      if x.dtype == jnp.int32
                      else jnp.asarray(rng.standard_normal(x.shape), x.dtype))
    return jax.tree.map(fill, state), jax.tree.map(fill, outer)


def _world(info, jobs, probes):
    """The module's world: each job through ``train_job`` (through
    :func:`_snapshot_job` where it says ``snapshot``), then each
    warmup-window probe."""
    outs = [(_snapshot_job if k.pop("snapshot", False) else LT.train_job)(info, *a, **k)
            for a, k in jobs]
    return outs, [_warmup_probe(info, *p) for p in probes]


def _snapshot_job(info, *args, **kw):
    """``train_job`` that also returns the rank's AdamW state, momentum and
    anchor as ``Trainer.save`` wrote them or as ``Trainer.restore`` left
    them: the rest of what a checkpoint holds beside ``keep_params``'s."""
    snap = {}
    real_save, real_restore = LT.Trainer.save, LT.Trainer.restore

    def take(trainer):
        st, o = trainer.state, trainer.outer
        snap.update(opt={"count": st.opt.count.clone(),
                         "mu": [t.cpu().clone() for t in st.opt.mu],
                         "nu": [t.cpu().clone() for t in st.opt.nu]},
                    momentum=[t.cpu().clone() for t in o.momentum],
                    anchor=[t.cpu().clone() for t in o.anchor])

    def save(self):
        real_save(self)
        take(self)

    def restore(self, *a, **k):
        real_restore(self, *a, **k)
        take(self)

    LT.Trainer.save, LT.Trainer.restore = save, restore
    try:
        out = LT.train_job(info, *args, **kw)
    finally:
        LT.Trainer.save, LT.Trainer.restore = real_save, real_restore
    return {**out, **snap}


def _warmup_probe(info, tc, stub: bool):
    """A 16-step run of ``tc`` on this rank, recording the all-reduces made
    inside each warmup accumulate window and whether the controller was
    measuring there; ``stub`` drops the measured window's exchange (the
    Trainer before it had one)."""
    calls, windows = [], []
    real_all_reduce, real_acc = dist.all_reduce, LT.Trainer._dispatch_accumulate
    real_exchange = LT.Trainer._warmup_exchange

    def all_reduce(t, *a, **k):
        calls.append((t.numel() * t.element_size(), k.get("group")))
        return real_all_reduce(t, *a, **k)

    def accumulate(self, ev):
        n, measuring = len(calls), self._measuring()
        real_acc(self, ev)
        windows.append((measuring, calls[n:]))

    ctrl = None
    if tc.sync_delay == "auto":
        ctrl = PS.DelayDecisionAdapter(PS.MeasuredDelayController(
            tc, min_windows=2, max_windows=3, skip_windows=1))
    dist.all_reduce, LT.Trainer._dispatch_accumulate = all_reduce, accumulate
    if stub:
        LT.Trainer._warmup_exchange = lambda self: None
    try:
        out = LT.train_job(info, PMC, tc, PC2, 16, params=_params().state_dict(),
                           batches=_batches(16), keep_params=True, sync_controller=ctrl)
    finally:
        dist.all_reduce, LT.Trainer._dispatch_accumulate = real_all_reduce, real_acc
        LT.Trainer._warmup_exchange = real_exchange
    out["windows"] = windows
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    ck, ck_off, ck_donor, ck_x, ck_ref = (str(tmp / d) for d in
                                         ("ck", "ck_off", "ck_donor", "ck_x", "ck_ref"))
    base = {k: v.detach().clone() for k, v in _params().state_dict().items()}
    batches = _batches()
    wire = _tc(comm={"compression": "int8-wire"})
    churn_tc = _tc(comm={"compression": "int8-wire"}, sync_delay=1, warmup_frac=0.0,
                   membership=pt_config.MembershipConfig())
    donor_tc = _tc(membership=pt_config.MembershipConfig(rejoin_bootstrap="checkpoint"))
    ref_state, ref_outer = _reference_state(_tree(_params()))
    JaxManager(ck_ref).save(6, {"state": ref_state, "outer": ref_outer},
                            metadata={"step": 6, "optimizer": "pier"})
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
        ((PMC, wire, PC2, 6), {**kw, "checkpoint_dir": ck_x, "save": True,
                               "snapshot": True}),  # 9: for the reference to read
        ((PMC, wire, PC2, 0), {**kw, "checkpoint_dir": ck_ref, "restore": True,
                               "snapshot": True}),  # 10: the reference's checkpoint
    ]
    auto = _tc(total_steps=24, warmup_frac=0.5, sync_delay="auto")
    probes = [(auto, False), (auto, True), (auto.replace(sync_delay=1), False)]
    outs = LT.spawn(_world, (jobs, probes), nproc=2, device="cpu",
                    timeout=30 + 15 * (len(jobs) + len(probes)), workdir=str(tmp))
    return {"outs": [o[0] for o in outs], "probes": [o[1] for o in outs], "base": base,
            "batches": batches, "ck_donor": ck_donor, "ck_x": ck_x,
            "ref": (ref_state, ref_outer)}


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
    mgr = CheckpointManager(world["ck_donor"])
    assert mgr.latest_step() == 6
    with np.load(os.path.join(mgr._path(6), "outer.npz")) as data:
        saved = [torch.from_numpy(data["anchor/" + n]) for n in names]
    g0, g1 = world["outs"][0][8], world["outs"][1][8]
    assert g1["final_step"] == 8 and _same(g1["params"], saved)
    assert not _same(g0["params"], saved)


def _np(x):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(x)]


def _rows_equal(stacked, per_rank):
    """Row g of every stacked leaf is rank g's tensor, bit for bit."""
    return all(np.array_equal(a[g], t.numpy()) for g, tensors in enumerate(per_rank)
               for a, t in zip(stacked, tensors))


def test_trainer_checkpoint_is_the_reference_layout(world):
    """One ``step_*`` directory for the world (no directory per rank): the
    reference's ``state`` and ``outer`` archives, the port's own state in a
    third, and the reference's metadata keys."""
    mgr = CheckpointManager(world["ck_x"])
    assert os.listdir(world["ck_x"]) == ["step_00000006"]
    manifest = mgr.manifest(6)
    assert manifest["metadata"] == {"step": 6, "optimizer": "pier"}
    assert sorted(manifest["trees"]) == ["outer", "state", "trainer"]
    with zipfile.ZipFile(os.path.join(mgr._path(6), "state.npz")) as z:
        assert all(i.compress_type == zipfile.ZIP_STORED for i in z.infolist())
    with np.load(os.path.join(mgr._path(6), "trainer.npz")) as data:
        assert str(data["strategy"]) == "int8-wire(block=256)"


def test_reference_manager_restores_the_trainers_checkpoint(world):
    """Job 9's checkpoint (2 ranks, int8-wire, step 6) through the
    reference's ``CheckpointManager.restore`` into templates from the
    reference's own constructors (``TrainState`` over a group-stacked
    params tree, ``outer_init`` with the residual): every leaf is the port
    ranks' tensors bit for bit, each group's row of the stacked ones; the
    reference's CRC sweep passes the port's extra archive."""
    outs = [world["outs"][r][9] for r in range(2)]
    state, outer = _reference_state(_tree(_params()), seed=0)
    mgr = JaxManager(world["ck_x"])
    assert mgr.latest_step() == 6
    trees, meta = mgr.restore(6, {"state": state, "outer": outer})
    assert meta == {"step": 6, "optimizer": "pier"}
    st, ot = trees["state"], trees["outer"]
    assert _rows_equal(_np(st.params), [o["params"] for o in outs])
    assert _rows_equal(_np(st.opt.mu), [o["opt"]["mu"] for o in outs])
    assert _rows_equal(_np(st.opt.nu), [o["opt"]["nu"] for o in outs])
    assert _rows_equal([np.asarray(st.opt.count)], [[o["opt"]["count"]] for o in outs])
    assert _rows_equal(_np(ot.residual), [o["residual"] for o in outs])
    for o in outs:
        assert all(np.array_equal(a, t.numpy()) for a, t in zip(_np(ot.momentum), o["momentum"]))
        assert all(np.array_equal(a, t.numpy()) for a, t in zip(_np(ot.anchor), o["anchor"]))
        assert int(ot.num_syncs) == o["num_syncs"]
    assert any(float(x.abs().max()) > 0 for x in outs[1]["residual"])


def test_reference_poller_serves_group_1_of_the_trainers_checkpoint(world):
    template = jax.tree.map(jnp.asarray, _tree(_params()))
    step, params = JaxPoller(world["ck_x"], template, group=1).poll()
    assert step == 6
    assert all(np.array_equal(a, t.numpy())
               for a, t in zip(_np(params), world["outs"][1][9]["params"]))


def test_reference_checkpoint_restores_into_the_trainers_ranks(world):
    """A checkpoint that the reference manager wrote from a (G,)-stacked
    state (every leaf different, each group's rows different) restores
    into the port's Trainer: each rank gets its group's row of every
    stacked leaf, and the momentum, anchor, sync count and step."""
    ref_state, ref_outer = world["ref"]
    outs = [world["outs"][r][10] for r in range(2)]
    assert _rows_equal(_np(ref_state.params), [o["params"] for o in outs])
    assert _rows_equal(_np(ref_state.opt.mu), [o["opt"]["mu"] for o in outs])
    assert _rows_equal(_np(ref_state.opt.nu), [o["opt"]["nu"] for o in outs])
    assert _rows_equal([np.asarray(ref_state.opt.count)], [[o["opt"]["count"]] for o in outs])
    assert _rows_equal(_np(ref_outer.residual), [o["residual"] for o in outs])
    for o in outs:
        assert o["final_step"] == 6 and o["num_syncs"] == int(ref_outer.num_syncs)
        assert all(np.array_equal(a, t.numpy()) for a, t in zip(_np(ref_outer.momentum),
                                                                 o["momentum"]))
        assert all(np.array_equal(a, t.numpy()) for a, t in zip(_np(ref_outer.anchor),
                                                                 o["anchor"]))


def test_measured_warmup_windows_hold_one_world_exchange(world):
    """``sync_delay="auto"`` (interval 2, so d* is 1 whatever the timings):
    while the controller measures (3 of the 6 warmup accumulates), each
    accumulate window holds exactly one all-reduce, over the world, of the
    parameters' fp32 bytes: the traffic of the reference's
    ``_global_pmean``, timed with the window. Unmeasured windows, and a
    fixed delay, make no collective call. The exchange's result is dropped:
    the run's losses and parameters are those of the same run without it,
    bit for bit."""
    nbytes = 4 * sum(t.numel() for _, t in param_leaves(_params()))
    for r in range(2):
        auto, stub, fixed = world["probes"][r]
        assert len(auto["windows"]) == len(fixed["windows"]) == 6
        assert [m for m, _ in auto["windows"]] == [True] * 3 + [False] * 3
        assert [c for _, c in auto["windows"]] == [[(nbytes, None)]] * 3 + [[]] * 3
        assert [c for _, c in stub["windows"]] == [[]] * 6
        assert fixed["windows"] == [(False, [])] * 6
        assert auto["sync_delay"] == stub["sync_delay"] == 1
        assert auto["decisions"] == stub["decisions"]
        assert [h["loss"] for h in auto["history"]] == [h["loss"] for h in stub["history"]]
        assert _same(auto["params"], stub["params"])


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
