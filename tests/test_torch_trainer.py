"""The port's multi-process Trainer against the reference and against the
port's simulator, on the CPU.

Ranks are spawned through the port's launcher (``repro_torch.launch.train.
spawn``) with gloo and a ``FileStore`` under the test's ``tmp_path``, never a
fixed TCP port; each world runs several training jobs one after another
(``train_jobs``), so the file spawns three worlds, each with a deadline of
30 s plus 15 s a job (past it every rank is killed and the test fails;
a job takes about a second here when the machine is idle). Every run uses the reduced GPT-2 shape (2 layers,
d_model 256) in fp32 with numpy batches made from a seed, fed to every
side. On the CPU the wire exchange is its plain version (gloo all-gather),
the quantize, dequantize and pier-update wrappers their plain versions.

The simulator runs in this process with the ranks' thread count
(``launch.train.CPU_THREADS``): CPU matmuls sum in an order that depends
on it.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.models import registry as JR  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, global_batch_fn, rank_rows  # noqa: E402
from repro_torch.kernels.symm import Exchange  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.sync import Chunked, FlatFP32  # noqa: E402
from repro_torch.sync.base import ReduceCtx  # noqa: E402

# the reduced GPT-2 shape: 2 layers, d_model 256 (gpt2-medium's reduced config
# with a 64-token position table), fp32
MC_KW = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
             vocab_size=512, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
JMC = jax_config.ModelConfig(**MC_KW)
PMC = pt_config.ModelConfig(**MC_KW)
TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             inner_lr=4e-4, inner_min_lr=4e-5)
STEPS = 8
EPS = np.finfo(np.float32).eps


def _np_batches(n=STEPS, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC_KW["vocab_size"], (B, S + 1)).astype(np.int32)
            for _ in range(n)]


def _torch_batches(nb):
    return [{"tokens": torch.from_numpy(b[:, :-1].copy()),
             "labels": torch.from_numpy(b[:, 1:].copy())} for b in nb]


def _tc(comm=None, **kw):
    return pt_config.TrainConfig(**{**TC_KW, **kw},
                                 outer_comm=pt_config.OuterCommConfig(**(comm or {})))


def _pc(ranks, groups, pods=1):
    return pt_config.ParallelConfig(data_axis_size=ranks // pods, data_outer=groups // pods,
                                    num_pods=pods)


def _base_params():
    """The reference's initial parameters for seed 0 (those its simulator
    starts from), in the port's training storage."""
    tree = jax.tree.map(np.asarray, JR.init_params(jax.random.PRNGKey(0), JMC))
    return params_from_jax(tree, PMC, device="cpu", training=True)


def _state_dict(params):
    return {k: v.detach().clone() for k, v in params.state_dict().items()}


def _spawn(jobs, nproc, tmp_path):
    return LT.spawn(LT.train_jobs, (jobs,), nproc=nproc, device="cpu",
                    timeout=30 + 15 * len(jobs), workdir=str(tmp_path))


def _sim(tc, G, batches, base, *, P=1):
    """The port's simulator on the same params and batches, with the thread
    count of a rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(LT.CPU_THREADS)
    try:
        run = SimulatedRun(PMC, tc, num_groups=G, num_pods=P, device="cpu",
                           params=copy.deepcopy(base))
        run._global_batch = lambda s: batches[s]
        hist = run.run(STEPS)
        run.flush()
    finally:
        torch.set_num_threads(threads)
    return run, hist


def _group_params(run, g):
    return [t.detach() for _, t in param_leaves(run.state.group_params[g])]


def _max_diff(xs, ys):
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(xs, ys))


def _ulps(xs, ys):
    """Largest difference in units of the larger magnitude's fp32 spacing."""
    worst = 0.0
    for a, b in zip(xs, ys):
        a, b = a.double(), b.double()
        scale = torch.maximum(a.abs(), b.abs()).clamp_min(np.finfo(np.float32).tiny) * EPS
        worst = max(worst, float(((a - b).abs() / scale).max()))
    return worst


# ===========================================================================
# configuration copies, rows per rank, what raises (no spawn)
# ===========================================================================


def test_parallel_config_copy_matches_reference():
    """The copy has the reference's fields; three defaults differ so that the
    all-defaults config is one the port runs (model axis 1, no FSDP, no
    expert sharding: in-group sharding is ROADMAP queue 1, item 10); the
    properties agree on every layout the port runs."""
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.ParallelConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pt_config.ParallelConfig)}
    assert list(jf) == list(pf)
    differ = {k for k in jf if jf[k] != pf[k]}
    assert differ == {"model_axis_size", "fsdp", "shard_experts"}
    assert (pf["model_axis_size"], pf["fsdp"], pf["shard_experts"]) == (1, False, False)
    for kw in (dict(data_axis_size=1, data_outer=1), dict(data_axis_size=4, data_outer=2),
               dict(data_axis_size=2, data_outer=2, num_pods=2),
               dict(data_axis_size=8, data_outer=4, num_pods=2, num_microbatches=2)):
        full = dict(model_axis_size=1, fsdp=False, shard_experts=False, **kw)
        j, p = jax_config.ParallelConfig(**full), pt_config.ParallelConfig(**full)
        for prop in ("data_inner", "num_groups", "group_size", "num_devices"):
            assert getattr(j, prop) == getattr(p, prop), (kw, prop)


@pytest.mark.parametrize("kw", [dict(model_axis_size=2), dict(fsdp=True),
                                dict(shard_experts=True), dict(remat="full"),
                                dict(scan_layers=True), dict(context_parallel=True)])
def test_unported_parallel_layouts_raise(kw):
    with pytest.raises(NotImplementedError):
        pt_config.ParallelConfig(**kw)


def test_each_rank_keeps_the_simulators_rows():
    """World 4 as 2 groups x data_inner 2: group g's two ranks together read
    exactly the rows ``SimulatedRun`` gives its group g, in order, and the
    pipeline's global batch is the simulator's."""
    tc = _tc(global_batch_size=8)
    run = SimulatedRun(PMC, tc, num_groups=2, device="cpu")
    make = global_batch_fn(PMC, tc)
    for step in (0, 3):
        glob = make(step)
        sim_glob = run._global_batch(step)
        for k in glob:
            assert torch.equal(glob[k], sim_glob[k])
        groups = run._group_batches(step)
        for g in range(2):
            rows = [glob["tokens"][rank_rows(8, 2 * g + i, 4)] for i in range(2)]
            assert torch.equal(torch.cat(rows), groups[g]["tokens"])
    pipe = DataPipeline(make, rank=3, world=4, device="cpu")
    try:
        first = next(pipe)
    finally:
        pipe.close()
    assert torch.equal(first["labels"], make(0)["labels"][6:8])
    with pytest.raises(ValueError, match="split"):
        rank_rows(6, 0, 4)


def test_ranks_are_row_major_over_the_reference_axes():
    """Rank r of 2 pods x 2 groups x data_inner 2 sits at the reference's
    row-major linearisation of (pod, data_outer, data_inner); the group
    index (the canonical source order) is pod-major, and the exchange of
    data_inner index i lists the groups' ranks in that order."""
    pc = pt_config.ParallelConfig(data_axis_size=4, data_outer=2, num_pods=2)
    sizes = LM.layout_sizes(pc)
    assert sizes == {"pod": 2, "data_outer": 2, "data_inner": 2}
    coords = [LM.coords_of(r, sizes) for r in range(8)]
    assert [tuple(c.values()) for c in coords] == [
        (p, o, i) for p in range(2) for o in range(2) for i in range(2)]
    exchange_1 = [r for r in range(8) if coords[r]["data_inner"] == 1]
    assert exchange_1 == [1, 3, 5, 7]
    assert LM.backend_for(torch.device("cpu"), 8, 0) == "gloo"
    assert LM.backend_for(torch.device("cuda", 0), 2, 1) == "gloo"  # ranks share a card
    assert LM.backend_for(torch.device("cuda", 0), 4, 4) == "nccl"


@pytest.mark.parametrize("flags", [["--sync-delay", "auto"], ["--comm-chunks", "2"],
                                   ["--sharded-outer"], ["--offload"],
                                   ["--churn-script", "drop:1@3"],
                                   ["--checkpoint-dir", "ckpt"], ["--mesh", "2,1,2"]])
def test_unported_flags_raise(flags):
    """``--sync-delay auto``, ``--offload``, ``--churn-script`` and
    ``--checkpoint-dir`` are ported now and map onto the configuration;
    chunked and sharded outer syncs and a model axis still raise."""
    args = LT.build_parser().parse_args(["--reduced", "--arch", "gpt2-medium", *flags])
    if flags[0] in ("--comm-chunks", "--sharded-outer", "--mesh"):
        with pytest.raises(NotImplementedError):
            LT.configs_from_args(args)
        return
    _, tc, _ = LT.configs_from_args(args)
    assert tc.sync_delay == ("auto" if flags[0] == "--sync-delay" else 0)
    assert tc.offload_outer_state == (flags[0] == "--offload")
    assert (tc.membership is not None) == (flags[0] == "--churn-script")
    if flags[0] == "--churn-script":
        assert tc.membership == pt_config.MembershipConfig()
    if flags[0] == "--checkpoint-dir":
        assert args.checkpoint_dir == "ckpt"


def test_unported_trainer_paths_raise():
    """Chunked still raises in the Trainer; membership and weights are
    ported: a controller over the wrong group count is refused, and a
    ``ReduceCtx`` carries the weights."""
    tc = _tc({"compression": "quantize", "chunks": 2})
    with pytest.raises(NotImplementedError, match="Chunked"):
        LT.build_train_steps(PMC, tc, _pc(2, 2), mesh=None)
    with pytest.raises(NotImplementedError, match="Chunked"):
        Chunked(inner=FlatFP32()).reduce_leaves([], None, tc, None)
    from repro_torch.sync import MembershipController

    with pytest.raises(ValueError, match="tracks 3 groups"):
        LT.Trainer(PMC, _tc(), _pc(2, 2), None, membership=MembershipController(3))
    ctx = ReduceCtx(exchange=Exchange(None, [0], 0)).with_membership([1.0], 1.0)
    assert ctx.weights == [1.0] and ctx.weight == 1.0


def test_flags_map_onto_the_layout():
    args = LT.build_parser().parse_args(
        ["--reduced", "--arch", "gpt2-medium", "--mesh", "2,2,2,1", "--outer-compression",
         "int8-wire", "--hierarchical-reduce", "--sync-delay", "1", "--global-batch", "8"])
    mc, tc, pc = LT.configs_from_args(args)
    assert (pc.num_pods, pc.data_outer, pc.data_inner, pc.num_devices) == (2, 2, 2, 8)
    assert tc.sync_delay == 1 and tc.outer_comm.hierarchical
    assert mc.name == "gpt2-medium-reduced"


# ===========================================================================
# world 1: the reference Trainer on a 1 x 1 x 1 mesh
# ===========================================================================


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The reference Trainer's 8 steps (flat fp32 and quantized int8, the
    reference paths that run on jax 0.9.0) beside the port's Trainer in a
    one-rank world, from the same parameters and batches."""
    from repro.launch import mesh as M
    from repro.launch.train import Trainer as JaxTrainer

    nb = _np_batches()
    comms = [{}, {"compression": "quantize"}]
    ref, jobs = [], []
    for comm in comms:
        jtc = jax_config.TrainConfig(**TC_KW, warmup_frac=0.1,
                                     outer_comm=jax_config.OuterCommConfig(**comm))
        jpc = jax_config.ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
        mesh = M.small_mesh((1, 1, 1), ("data_outer", "data_inner", "model"))
        tr = JaxTrainer(JMC, jtc, jpc, mesh)
        tree = jax.tree.map(lambda x: np.asarray(x[0]), tr.state.params)
        losses = []
        for b in nb:
            batch = {"tokens": jnp.asarray(b[:, :-1]), "labels": jnp.asarray(b[:, 1:])}
            losses.append(tr.train_step(jax.device_put(batch,
                                                       tr.bundle.batch_sharding(batch)))["loss"])
        tr.flush()
        final = [np.asarray(x[0]) for x in jax.tree_util.tree_leaves(tr.state.params)]
        ref.append((losses, final))
        sd = _state_dict(params_from_jax(tree, PMC, device="cpu", training=True))
        jobs.append(((PMC, _tc(comm, warmup_frac=0.1), _pc(1, 1), STEPS),
                     dict(params=sd, batches=_torch_batches(nb), keep_params=True)))
    got = _spawn(jobs, 1, tmp_path_factory.mktemp("world1"))[0]
    return ref, got


@pytest.mark.parametrize("case", [0, 1], ids=["flat", "quantized"])
def test_world1_trainer_matches_reference_trainer(world1, case):
    """Warmup (4 steps, two accumulates), the switch and two outer syncs.
    Losses within 1e-5 and parameters within 5e-5 (measured 9.5e-7 and
    3.0e-5 in both): the same fp32 algorithm, with XLA's and torch's
    reduction orders and XLA's fused multiply-adds apart, which AdamW's
    normalized first steps amplify up to a fraction of the inner LR (Table
    I's 4e-4)."""
    ref, got = world1
    losses, final = ref[case]
    port = got[case]
    assert port["num_syncs"] == 4
    np.testing.assert_allclose([h["loss"] for h in port["history"]], losses, rtol=0,
                               atol=1e-5)
    assert _max_diff(port["params"], [torch.from_numpy(x) for x in final]) <= 5e-5


# ===========================================================================
# world 2: the Trainer against the port's SimulatedRun
# ===========================================================================

# (name, OuterCommConfig kwargs, sync_delay, warmup_frac)
WORLD2 = [(f"{name}-d{d}", comm, d, 0.0)
          for name, comm in (("int8-wire", {"compression": "int8-wire"}),
                             ("int4-wire", {"compression": "int8-wire", "bits": 4,
                                            "block": 64}),
                             ("rs-ag", {"compression": "rs-ag"}), ("flat", {}))
          for d in (0, 1)]
WORLD2 += [("warm-flat-d1", {}, 1, 0.1), ("warm-int8-wire-d1", {"compression": "int8-wire"}, 1, 0.1),
           ("warm-rs-ag-d0", {"compression": "rs-ag"}, 0, 0.1)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    nb = _np_batches()
    batches = _torch_batches(nb)
    base = _base_params()
    sd = _state_dict(base)
    jobs = [((PMC, _tc(comm, sync_delay=d, warmup_frac=wf), _pc(2, 2), STEPS),
             dict(params=sd, batches=batches, keep_params=True)) for _, comm, d, wf in WORLD2]
    got = _spawn(jobs, 2, tmp_path_factory.mktemp("world2"))
    return nb, batches, base, got


def _vs_sim(world2, i):
    nb, batches, base, got = world2
    _, comm, d, wf = WORLD2[i]
    tc = _tc(comm, sync_delay=d, warmup_frac=wf)
    run, hist = _sim(tc, 2, batches, base)
    loss = [h["loss"] for h in got[0][i]["history"]]
    return run, hist, loss, [r[i] for r in got]


@pytest.mark.parametrize("i", range(6), ids=[c[0] for c in WORLD2[:6]])
def test_world2_wire_trainer_equals_simulator_bit_for_bit(world2, i):
    """int8-wire, int4-wire (block 64) and rs-ag at delay 0 and 1, inner
    steps from the start (no lazy start) and four outer syncs: every loss,
    every final parameter of both groups and both residuals equal the
    simulator's bit for bit. The exchange reduces in canonical source order
    (``dequant_sum_sources``), as the simulator's stacked model does."""
    run, hist, loss, ranks = _vs_sim(world2, i)
    assert loss == hist["train_loss"]
    for g, r in enumerate(ranks):
        assert r["num_syncs"] == 4
        for a, b in zip(r["params"], _group_params(run, g)):
            assert torch.equal(a, b)
        for k, name in ((0, "residual"), (1, "residual2")):
            sim_res = getattr(run.state.outer, name)
            if sim_res is None:
                assert r[name] is None
                continue
            for a, b in zip(r[name], sim_res):
                assert torch.equal(a, b[g])
    assert any(float(x.abs().max()) > 0 for x in ranks[0]["residual"])


@pytest.mark.parametrize("i", [6, 7], ids=[c[0] for c in WORLD2[6:8]])
def test_world2_flat_trainer_matches_simulator(world2, i):
    """Flat fp32 at delay 0 and 1: the Trainer means Δθ = θ − anchor over
    the exchange (the reference's ``pmean`` of Δθ), the simulator means θ
    first and subtracts the anchor after (the reference simulator's order);
    the two differ in the last bits of Δθ: measured 4.8e-7 in the loss and
    7.2e-7 in the parameters; limits 1e-6 and 2e-6."""
    run, hist, loss, ranks = _vs_sim(world2, i)
    np.testing.assert_allclose(loss, hist["train_loss"], rtol=0, atol=1e-6)
    for g, r in enumerate(ranks):
        assert _max_diff(r["params"], _group_params(run, g)) <= 2e-6


@pytest.mark.parametrize("i", [8, 9, 10], ids=[c[0] for c in WORLD2[8:]])
def test_world2_trainer_with_warmup_matches_simulator(world2, i):
    """A schedule with lazy start (4 warmup steps, two accumulates) and two
    outer syncs. The warmup differs by construction: each group's gradient
    on its rows, meaned over the world, where the simulator takes one
    gradient over the global batch (the reference's two paths differ the
    same way). Measured: losses within 9.5e-7, parameters within 3.6e-6
    (flat), 4.5e-6 (int8-wire) and 1.1e-5 (rs-ag: a Δθ one ulp apart can
    round to the neighbouring int8 value). Limits: loss 2e-6, parameters
    5e-5."""
    run, hist, loss, ranks = _vs_sim(world2, i)
    np.testing.assert_allclose(loss, hist["train_loss"], rtol=0, atol=2e-6)
    for g, r in enumerate(ranks):
        assert r["num_syncs"] == 4
        assert _max_diff(r["params"], _group_params(run, g)) <= 5e-5


def test_world2_trainer_matches_reference_simulator(world2):
    """The warmup int8-wire run at delay 1 against the reference simulator on
    the same parameters and batches, within the limits that hold the port's
    simulator to it (loss 1e-5, parameters 5e-5; measured 9.5e-7 and 3.7e-5)."""
    nb, _, base, got = world2
    i = 9
    _, comm, d, wf = WORLD2[i]
    jtc = jax_config.TrainConfig(**TC_KW, sync_delay=d, warmup_frac=wf,
                                 outer_comm=jax_config.OuterCommConfig(**comm))
    jr = JaxRun(JMC, jtc, num_groups=2, seed=0)
    for (_, t), x in zip(param_leaves(base), jax.tree_util.tree_leaves(jr.state.params)):
        assert np.array_equal(t.detach().numpy(), np.asarray(x))  # the same start
    jr._global_batch = lambda s: {"tokens": jnp.asarray(nb[s][:, :-1]),
                                  "labels": jnp.asarray(nb[s][:, 1:])}
    jh = jr.run(STEPS)
    jr.flush()
    loss = [h["loss"] for h in got[0][i]["history"]]
    gp = jax.tree_util.tree_leaves(jr.state.group_params)
    np.testing.assert_allclose(loss, jh["train_loss"], rtol=0, atol=1e-5)
    for g in range(2):
        assert _max_diff(got[g][i]["params"],
                         [torch.from_numpy(np.asarray(x[g])) for x in gp]) <= 5e-5


# ===========================================================================
# world 4
# ===========================================================================

WORLD4 = [("g2-inner2-flat", {}, 4, 2, 1),
          ("g4-pods2-hier-int8-wire", {"compression": "int8-wire", "hierarchical": True},
           4, 4, 2)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    nb = _np_batches(B=8)
    batches = _torch_batches(nb)
    base = _base_params()
    sd = _state_dict(base)
    jobs = [((PMC, _tc(comm, warmup_frac=0.0, global_batch_size=8, sync_delay=1),
              _pc(ranks, G, P), STEPS), dict(params=sd, batches=batches, keep_params=True))
            for _, comm, ranks, G, P in WORLD4]
    got = _spawn(jobs, 4, tmp_path_factory.mktemp("world4"))
    return batches, base, got


def test_world4_data_inner_mean_of_means(world4):
    """2 groups of 2 ranks (data_inner 2), flat fp32, delay 1: each group's
    gradient is the mean of its two ranks' half-batch gradients, where the
    simulator takes one gradient over the group's rows. Losses within 1e-6
    of the simulator (measured 9.5e-7); parameters within 5e-6 (measured
    1.8e-6: AdamW's normalized step turns gradients 1e-7 apart into up to
    that in 8 steps at LR 4e-4); both ranks of a group hold the same bits."""
    batches, base, got = world4
    _, comm, _, G, P = WORLD4[0]
    tc = _tc(comm, warmup_frac=0.0, global_batch_size=8, sync_delay=1)
    run, hist = _sim(tc, G, batches, base)
    loss = [h["loss"] for h in got[0][0]["history"]]
    np.testing.assert_allclose(loss, hist["train_loss"], rtol=0, atol=1e-6)
    for r in range(4):
        g = r // 2
        assert got[r][0]["group"] == g
        assert _max_diff(got[r][0]["params"], _group_params(run, g)) <= 5e-6
        for a, b in zip(got[r][0]["params"], got[2 * g][0]["params"]):
            assert torch.equal(a, b)


def test_world4_hierarchical_over_pods(world4):
    """4 groups in 2 pods, Hierarchical over int8-wire, delay 1: stage 1
    the fp32 mean over the pod's 2 groups, stage 2 the ring over the pods.
    Parameters and residuals within 8 ulps of the simulator, as stated
    for a mean that may associate differently (with 2 groups a pod it does
    not: measured 0); the logged loss, a world mean of 4 terms, within 8 ulps
    relative (measured 4.8e-7 absolute)."""
    batches, base, got = world4
    _, comm, _, G, P = WORLD4[1]
    tc = _tc(comm, warmup_frac=0.0, global_batch_size=8, sync_delay=1)
    run, hist = _sim(tc, G, batches, base, P=P)
    loss = [h["loss"] for h in got[0][1]["history"]]
    np.testing.assert_allclose(loss, hist["train_loss"], rtol=8 * EPS, atol=0)
    for r in range(4):
        assert _ulps(got[r][1]["params"], _group_params(run, r)) <= 8
        for a, b in zip(got[r][1]["residual"], run.state.outer.residual):
            assert _ulps([a], [b[r]]) <= 8
