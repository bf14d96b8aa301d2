"""The port's training path against the reference, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: AdamW, clipping
and the LR schedules, the MarkovLM tables, the loss and its gradient on
parameters carried over with ``params_from_jax(..., training=True)``, and
a 12-step multi-group ``SimulatedRun`` with the same batches fed to both
(``_global_batch`` overridden). Everything runs in fp32, where the port's
attention is the plain version of its flash kernel and its outer update
the plain version of the pier-update kernel.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.data.synthetic import MarkovLM as JaxMarkov  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim.clip import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim.schedules import lr_at as jax_lr_at  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.data.synthetic import MarkovLM, make_train_batch  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim.clip import clip_by_global_norm  # noqa: E402
from repro_torch.optim.schedules import lr_at  # noqa: E402
from repro_torch.sync import OuterSyncStrategy  # noqa: E402

# the reduced GPT-2 shape of tests/test_simulate.py, tied embeddings
MC_KW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
JMC = jax_config.ModelConfig(**MC_KW)
PMC = pt_config.ModelConfig(**MC_KW)


def _jax_tree(seed=0, cfg=JMC):
    params = JR.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


# ===========================================================================
# parameters in training storage
# ===========================================================================


def test_param_leaves_follow_the_reference_leaf_order():
    _, tree = _jax_tree()
    params = params_from_jax(tree, PMC, device="cpu", training=True)
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    leaves = param_leaves(params)
    assert [n.replace(".", "/") for n, _ in leaves] == jpaths
    for (_, t), x in zip(leaves, _leaves_np(tree)):
        np.testing.assert_array_equal(t.detach().numpy(), x)


def test_training_storage_keeps_fp32_leaves_and_casts_at_use():
    jcfg = dataclasses.replace(JMC, dtype="bfloat16")
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jcfg))
    _, tree = _jax_tree(1, jcfg)
    train = params_from_jax(tree, cfg, device="cpu", training=True)
    serve = params_from_jax(tree, cfg, device="cpu")
    for (name, t), (_, s) in zip(param_leaves(train), param_leaves(serve)):
        assert t.dtype == torch.float32 and t.requires_grad, name
        assert not s.requires_grad
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)).astype(np.int32))
    with torch.no_grad():
        a, _ = PR.forward(train, cfg, {"tokens": toks})
        b, _ = PR.forward(serve, cfg, {"tokens": toks})
    assert torch.equal(a, b)  # the cast at use gives the cast-once numbers
    fresh = PR.init_params(cfg, seed=0, device="cpu", training=True)
    assert all(t.dtype == torch.float32 and t.requires_grad for _, t in param_leaves(fresh))


# ===========================================================================
# loss and gradient
# ===========================================================================


def test_loss_fn_value_and_grads_match_reference():
    """fp32 loss within 2e-6 and every gradient leaf within 2e-6 of
    ``jax.value_and_grad(repro...loss_fn)``; label -1 positions masked."""
    jparams, tree = _jax_tree(2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (3, 17)).astype(np.int32)
    labels = rng.integers(0, 128, (3, 17)).astype(np.int32)
    labels[0, :5] = -1
    labels[2, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.value_and_grad(lambda p: JR.loss_fn(p, JMC, jb), has_aux=True)(jparams)
    params = params_from_jax(tree, PMC, device="cpu", training=True)
    loss, metrics = PR.loss_fn(params, PMC, {"tokens": torch.from_numpy(toks),
                                             "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 2e-6
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 3 * 17 - 8
    for (name, t), g in zip(param_leaves(params), _leaves_np(jg)):
        assert np.abs(t.grad.numpy() - g).max() <= 2e-6, name


# ===========================================================================
# inner optimizer: AdamW, clipping, schedules
# ===========================================================================


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(state_dtype):
    """Three steps on every leaf kind (decayed and not): parameters within
    2 ulp-scale (1e-7 absolute at |p| <= 0.1), moments within 1e-7 relative
    in fp32 (the bias corrections are fp32 ``pow``, which may differ by an
    ulp between XLA and torch) and within one bf16 rounding in bf16."""
    jparams, tree = _jax_tree(4)
    jtc = jax_config.TrainConfig(opt_state_dtype=state_dtype)
    tc = pt_config.TrainConfig(opt_state_dtype=state_dtype)
    params = params_from_jax(tree, PMC, device="cpu", training=True)
    leaves = param_leaves(params)
    jstate, state = JA.adamw_init(jparams, jtc), PA.adamw_init(leaves, tc)
    rng = np.random.default_rng(5)
    for step in range(3):
        grads = [(rng.standard_normal(x.shape) * 0.01).astype(np.float32)
                 for x in _leaves_np(tree)]
        jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams),
                                          [jnp.asarray(g) for g in grads])
        lr = jax_lr_at(jtc, jnp.asarray(step))
        jparams, jstate = JA.adamw_update(jg, jstate, jparams, jtc, lr)
        PA.adamw_update([torch.from_numpy(g) for g in grads], state, leaves, tc, lr_at(tc, step))
    assert int(state.count) == int(jstate.count) == 3 and state.count.dtype == torch.int32
    for (name, t), x in zip(leaves, _leaves_np(jparams)):
        assert np.abs(t.detach().numpy() - x).max() <= 1e-7, name
    tol = 1e-7 if state_dtype == "float32" else 2.0 ** -7
    for ms, js in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        for t, x in zip(ms, _leaves_np(js)):
            x = np.asarray(x, np.float32)
            assert str(t.dtype) == f"torch.{state_dtype}"
            assert np.all(np.abs(t.float().numpy() - x) <= tol * np.abs(x) + 1e-30)


def _adamw_out_of_place(grads, state, leaves, tc, lr):
    """The update as fresh fp32 tensors, stored at the end: the form
    ``adamw_update`` writes in place."""
    dev = state.count.device
    f32 = lambda x: torch.tensor(np.float32(x), device=dev)  # noqa: E731
    b1, b2 = f32(tc.adam_beta1), f32(tc.adam_beta2)
    omb1, omb2 = f32(1.0 - tc.adam_beta1), f32(1.0 - tc.adam_beta2)
    eps, wd, lr_t, one = f32(tc.adam_eps), f32(tc.weight_decay), f32(lr), f32(1.0)
    state.count.add_(1)
    cf = state.count.float()
    c1, c2 = one - torch.pow(b1, cf), one - torch.pow(b2, cf)
    for (name, p), g, m, v in zip(leaves, grads, state.mu, state.nu):
        gf = g.float()
        mf = b1 * m.float() + omb1 * gf
        vf = b2 * v.float() + omb2 * (gf * gf)
        m.copy_(mf)
        v.copy_(vf)
        step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if PA.decay_mask(name):
            step = step + wd * p.float()
        p.copy_(p.float() - lr_t * step)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_bit_for_bit_the_out_of_place_form(state_dtype):
    """The in-place update rounds every operation as the out-of-place form
    does: three steps give the same bits (no tolerance), fp32 and bf16
    moments alike."""
    _, tree = _jax_tree(4)
    tc = pt_config.TrainConfig(opt_state_dtype=state_dtype)
    sides = []
    for _ in range(2):
        leaves = param_leaves(params_from_jax(tree, PMC, device="cpu", training=True))
        sides.append((leaves, PA.adamw_init(leaves, tc)))
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for step in range(3):
            grads = [(rng.standard_normal(x.shape) * 0.01).astype(np.float32)
                     for x in _leaves_np(tree)]
            for (leaves, state), fn in zip(sides, (PA.adamw_update, _adamw_out_of_place)):
                fn([torch.from_numpy(g) for g in grads], state, leaves, tc, lr_at(tc, step))
    (la, sa), (lb, sb) = sides
    for (name, a), (_, b) in zip(la, lb):
        assert torch.equal(a, b), name
    for xs, ys in ((sa.mu, sb.mu), (sa.nu, sb.nu)):
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype == getattr(torch, state_dtype) and torch.equal(x, y)


def test_decay_mask_matches_reference():
    _, tree = _jax_tree()
    flags = []

    def record(path, x):
        flags.append(JA._decay_mask(path))
        return x

    jax.tree_util.tree_map_with_path(record, tree)
    params = params_from_jax(tree, PMC, device="cpu", training=True)
    assert [PA.decay_mask(n) for n, _ in param_leaves(params)] == flags
    assert not PA.decay_mask("embed.positions") and PA.decay_mask("embed.tokens")


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(6)
    grads = [(rng.standard_normal(s) * 0.3).astype(np.float32)
             for s in ((64, 32), (32,), (5, 7, 9))]
    jc, jn = jax_clip([jnp.asarray(g) for g in grads], max_norm)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    out, norm = clip_by_global_norm(tg, max_norm)
    assert out is tg
    assert abs(float(norm) - float(jn)) <= 2e-6 * float(jn)
    for t, x in zip(tg, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(x), rtol=4e-7, atol=0)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_matches_reference(schedule):
    """fp32 within one ulp of cos (``np.cos`` against XLA's), carried
    through the schedule: |Δ| <= 0.5 (peak - floor) eps + one ulp of the LR."""
    tc_kw = dict(lr_schedule=schedule, total_steps=200, lr_warmup_frac=0.05,
                 inner_lr=6e-4, inner_min_lr=6e-5)
    jtc, tc = jax_config.TrainConfig(**tc_kw), pt_config.TrainConfig(**tc_kw)
    for step in range(0, 201, 7):
        j = np.float32(jax_lr_at(jtc, jnp.asarray(step)))
        p = lr_at(tc, step)
        assert isinstance(p, np.float32)
        tol = 0.5 * (6e-4 - 6e-5) * np.finfo(np.float32).eps + np.spacing(j)
        assert abs(p - j) <= tol, (step, p, j)


# ===========================================================================
# data
# ===========================================================================


def test_markov_tables_bitwise_and_walks_follow_the_chain():
    for vocab, seed in ((128, 1234), (50, 7)):
        j, p = JaxMarkov(vocab, seed=seed), MarkovLM(vocab, seed=seed)
        np.testing.assert_array_equal(p.succ.numpy(), np.asarray(j._succ))
        np.testing.assert_array_equal(p.probs.numpy().view(np.uint32),
                                      np.asarray(j._probs).view(np.uint32))
        assert p.entropy == pytest.approx(j.entropy, rel=1e-6)
    lm = MarkovLM(64, seed=3)
    b = make_train_batch(lm, torch.Generator().manual_seed(0), 4, 33)
    assert b["tokens"].shape == (4, 33) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    succ = lm.succ.numpy()
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).numpy()
    for row in toks:
        assert all(row[t + 1] in succ[row[t]] for t in range(len(row) - 1))
    again = make_train_batch(lm, torch.Generator().manual_seed(0), 4, 33)
    assert torch.equal(again["tokens"], b["tokens"])


# ===========================================================================
# SimulatedRun against the reference simulator
# ===========================================================================

TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)


def _batches(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MC_KW["vocab_size"], (4, 17)).astype(np.int32)
            for _ in range(n)]


def _port_run(delay, batches, tree, **kw):
    tc = pt_config.TrainConfig(**TC_KW, sync_delay=delay)
    run = SimulatedRun(PMC, tc, num_groups=2, device="cpu",
                       params=params_from_jax(tree, PMC, device="cpu", training=True), **kw)
    run._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                   "labels": torch.from_numpy(batches[s][:, 1:])}
    return run


@pytest.mark.parametrize("delay", [0, 1])
def test_simulated_run_matches_reference(delay):
    """12 steps, G = 2: lazy start (steps 0-3), two warmup accumulates
    (steps 1, 3), the switch to groups (step 4) and four outer syncs (steps
    5, 7, 9, 11) at μ 0.99 / 0.95 / 0.9 from the decay table, eager or one
    step delayed. Every step's loss within 1e-5 and every leaf of the final
    ``eval_params`` within 1e-5: the same fp32 algorithm, with XLA's and
    torch's reduction orders (matmuls, norms, the gradient norm) and XLA's
    fused multiply-adds apart."""
    batches = _batches()
    jtc = jax_config.TrainConfig(**TC_KW, sync_delay=delay)
    jr = JaxRun(JMC, jtc, num_groups=2, seed=0)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr = _port_run(delay, batches, tree)
    jh, ph = jr.run(12), pr.run(12)
    jr.flush()
    pr.flush()
    assert ph["step"] == jh["step"] == list(range(12))
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=0, atol=1e-5)
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs) == 6
    for (name, t), x in zip(param_leaves(pr.eval_params()), _leaves_np(jr.eval_params())):
        assert np.abs(t.detach().numpy() - x).max() <= 1e-5, name
    for t, x in zip(pr.state.outer.momentum, _leaves_np(jr.state.outer.momentum)):
        assert np.abs(t.numpy() - x).max() <= 1e-5


def test_delayed_sync_differs_from_eager():
    """With a non-zero inner LR the in-flight drift is non-zero, so a delay
    of 1 must give other parameters than the eager sync: the snapshot the
    window keeps is a clone, not a view that the in-place inner steps move."""
    batches = _batches()
    _, tree = _jax_tree()
    eager, delayed = _port_run(0, batches, tree), _port_run(1, batches, tree)
    eager.run(8)
    delayed.run(6)  # the dispatch after step 5 is in flight until step 6
    _, op, target, snaps = delayed._inflight
    assert op == "outer"
    at_dispatch = [t.detach().clone() for _, t in param_leaves(delayed.state.group_params[0])]
    seen = {}
    apply = delayed._apply

    def spy(target, snapshots):
        live = [t for _, t in param_leaves(delayed.state.group_params[0])]
        seen["moved"] = any(not torch.equal(s, t) for s, t in zip(snapshots[0], live))
        seen["kept"] = all(torch.equal(s, t) for s, t in zip(snapshots[0], at_dispatch))
        return apply(target, snapshots)

    delayed._apply = spy
    delayed.run(2)  # step 6 trains the groups, then the apply lands
    assert seen == {"moved": True, "kept": True}
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        param_leaves(eager.eval_params()), param_leaves(delayed.eval_params())))
    assert diff > 1e-6


def test_groups_diverge_then_resync():
    batches = _batches()
    _, tree = _jax_tree()
    run = _port_run(0, batches, tree)
    run.run(5)  # step 4 is the first inner step; the sync is after step 5
    g0, g1 = (param_leaves(g)[0][1] for g in run.state.group_params)
    assert g0.data_ptr() != g1.data_ptr() and float((g0 - g1).abs().max()) > 0
    run.run(1)
    g0, g1 = (param_leaves(g)[0][1] for g in run.state.group_params)
    assert torch.equal(g0, g1)
    assert run.state.params is run.state.group_params[0]


@pytest.mark.parametrize("kw", [{"sync_controller": "scripted"}, {"membership": "controller"},
                                {"checkpoint_manager": "manager"},
                                {"strategy": OuterSyncStrategy()},
                                {"strategy": object()}])
def test_unported_constructor_arguments_raise(kw, tmp_path):
    """Controllers, membership and checkpoint managers are ported now (they
    construct and are kept); a strategy that is none of the ported classes
    still raises. Pods are ported (``num_pods=2`` runs, below)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sync import MembershipController, ScriptedSyncController

    made = {"scripted": ScriptedSyncController(0), "controller": MembershipController(2),
            "manager": CheckpointManager(str(tmp_path))}
    kw = {k: made.get(v, v) if isinstance(v, str) else v for k, v in kw.items()}
    tc = pt_config.TrainConfig(**TC_KW)
    if "strategy" in kw:
        with pytest.raises(NotImplementedError):
            SimulatedRun(PMC, tc, num_groups=2, device="cpu", **kw)
    else:
        run = SimulatedRun(PMC, tc, num_groups=2, device="cpu", **kw)
        (name, value), = kw.items()
        assert getattr(run, {"checkpoint_manager": "ckpt"}.get(name, name)) is value
    run = SimulatedRun(PMC, tc, num_groups=2, num_pods=2, device="cpu")
    assert run.P == 2 and run.state.outer.residual is None
    with pytest.raises(ValueError):
        SimulatedRun(PMC, tc, num_groups=2, num_pods=3, device="cpu")


def test_unported_train_configs_raise():
    """Sharded still raises; ``TrainConfig.membership`` is ported (full
    membership through the elastic path) and ``sync_delay="auto"`` must be
    resolved first, as in the reference."""
    with pytest.raises(NotImplementedError):
        SimulatedRun(PMC, pt_config.TrainConfig(**TC_KW, outer_comm=pt_config.OuterCommConfig(
            sharded=True)), num_groups=2, device="cpu")
    run = SimulatedRun(PMC, pt_config.TrainConfig(**TC_KW,
                                                  membership=pt_config.MembershipConfig()),
                       num_groups=2, device="cpu")
    assert run.membership.num_groups == 2 and not run.membership.elastic
    with pytest.raises(ValueError, match="auto"):
        SimulatedRun(PMC, pt_config.TrainConfig(**TC_KW, sync_delay="auto"), num_groups=2,
                     device="cpu")
    serve = PR.init_params(PMC, seed=0, device="cpu")  # not training storage
    with pytest.raises(ValueError):
        SimulatedRun(PMC, pt_config.TrainConfig(**TC_KW), num_groups=2, device="cpu",
                     params=serve)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        SimulatedRun(PMC, pt_config.TrainConfig(**TC_KW), num_groups=2)


def test_own_batches_and_loss_decreases():
    """The port's own MarkovLM batches: the loss falls over 24 steps."""
    tc = pt_config.TrainConfig(**dict(TC_KW, global_batch_size=8, inner_lr=3e-3,
                                      inner_min_lr=3e-3))
    run = SimulatedRun(PMC, tc, num_groups=2, seed=0, device="cpu")
    h = run.run(24, eval_every=12)
    assert all(np.isfinite(h["train_loss"]))
    assert np.mean(h["train_loss"][-4:]) < np.mean(h["train_loss"][:4]) - 0.2
    assert h["val_step"] == [11, 23] and np.isfinite(h["val_loss"]).all()
