"""Elastic membership in the port against the reference, on the CPU.

- the membership state machine: the timelines and spec rejections of
  ``tests/test_membership.py``, and the port's records equal to the
  reference's for every script here (exact: host bookkeeping);
- the weighted reductions: ``weighted_stack_mean`` and
  ``dequant_sum_sources(weights=)`` at all-ones weights bit for bit the
  fixed ones (the stack mean: where ``1/G`` is exact, G = 2 and 4; at
  G = 3 and 5 the CPU's ``torch.mean`` divides where the weighted mean
  multiplies by the fp32 ``1/G``, so one ulp of the result), a mask equal
  to the subset's mean, an all-zero mask 0, non-binary weights the
  weighted mean; and against the reference's weighted functions;
- each strategy's weighted ``sim_reduce`` and ``sim_dispatch`` against the
  reference's, with the tolerances of ``tests/test_torch_compress.py``;
- a 12-step elastic ``SimulatedRun`` (G = 3, ``drop:1@1,rejoin:1@3,
  straggle:2@2+2``) against the reference simulator for FlatFP32,
  Quantized and Int8Wire at delay 0 and 1, and the churn semantics (a
  dropped group keeps stale parameters then bootstraps, a straggler
  receives applies and contributes nothing, a checkpoint donor).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro import sync as JS  # noqa: E402
from repro.core import outer as JO  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.sync import resolve_strategy as jax_resolve  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import outer as PO  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.kernels import wire as W  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch import sync as PS  # noqa: E402
from repro_torch.sync import resolve_strategy  # noqa: E402

BLOCK = 64
EPS = np.finfo(np.float32).eps


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy().view(np.uint32),
                                  np.asarray(ref, np.float32).view(np.uint32))


# ===========================================================================
# the membership state machine
# ===========================================================================


def test_churn_spec_roundtrip():
    s = PS.ChurnSchedule.parse(" drop:1@3, rejoin:1@6 ,straggle:0@4+2 ")
    assert s.events == (PS.ChurnEvent("drop", 1, 3), PS.ChurnEvent("rejoin", 1, 6),
                        PS.ChurnEvent("straggle", 0, 4, late=2))
    assert s.max_event() == 6
    assert s.for_group(1) == (PS.ChurnEvent("drop", 1, 3), PS.ChurnEvent("rejoin", 1, 6))
    assert PS.ChurnSchedule.parse("").events == ()


@pytest.mark.parametrize("bad", ["flake:0@1", "drop:0@1+2", "straggle:0@1", "rejoin:0@0",
                                 "drop:0", "drop:a@1"])
def test_churn_spec_rejects(bad):
    with pytest.raises(ValueError):
        PS.ChurnSchedule.parse(bad)
    with pytest.raises(ValueError):
        JS.ChurnSchedule.parse(bad)


def test_controller_drop_rejoin_straggle_timeline():
    ctrl = PS.MembershipController(
        4, cfg=pt_config.MembershipConfig(max_staleness=1),
        schedule=PS.ChurnSchedule.parse("drop:1@3,rejoin:1@6,straggle:0@4+2"))
    assert ctrl.elastic
    assert ctrl.at(0).full and ctrl.at(2).full
    assert ctrl.at(3).weights == (1.0, 0.0, 1.0, 1.0)
    assert ctrl.at(3).apply_live == (True, False, True, True)
    assert ctrl.at(4).apply_live == (True, False, True, True)
    assert ctrl.at(4).weights == (0.0, 0.0, 1.0, 1.0)
    assert ctrl.at(5).weights[0] == 0.0 and ctrl.at(5).apply_live[0] is True
    assert ctrl.at(5).bootstrap_after_apply == (0, 1)
    assert ctrl.at(6).full
    assert ctrl.at(7).full and ctrl.at(7).bootstrap_after_apply == ()


def test_controller_straggler_eviction_and_reentry():
    ctrl = PS.MembershipController(2, cfg=pt_config.MembershipConfig(max_staleness=1),
                                   schedule=PS.ChurnSchedule.parse("straggle:1@2+3"))
    assert ctrl.at(2).apply_live == (True, True)
    assert ctrl.at(3).apply_live == (True, True)
    assert ctrl.at(4).apply_live == (True, False)
    assert ctrl.at(4).bootstrap_after_apply == (1,)
    assert ctrl.at(5).full


def test_controller_min_live_fails_at_construction():
    with pytest.raises(ValueError, match="min_live"):
        PS.MembershipController(2, cfg=pt_config.MembershipConfig(min_live=2),
                                schedule=PS.ChurnSchedule.parse("drop:0@1,rejoin:0@3"))


@pytest.mark.parametrize("spec", ["drop:0@1,drop:0@2", "rejoin:0@2", "drop:0@2,rejoin:0@2",
                                  "straggle:0@1+3,drop:0@2", "straggle:0@1+3,straggle:0@2+1"])
def test_controller_rejects_incoherent_scripts(spec):
    with pytest.raises(ValueError):
        PS.MembershipController(4, schedule=PS.ChurnSchedule.parse(spec))


def test_controller_rejects_out_of_range_group_and_empty_is_full():
    with pytest.raises(ValueError, match="only 2 groups"):
        PS.MembershipController(2, schedule=PS.ChurnSchedule.parse("drop:2@1"))
    ctrl = PS.MembershipController(3)
    assert not ctrl.elastic and ctrl.at(0).full and ctrl.at(11).full
    with pytest.raises(ValueError):
        ctrl.at(-1)


@pytest.mark.parametrize("G,spec,staleness", [
    (4, "drop:1@3,rejoin:1@6,straggle:0@4+2", 1), (2, "straggle:1@2+3", 1),
    (3, "drop:1@1,rejoin:1@3,straggle:2@2+2", 1), (3, "drop:0@0,rejoin:0@2", 0),
    (4, "straggle:3@1+4,drop:2@2", 2), (3, "drop:2@1", 1)])
def test_records_equal_the_reference(G, spec, staleness):
    mine = PS.MembershipController(G, cfg=pt_config.MembershipConfig(max_staleness=staleness),
                                   schedule=PS.ChurnSchedule.parse(spec))
    ref = JS.MembershipController(G, cfg=jax_config.MembershipConfig(max_staleness=staleness),
                                  schedule=JS.ChurnSchedule.parse(spec))
    assert mine.elastic == ref.elastic
    for k in range(12):
        a, b = mine.at(k), ref.at(k)
        assert (a.event, a.weights, a.apply_live, a.bootstrap_after_apply) == (
            b.event, b.weights, b.apply_live, b.bootstrap_after_apply), k


def test_membership_config_copy_matches_reference():
    import dataclasses

    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.MembershipConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pt_config.MembershipConfig)]
    assert pf == jf
    for kw in ({"max_staleness": -1}, {"min_live": 0}, {"rejoin_bootstrap": "peer"}):
        with pytest.raises(ValueError):
            pt_config.MembershipConfig(**kw)


# ===========================================================================
# the weighted reductions
# ===========================================================================


@pytest.mark.parametrize("E", [2, 3, 4, 5])
def test_weighted_stack_mean_all_ones(E):
    """Bit for bit the fixed mean where 1/E is exact (E = 2, 4); within one
    ulp of the result where the CPU mean divides (E = 3, 5). Against the
    reference's weighted mean: within one ulp (XLA and torch may order the
    E-term sum differently)."""
    x = np.random.default_rng(E).standard_normal((E, 37, 5)).astype(np.float32)
    got = PS.weighted_stack_mean(torch.from_numpy(x), np.ones(E))
    fixed = torch.from_numpy(x).mean(dim=0)
    if E in (2, 4):
        assert torch.equal(got, fixed)
    else:
        np.testing.assert_allclose(got.numpy(), fixed.numpy(), rtol=EPS, atol=0)
    ref = np.asarray(jax.jit(JS.weighted_stack_mean)(jnp.asarray(x), jnp.ones((E,))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2 * EPS, atol=EPS * np.abs(ref).max())


def test_weighted_stack_mean_mask_zero_and_downweight():
    x = np.random.default_rng(0).standard_normal((4, 33)).astype(np.float32)
    t = torch.from_numpy(x)
    got = PS.weighted_stack_mean(t, [1.0, 0.0, 1.0, 1.0])
    want = t[[0, 2, 3]].mean(dim=0)  # one ulp: sums of 4 and of 3 terms
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6, atol=1e-6)
    assert torch.equal(PS.weighted_stack_mean(t[:3], np.zeros(3)), torch.zeros(33))
    w = np.asarray([1.0, 0.5, 0.25, 0.0], np.float32)
    ref = np.asarray(JS.weighted_stack_mean(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(PS.weighted_stack_mean(t, w).numpy(), ref, rtol=2e-6,
                               atol=1e-7)


def _quantize_stack(E, n=512, seed=0):
    d = np.random.default_rng(seed).standard_normal((E, n)).astype(np.float32)
    qs = [PR.quantize_blockwise_ref(torch.from_numpy(x), block=BLOCK, bits=8) for x in d]
    return torch.stack([q for q, _ in qs]), torch.stack([s for _, s in qs])


@pytest.mark.parametrize("E", [2, 3, 4, 6])
def test_dequant_sum_sources_all_ones_bitwise(E):
    wg, sg = _quantize_stack(E)
    a = W.dequant_sum_sources(wg, sg, bits=8, block=BLOCK)
    b = W.dequant_sum_sources(wg, sg, bits=8, block=BLOCK, weights=np.ones(E))
    assert torch.equal(a, b)
    ref = JR.dequant_sum_sources(jnp.asarray(wg.numpy()), jnp.asarray(sg.numpy()), bits=8,
                                 block=BLOCK, weights=jnp.ones((E,)))
    _eq(b, ref)


def test_dequant_sum_sources_mask_equals_subset_and_downweights():
    wg, sg = _quantize_stack(4)
    keep = [0, 2, 3]
    got = W.dequant_sum_sources(wg, sg, bits=8, block=BLOCK, weights=[1.0, 0.0, 1.0, 1.0])
    assert torch.equal(got, W.dequant_sum_sources(wg[keep], sg[keep], bits=8, block=BLOCK))
    assert torch.equal(W.dequant_sum_sources(wg, sg, bits=8, block=BLOCK,
                                             weights=np.zeros(4)), torch.zeros(512))
    w = np.asarray([1.0, 0.5, 0.25, 0.0], np.float32)
    got = W.dequant_sum_sources(wg, sg, bits=8, block=BLOCK, weights=w)
    ref = JR.dequant_sum_sources(jnp.asarray(wg.numpy()), jnp.asarray(sg.numpy()), bits=8,
                                 block=BLOCK, weights=jnp.asarray(w))
    _eq(got, ref)
    parts = [W.dequant_sum_sources(wg[i:i + 1], sg[i:i + 1], bits=8, block=BLOCK)
             for i in range(4)]
    want = sum(float(wi) * p for wi, p in zip(w, parts)) / float(w.sum())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


# (id, OuterCommConfig kwargs, G, P, weights)
WSTRATS = [
    ("flat_g3", {}, 3, 1, [1.0, 0.0, 1.0]),
    ("quantize_g3", {"compression": "quantize"}, 3, 1, [0.0, 1.0, 1.0]),
    ("quantize_int4_g4", {"compression": "quantize", "bits": 4, "block": 64}, 4, 1,
     [1.0, 1.0, 0.0, 1.0]),
    ("int8wire_g3", {"compression": "int8-wire"}, 3, 1, [1.0, 0.0, 1.0]),
    ("int4wire_g4", {"compression": "int8-wire", "bits": 4, "block": 32}, 4, 1,
     [0.0, 1.0, 1.0, 0.5]),
    ("rsag_g3", {"compression": "rs-ag"}, 3, 1, [1.0, 1.0, 0.0]),
    ("hier_quantize_g4p2", {"compression": "quantize", "hierarchical": True}, 4, 2,
     [1.0, 0.0, 1.0, 1.0]),
    ("hier_int8wire_g4p2", {"compression": "int8-wire", "hierarchical": True}, 4, 2,
     [0.0, 0.0, 1.0, 1.0]),
]
SHAPES = ((8, 16), (16,), (3, 5, 7), (1,))


def _leaves(rng, scale=1e-3):
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in SHAPES]


def _strats(comm):
    return (resolve_strategy(pt_config.OuterCommConfig(**comm)),
            jax_resolve(jax_config.OuterCommConfig(**comm)))


@pytest.mark.parametrize("sid,comm,G,P,w", WSTRATS, ids=[s[0] for s in WSTRATS])
def test_weighted_sim_reduce_matches_reference(sid, comm, G, P, w):
    """Two weighted rounds, the residuals carried (every group, the absent
    ones too, keeps its own): the payload within 8 ulps of the leaf's scale
    where a weighted mean of more than two terms may associate differently
    (the wire's per-source sums are bitwise), the residuals bit for bit;
    at all-ones weights the fixed reduction's bits (G is 2 or 4 where the
    plain mean divides)."""
    strat, jstrat = _strats(comm)
    rng = np.random.default_rng(G * 13 + len(sid))
    zeros = [np.zeros((G, *s), np.float32) for s in SHAPES]
    r, rj = [torch.from_numpy(z) for z in zeros], [jnp.asarray(z) for z in zeros]
    if strat.needs_residual2:
        r, rj = (r, [x.clone() for x in r]), (rj, list(rj))
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    wire = comm.get("compression") in ("int8-wire", "rs-ag") and not comm.get("hierarchical")
    for _ in range(2):
        d = [np.stack(x) for x in zip(*[_leaves(rng) for _ in range(G)])]
        p, r = strat.sim_reduce([torch.from_numpy(x) for x in d], r, tc, num_pods=P, weights=w)
        pj, rj = jstrat.sim_reduce([jnp.asarray(x) for x in d], rj, jtc, num_pods=P,
                                   weights=jnp.asarray(w, jnp.float32))
        for a, b in zip(p, pj):
            if wire:
                _eq(a, b)
            else:
                scale = max(float(np.abs(np.asarray(b)).max()), 1e-30)
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=8 * EPS * scale)
        pairs = (list(zip(r[0] + r[1], list(rj[0]) + list(rj[1]))) if strat.needs_residual2
                 else list(zip(r, rj)))
        for a, b in pairs:
            _eq(a, b)
    if G in (2, 4):
        d = [torch.from_numpy(np.stack(x)) for x in zip(*[_leaves(rng) for _ in range(G)])]
        fixed, _ = strat.sim_reduce(d, r, tc, num_pods=P)
        ones, _ = strat.sim_reduce(d, r, tc, num_pods=P, weights=np.ones(G))
        assert all(torch.equal(a, b) for a, b in zip(fixed, ones))


@pytest.mark.parametrize("sid,comm,G,P,w", [s for s in WSTRATS if s[0] in (
    "flat_g3", "quantize_g3", "int8wire_g3", "rsag_g3", "hier_int8wire_g4p2")],
    ids=["flat_g3", "quantize_g3", "int8wire_g3", "rsag_g3", "hier_int8wire_g4p2"])
def test_weighted_sim_dispatch_matches_reference(sid, comm, G, P, w):
    """Per-group Δθ, the weighted reduction and the outer update: target and
    momentum within 8 ulps of their scale (a weighted mean of three groups
    may associate differently in XLA and torch), residuals bit for bit."""
    strat, jstrat = _strats(comm)
    rng = np.random.default_rng(G + 300)
    groups = [_leaves(rng, scale=1.0) for _ in range(G)]
    anchor = _leaves(rng, scale=1.0)
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    jstate = JO.outer_init([jnp.asarray(a) for a in anchor], jtc, num_groups=G,
                           needs_residual=strat.needs_residual,
                           needs_residual2=strat.needs_residual2)
    state = PO.outer_init([torch.from_numpy(a) for a in anchor], tc, num_groups=G,
                          needs_residual=strat.needs_residual,
                          needs_residual2=strat.needs_residual2)
    stacked = [jnp.stack([jnp.asarray(g[i]) for g in groups]) for i in range(len(SHAPES))]
    jt, jstate = jstrat.sim_dispatch(stacked, jstate, jtc, mu=jnp.float32(0.9),
                                     lr=jnp.float32(0.7), num_pods=P,
                                     weights=jnp.asarray(w, jnp.float32))
    t, state = strat.sim_dispatch([[torch.from_numpy(x) for x in g] for g in groups], state,
                                  tc, mu=0.9, lr=0.7, num_pods=P, weights=w, inplace=True)
    for a, b in zip(t + state.momentum, list(jt) + list(jstate.momentum)):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=8 * EPS * scale)
    for field in ("residual", "residual2"):
        mine, ref = getattr(state, field), getattr(jstate, field)
        assert (mine is None) == (ref is None)
        for a, b in zip(mine or (), ref or ()):
            _eq(a, b)


# ===========================================================================
# the elastic simulator against the reference's
# ===========================================================================

MC_KW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
PMC = pt_config.ModelConfig(**MC_KW)
TC_KW = dict(total_steps=40, global_batch_size=6, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)
G = 3
SPEC = "drop:1@1,rejoin:1@3,straggle:2@2+2"
# The loss within 1e-5 and the state within three int8 quantization steps
# (5e-5), as tests/test_torch_compress.py says why. A group bootstrapped
# at a rejoin takes its next step with fresh AdamW state, whose first
# update is ±lr·g/(|g| + eps) per element: an element whose gradient is a
# rounding residue (|g| near eps, its sign set by the summation order)
# moves by up to lr one way or the other, and the next sync hands that
# element to every group (and, through its delta, to the outer momentum).
# The parameters and the momentum are each held to three quantization
# steps (5e-5) where that does not happen, and at most 2e-3 (two inner
# LRs) on at most one element in two thousand (measured: 30 of 235 392
# parameters here).
LOSS_TOL, STATE_TOL, FRESH_TOL, FRESH_FRACTION = 1e-5, 5e-5, 2e-3, 5e-4
RUNS = [("flat_d0", {}, 0), ("flat_d1", {}, 1), ("quantize_d0", {"compression": "quantize"}, 0),
        ("quantize_d1", {"compression": "quantize"}, 1),
        ("int8wire_d0", {"compression": "int8-wire"}, 0),
        ("int8wire_d1", {"compression": "int8-wire"}, 1)]


def _batches(n=12):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, (6, 17)).astype(np.int32) for _ in range(n)]


def _runs(comm, delay, spec=SPEC, *, ckpt=None, rejoin="anchor", ref=True):
    batches = _batches()
    mcfg = dict(max_staleness=1, rejoin_bootstrap=rejoin)
    jtc = jax_config.TrainConfig(**TC_KW, sync_delay=delay,
                                 outer_comm=jax_config.OuterCommConfig(**comm),
                                 membership=jax_config.MembershipConfig(**mcfg))
    tc = pt_config.TrainConfig(**TC_KW, sync_delay=delay,
                               outer_comm=pt_config.OuterCommConfig(**comm),
                               membership=pt_config.MembershipConfig(**mcfg))
    jr = JaxRun(jax_config.ModelConfig(**MC_KW), jtc, num_groups=G, seed=0,
                membership=JS.MembershipController(G, cfg=jtc.membership,
                                                   schedule=JS.ChurnSchedule.parse(spec)))
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr = SimulatedRun(PMC, tc, num_groups=G, device="cpu", checkpoint_manager=ckpt,
                      params=params_from_jax(tree, PMC, device="cpu", training=True),
                      membership=PS.MembershipController(
                          G, cfg=tc.membership, schedule=PS.ChurnSchedule.parse(spec)))
    pr._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                  "labels": torch.from_numpy(batches[s][:, 1:])}
    return (jr if ref else None), pr


def _group(run, g):
    return [t.detach().clone() for _, t in param_leaves(run.state.group_params[g])]


def _ref_group(jr, g):
    return [np.asarray(x[g]) for x in jax.tree_util.tree_leaves(jr.state.group_params)]


@pytest.mark.parametrize("rid,comm,delay", RUNS, ids=[r[0] for r in RUNS])
def test_elastic_run_matches_reference(rid, comm, delay):
    """12 steps, G = 3, outer events after steps 5, 7, 9, 11 (ordinals 0-3):
    group 1 absent at events 1-2 and bootstrapped after event 2's apply;
    group 2's deltas discarded at events 2-3, evicted after event 3 and
    bootstrapped there. Every group's parameters, the momentum and the
    residuals against the reference's."""
    jr, pr = _runs(comm, delay)
    jh, ph = jr.run(12), pr.run(12)
    jr.flush()
    pr.flush()
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=0, atol=LOSS_TOL)
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs)
    pairs = {"params": [(a, b) for g in range(G)
                        for a, b in zip(_group(pr, g), _ref_group(jr, g))],
             "momentum": list(zip(pr.state.outer.momentum,
                                  jax.tree_util.tree_leaves(jr.state.outer.momentum)))}
    for what, leaves in pairs.items():
        over = total = 0
        for a, b in leaves:
            err = np.abs(a.numpy() - np.asarray(b))
            assert err.max() <= FRESH_TOL, what
            over += int((err > STATE_TOL).sum())
            total += err.size
        assert over <= FRESH_FRACTION * total, (what, over, total)
    if comm:
        res = jax.tree_util.tree_leaves(jr.state.outer.residual)
        for a, b in zip(pr.state.outer.residual, res):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= STATE_TOL
        # group 2 was bootstrapped after the last event: a zero row
        assert all(float(r[2].abs().max()) == 0.0 for r in pr.state.outer.residual)


def test_dropped_group_keeps_stale_params_then_bootstraps():
    """Event 1 (step 7): group 1 absent, its parameters and the snapshot
    untouched by the apply while the live groups take the anchor; event 2's
    apply (step 9) bootstraps it onto the anchor with fresh AdamW state."""
    _, pr = _runs({}, 1, "drop:1@1,rejoin:1@3", ref=False)
    pr.run(8)  # event 1 dispatched after step 7, in flight (delay 1)
    before = _group(pr, 1)
    pr.run(1)  # step 8: the apply lands
    live = _group(pr, 0)
    anchor = pr.state.outer.anchor
    stale = _group(pr, 1)
    assert any(not torch.equal(a, b) for a, b in zip(live, before))
    assert any(float((s - a).abs().max()) > 0 for s, a in zip(stale, anchor))
    pr.run(2)  # steps 9 and 10: event 2 dispatched, applied at 10, then bootstrap
    assert all(torch.equal(a, b) for a, b in zip(_group(pr, 1), pr.state.outer.anchor))
    opt = pr.state.opt[1]
    assert int(opt.count) == 0 and all(float(m.abs().max()) == 0 for m in opt.mu + opt.nu)
    assert int(pr.state.opt[0].count) == 11  # every step so far, the warmup too


def test_straggler_receives_applies_but_contributes_nothing():
    """Event 1: group 0's delta discarded (weight 0) while it still installs
    the target; the target equals a run where group 0 is dropped."""
    _, strag = _runs({}, 0, "straggle:0@1+1", ref=False)
    strag.run(8)
    assert all(torch.equal(a, b) for a, b in zip(_group(strag, 0), strag.state.outer.anchor))
    _, drop = _runs({}, 0, "drop:0@1,rejoin:0@2", ref=False)
    drop.run(8)
    assert all(torch.equal(a, b)
               for a, b in zip(strag.state.outer.anchor, drop.state.outer.anchor))


def test_checkpoint_bootstrap_donor(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    _, pr = _runs({}, 0, "drop:1@1,rejoin:1@3", ckpt=ckpt, rejoin="checkpoint", ref=False)
    pr.run(6)  # through event 0: groups synced on the anchor
    donor = _group(pr, 0)
    ckpt.save(6, {"params": pr.state.group_params[0]})
    pr.run(4)  # event 2's apply (step 9) bootstraps group 1 from the checkpoint
    assert all(torch.equal(a, b) for a, b in zip(_group(pr, 1), donor))


def test_membership_wrong_group_count_and_chunked_rejected():
    tc = pt_config.TrainConfig(**TC_KW, membership=pt_config.MembershipConfig())
    with pytest.raises(ValueError, match="tracks 2 groups"):
        SimulatedRun(PMC, tc, num_groups=3, device="cpu", membership=PS.MembershipController(2))
    chunked = tc.replace(outer_comm=pt_config.OuterCommConfig(chunks=3))
    with pytest.raises(NotImplementedError, match="chunked"):
        SimulatedRun(PMC, chunked, num_groups=3, device="cpu")


def test_full_membership_is_the_fixed_path_bitwise():
    """TrainConfig.membership with no churn runs the weighted path at
    all-ones weights: at G = 2 bit for bit the fixed run, for the three
    main strategies and delay 1."""
    batches = _batches()
    for comm in ({}, {"compression": "quantize"}, {"compression": "int8-wire"}):
        runs = []
        for membership in (None, pt_config.MembershipConfig()):
            tc = pt_config.TrainConfig(**dict(TC_KW, global_batch_size=4), sync_delay=1,
                                       outer_comm=pt_config.OuterCommConfig(**comm),
                                       membership=membership)
            run = SimulatedRun(PMC, tc, num_groups=2, device="cpu", seed=0)
            run._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:4, :-1]),
                                           "labels": torch.from_numpy(batches[s][:4, 1:])}
            runs.append((run.run(10), run))
        (h0, r0), (h1, r1) = runs
        assert h0["train_loss"] == h1["train_loss"]
        for g in range(2):
            assert all(torch.equal(a, b) for a, b in zip(_group(r0, g), _group(r1, g)))
        assert all(torch.equal(a, b) for a, b in zip(r0.state.outer.momentum,
                                                     r1.state.outer.momentum))
        assert not r1.membership.elastic
