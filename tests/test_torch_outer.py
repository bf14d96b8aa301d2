"""The port's Pier core against the reference: configs, schedule, outer step.

Same numpy inputs through ``repro`` and ``repro_torch``: the training
config copies, the schedule's event streams, the fused outer update (plain
version and wrapper on the CPU against the reference's oracle and its
Pallas kernel in interpret mode), the outer algebra, the flat fp32
dispatch and the strategies' resolution (the compressed strategies' numerics
are in ``test_torch_compress.py``). Elementwise functions must agree bit for
bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro.core import outer as JO  # noqa: E402
from repro.core.pier import PierSchedule as JSchedule  # noqa: E402
from repro.kernels.pier_update import pier_update as jax_pier_update  # noqa: E402
from repro.kernels.ref import pier_update_ref as jax_pier_update_ref  # noqa: E402
from repro.sync import resolve_strategy as jax_resolve  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.core import outer as PO  # noqa: E402
from repro_torch.core.pier import PierSchedule  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import pier_update as PK  # noqa: E402
from repro_torch.kernels.ref import pier_update_ref  # noqa: E402
from repro_torch.sync import (FlatFP32, resolve_strategy,  # noqa: E402
                              validate_pod_grouping)

FORMS = ["nesterov_torch", "nesterov_classic", "sgd"]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_within_fma_rounding(p, m, pj, mj, a, m0, d, mu, lr):
    """The port's separate fp32 multiplies and adds against XLA's CPU
    backend, which contracts ``mu*m + d`` and ``a + lr*step`` into fused
    multiply-adds inside the interpreted Pallas kernel (the reference's own
    jnp oracle does not, and agrees with the port bit for bit). An FMA skips
    one product's rounding, so each output may differ by a few fp32
    roundings of the terms that make it up: bound 4 eps times their
    magnitude."""
    eps = np.finfo(np.float32).eps
    mag_m = np.abs(mu * m0) + np.abs(d)
    mag_p = np.abs(a) + np.abs(lr) * (np.abs(mu) * mag_m + np.abs(d)) + mag_m
    assert np.all(np.abs(np.asarray(m, np.float32) - np.asarray(mj, np.float32)) <= 4 * eps * mag_m)
    assert np.all(np.abs(np.asarray(p) - np.asarray(pj)) <= 4 * eps * mag_p)


# ===========================================================================
# configs: the port's copies equal the originals
# ===========================================================================


@pytest.mark.parametrize("name", ["TrainConfig", "OuterCommConfig"])
def test_train_config_fields_match_reference(name):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_config, name))]
    pf = [(f.name, f.default) for f in dataclasses.fields(getattr(pt_config, name))]
    assert pf == jf


def test_train_config_schedules_match_reference():
    for kw in ({}, {"total_steps": 40, "warmup_frac": 0.1},
               {"total_steps": 1000, "warmup_frac": 0.25, "outer_lr_mid_end": 0.5}):
        jt, pt = jax_config.TrainConfig(**kw), pt_config.TrainConfig(**kw)
        assert pt.warmup_steps == jt.warmup_steps
        steps = range(0, jt.total_steps + 1, max(1, jt.total_steps // 97))
        assert [pt.mu_at(s) for s in steps] == [jt.mu_at(s) for s in steps]
        assert [pt.outer_lr_at(s) for s in steps] == [jt.outer_lr_at(s) for s in steps]
    assert pt_config.TrainConfig().outer_comm == pt_config.OuterCommConfig()


def test_train_config_validation():
    with pytest.raises(ValueError):
        pt_config.TrainConfig(sync_interval=4, sync_delay=4)
    with pytest.raises(ValueError):
        pt_config.TrainConfig(sync_delay=-1)
    # "auto" is accepted as in the reference (resolved before a schedule
    # runs); any other string is refused
    assert pt_config.TrainConfig(sync_delay="auto").sync_delay == "auto"
    with pytest.raises(ValueError):
        pt_config.TrainConfig(sync_delay="soon")
    with pytest.raises(ValueError):
        pt_config.OuterCommConfig(compression="zip")
    assert pt_config.TrainConfig().replace(sync_delay=3).sync_delay == 3


# ===========================================================================
# PierSchedule: the same event streams
# ===========================================================================


@pytest.mark.parametrize("optimizer,extra", [
    ("pier", {}), ("diloco", {}), ("diloco", {"lazy_start": False, "momentum_warmup": False}),
    ("adamw", {}), ("pier", {"momentum_warmup": False})])
def test_schedule_event_streams_equal(optimizer, extra):
    for total, interval, delay in [(40, 2, 0), (40, 2, 1), (60, 5, 3), (33, 4, 0),
                                   (100, 10, 9), (12, 3, 2), (7, 1, 0)]:
        kw = dict(total_steps=total, sync_interval=interval, sync_delay=delay,
                  optimizer=optimizer, warmup_frac=0.2, **extra)
        js = JSchedule(jax_config.TrainConfig(**kw))
        ps = PierSchedule(pt_config.TrainConfig(**kw))
        for step in range(total + interval):
            assert [dataclasses.astuple(e) for e in ps.events(step)] == \
                [dataclasses.astuple(e) for e in js.events(step)], (kw, step)
            assert ps.phase(step) == js.phase(step)
            assert ps.mu_at(step) == js.mu_at(step)
            assert ps.outer_lr_at(step) == js.outer_lr_at(step)
            if js.is_dispatch_step(step):
                assert ps.outer_index(step) == js.outer_index(step)
        assert ps.num_outer_steps() == js.num_outer_steps()
        assert ps.global_comm_fraction() == js.global_comm_fraction()


# ===========================================================================
# fused outer update: plain version and wrapper, bit for bit
# ===========================================================================


def _leaf(seed, n, m_dtype="float32"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32)
    d = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    if m_dtype == "bfloat16":
        m = np.array(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
    return a, m, d


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mu,lr", [(0.99, 0.3), (0.9, 1.1), (0.95, 0.7)])
def test_pier_update_ref_bitwise_vs_reference(form, mu, lr):
    a, m, d = _leaf(7, 4096 * 3 + 17)
    pj, mj = jax_pier_update_ref(jnp.asarray(a), jnp.asarray(m), jnp.asarray(d),
                                 mu=jnp.float32(mu), lr=jnp.float32(lr), formulation=form)
    pt, mt = pier_update_ref(torch.from_numpy(a), torch.from_numpy(m), torch.from_numpy(d),
                             mu=mu, lr=lr, formulation=form)
    np.testing.assert_array_equal(_bits(pt.numpy()), _bits(pj))
    np.testing.assert_array_equal(_bits(mt.numpy()), _bits(mj))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
def test_pier_update_wrapper_vs_pallas_interpret(form, m_dtype):
    """The CPU wrapper against the reference's TPU kernel body, interpreted:
    within FMA rounding (see ``_assert_within_fma_rounding``); the momentum
    stored in bf16 within one bf16 rounding more."""
    n = 4096 * 2 + 123  # ragged: not a multiple of the kernel's block
    a, m, d = _leaf(11, n, m_dtype)
    jdt = jnp.dtype(m_dtype)
    pj, mj = jax_pier_update(jnp.asarray(a), jnp.asarray(m, jdt), jnp.asarray(d),
                             jnp.float32(0.95), jnp.float32(1.1), formulation=form,
                             interpret=True)
    tdt = getattr(torch, m_dtype)
    before = PK.launches
    pt, mt = PK.pier_update(torch.from_numpy(a), torch.from_numpy(m).to(tdt),
                            torch.from_numpy(d), 0.95, 1.1, form)
    assert PK.launches == before  # a CPU tensor never counts as a launch
    assert pt.dtype == torch.float32 and mt.dtype == tdt
    mjf = np.asarray(mj.astype(jnp.float32))
    if m_dtype == "bfloat16":
        # one bf16 rounding of m' on each side: within one bf16 ulp
        assert np.all(np.abs(mt.float().numpy() - mjf) <= 2.0 ** -7 * np.abs(mjf))
        mjf = mt.float().numpy()
    _assert_within_fma_rounding(pt.numpy(), mt.float().numpy(), pj, mjf, a, m, d,
                                np.float32(0.95), np.float32(1.1))


def test_pier_update_in_place_outputs():
    a, m, d = _leaf(3, 999)
    at, mt, dt = (torch.from_numpy(x.copy()) for x in (a, m, d))
    p_ref, m_ref = pier_update_ref(at, mt, dt, mu=0.9, lr=1.1)
    p, mm = PK.pier_update(at, mt, dt, 0.9, 1.1, p_out=at, m_out=mt)
    assert p is at and mm is mt
    assert torch.equal(at, p_ref) and torch.equal(mt, m_ref)
    with pytest.raises(ValueError):
        PK.pier_update(at, mt, dt, 0.9, 1.1, "adam")
    with pytest.raises(ValueError):
        PK.pier_update(at, mt, dt[:10], 0.9, 1.1)


# ===========================================================================
# outer algebra against repro.core.outer
# ===========================================================================


def _trees(seed, shapes=((8, 16), (16,), (3, 5, 7))):
    rng = np.random.default_rng(seed)
    mk = lambda s=1.0: [(rng.standard_normal(sh) * s).astype(np.float32) for sh in shapes]  # noqa: E731
    return mk(), mk(), mk(1e-2)  # momentum, anchor, delta


def _pt(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_outer_reduce_bitwise_vs_reference(form, use_pallas):
    """Bit for bit against the reference's jnp path; against its Pallas
    path (interpreted) within FMA rounding."""
    m, a, d = _trees(5)
    jtc = jax_config.TrainConfig(outer_optimizer=form)
    tc = pt_config.TrainConfig(outer_optimizer=form)
    jstate = JO.OuterState(momentum=[jnp.asarray(x) for x in m],
                           anchor=[jnp.asarray(x) for x in a],
                           num_syncs=jnp.zeros((), jnp.int32))
    jt, jnew = JO.outer_reduce(jstate, [jnp.asarray(x) for x in d], jtc,
                               mu=jnp.float32(0.95), lr=jnp.float32(1.1),
                               use_pallas=use_pallas)
    for inplace in (False, True):
        state = PO.OuterState(momentum=_pt(m), anchor=_pt(a), num_syncs=0)
        t, new = PO.outer_reduce(state, _pt(d), tc, mu=0.95, lr=1.1, inplace=inplace)
        assert new.num_syncs == 1
        if inplace:  # the target is written over the anchor, the momentum over M
            assert all(x is y for x, y in zip(t, state.anchor))
            assert all(x is y for x, y in zip(new.momentum, state.momentum))
        for i, (x, y) in enumerate(zip(t, jt)):
            if use_pallas:
                _assert_within_fma_rounding(x.numpy(), new.momentum[i].numpy(), y,
                                            jnew.momentum[i], a[i], m[i], d[i],
                                            np.float32(0.95), np.float32(1.1))
                continue
            np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
            np.testing.assert_array_equal(_bits(new.momentum[i].numpy()),
                                          _bits(jnew.momentum[i]))
            np.testing.assert_array_equal(_bits(new.anchor[i].numpy()),
                                          _bits(jnew.anchor[i]))


def test_outer_reduce_bf16_state_matches_reference():
    m, a, d = _trees(6)
    jtc = jax_config.TrainConfig(opt_state_dtype="bfloat16")
    tc = pt_config.TrainConfig(opt_state_dtype="bfloat16")
    jstate = JO.outer_init([jnp.asarray(x) for x in a], jtc)
    jstate = jstate._replace(momentum=[jnp.asarray(x, jnp.bfloat16) for x in m])
    state = PO.outer_init(_pt(a), tc)
    state = state._replace(momentum=[torch.from_numpy(x).bfloat16() for x in m])
    jt, jnew = JO.outer_reduce(jstate, [jnp.asarray(x) for x in d], jtc,
                               mu=jnp.float32(0.9), lr=jnp.float32(0.8))
    t, new = PO.outer_reduce(state, _pt(d), tc, mu=0.9, lr=0.8)
    for x, y in zip(t, jt):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
    for x, y in zip(new.momentum + new.anchor, jnew.momentum + jnew.anchor):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(x.float().numpy()),
                                      _bits(np.asarray(y.astype(jnp.float32))))
    with pytest.raises(ValueError):
        PO.outer_reduce(state, _pt(d), tc, mu=0.9, lr=0.8, inplace=True)


def test_warmup_reduce_and_outer_apply_bitwise():
    m, a, p = _trees(8)
    jtc = jax_config.TrainConfig()
    tc = pt_config.TrainConfig()
    jstate = JO.OuterState(momentum=[jnp.asarray(x) for x in m],
                           anchor=[jnp.asarray(x) for x in a],
                           num_syncs=jnp.zeros((), jnp.int32))
    state = PO.OuterState(momentum=_pt(m), anchor=_pt(a), num_syncs=0)
    jnew = JO.warmup_accumulate(jstate, [jnp.asarray(x) for x in p], jnp.float32(0.99))
    params = _pt(p)
    new = PO.warmup_accumulate(state, params, 0.99)
    assert new.num_syncs == 1
    for x, y in zip(new.momentum + new.anchor, jnew.momentum + jnew.anchor):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
    params[0].add_(1.0)  # the pending anchor is a snapshot, not a view
    np.testing.assert_array_equal(new.anchor[0].numpy(), p[0])
    del jtc, tc

    # outer_apply: target + (current - dispatch), in place
    t, snap, cur = _trees(9)
    jout = JO.outer_apply([jnp.asarray(x) for x in t], [jnp.asarray(x) for x in snap],
                          [jnp.asarray(x) for x in cur])
    cur_t = _pt(cur)
    out = PO.outer_apply(_pt(t), _pt(snap), cur_t)
    assert out is cur_t
    for x, y in zip(out, jout):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
    # zero drift (dispatch == current): the target exactly
    cur_t = _pt(cur)
    PO.outer_apply(_pt(t), cur_t, cur_t)
    for x, y in zip(cur_t, t):
        np.testing.assert_array_equal(x.numpy(), y)


def test_ops_pier_update_leaf_matches_reference_ops():
    from repro.kernels import ops as jops

    m, a, d = _trees(10, shapes=((33, 65),))
    tc = pt_config.TrainConfig(outer_optimizer="nesterov_classic")
    jtc = jax_config.TrainConfig(outer_optimizer="nesterov_classic")
    pj, mj = jops.pier_update_leaf(jnp.asarray(a[0]), jnp.asarray(m[0]), jnp.asarray(d[0]),
                                   jtc, mu=0.99, lr=0.5)
    pt, mt = kops.pier_update_leaf(*_pt([a[0], m[0], d[0]]), tc, mu=0.99, lr=0.5)
    assert tuple(pt.shape) == (33, 65)
    _assert_within_fma_rounding(pt.numpy(), mt.numpy(), pj, mj, a[0], m[0], d[0],
                                np.float32(0.99), np.float32(0.5))


# ===========================================================================
# the flat fp32 strategy
# ===========================================================================


@pytest.mark.parametrize("G", [2, 4])
def test_flat_fp32_sim_dispatch_vs_reference(G):
    """Mean over G replicas, minus the anchor, outer update. Bit for bit at
    G = 2 (one addition and a halving round the same everywhere); within 1
    ulp of the leaf's scale at G = 4, where XLA's and torch's sums of four
    terms may associate differently."""
    rng = np.random.default_rng(G)
    shapes = ((8, 16), (16,), (3, 5, 7))
    groups = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(G)]
    m, a, _ = _trees(12, shapes)
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    jstate = JO.OuterState(momentum=[jnp.asarray(x) for x in m],
                           anchor=[jnp.asarray(x) for x in a],
                           num_syncs=jnp.zeros((), jnp.int32))
    stacked = [jnp.stack([jnp.asarray(g[i]) for g in groups]) for i in range(len(shapes))]
    jt, jnew = jax_resolve(jtc).sim_dispatch(stacked, jstate, jtc, mu=jnp.float32(0.9),
                                             lr=jnp.float32(1.1))
    state = PO.OuterState(momentum=_pt(m), anchor=_pt(a), num_syncs=0)
    strat = resolve_strategy(tc)
    assert isinstance(strat, FlatFP32) and strat.name == jax_resolve(jtc).name
    t, new = strat.sim_dispatch([_pt(g) for g in groups], state, tc, mu=0.9, lr=1.1,
                                inplace=True)
    for x, y in zip(t + new.momentum, list(jt) + list(jnew.momentum)):
        if G == 2:
            np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
        else:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=np.finfo(np.float32).eps * 8)
    plan = strat.plan(list(range(3)), tc)
    assert plan.spans == ((0, 3),) and not plan.needs_residual and plan.num_chunks == 1


@pytest.mark.parametrize("comm", [
    {"compression": "quantize"}, {"compression": "int8-wire"}, {"compression": "rs-ag"},
    {"hierarchical": True}, {"chunks": 2}, {"sharded": True}])
def test_unported_strategies_raise(comm):
    """The five ported strategies resolve as the reference's do: name, wire
    format, plan spans and wire bytes per parameter (1.015625 B for int8 at
    block 256). ``sharded`` still raises."""
    if comm.get("sharded"):
        with pytest.raises(NotImplementedError, match="queue"):
            resolve_strategy(pt_config.OuterCommConfig(**comm))
        return
    strat = resolve_strategy(pt_config.OuterCommConfig(**comm))
    jstrat = jax_resolve(jax_config.OuterCommConfig(**comm))
    shapes = [np.zeros(s, np.float32) for s in ((50, 16), (16,), (3, 5, 7), (64, 64), (9,))]
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    plan, jplan = strat.plan(shapes, tc), jstrat.plan(shapes, jtc)
    assert (strat.name, strat.wire_format) == (jstrat.name, jstrat.wire_format)
    assert (plan.name, plan.spans, plan.needs_residual, plan.wire_format,
            plan.needs_residual2) == (jplan.name, jplan.spans, jplan.needs_residual,
                                      jplan.wire_format, jplan.needs_residual2)
    assert strat.wire_bytes_per_param(tc) == jstrat.wire_bytes_per_param(jtc)
    if comm.get("compression") in ("int8-wire", "rs-ag"):
        assert strat.wire_bytes_per_param(tc) == 1.015625
    if comm.get("chunks"):
        assert plan.num_chunks == 2


@pytest.mark.parametrize("knobs", [
    {}, {"bits": 8}, {"bits": 4, "block": 64, "hierarchical": True},
    {"bits": 8, "chunks": 3}, {"compression": "int8-wire", "bits": 4},
    {"compression": "rs-ag", "block": 128}, {"hierarchical": True, "chunks": 2}])
def test_strategy_name_matches_reference(knobs):
    from repro.sync.strategies import strategy_name as jax_strategy_name

    from repro_torch.sync import strategy_name

    assert strategy_name(**knobs) == jax_strategy_name(**knobs)


def test_validate_pod_grouping():
    validate_pod_grouping(4, 2)
    with pytest.raises(ValueError):
        validate_pod_grouping(3, 2)


def test_outer_init_matches_reference():
    _, a, _ = _trees(13)
    for dt in ("float32", "bfloat16"):
        js = JO.outer_init([jnp.asarray(x) for x in a], jax_config.TrainConfig(opt_state_dtype=dt))
        ps = PO.outer_init(_pt(a), pt_config.TrainConfig(opt_state_dtype=dt))
        for x, y in zip(ps.momentum + ps.anchor, list(js.momentum) + list(js.anchor)):
            assert str(x.dtype) == f"torch.{y.dtype}"
            np.testing.assert_array_equal(x.float().numpy(), np.asarray(y.astype(jnp.float32)))
    assert ps.residual is None and ps.residual2 is None and js.residual is None
    # the compressed strategies' residuals: (G, *leaf) fp32 zeros per leaf
    for kw in ({}, {"needs_residual2": True}):
        js = JO.outer_init([jnp.asarray(x) for x in a], jax_config.TrainConfig(
            outer_comm=jax_config.OuterCommConfig(compression="quantize")), num_groups=3, **kw)
        ps = PO.outer_init(_pt(a), pt_config.TrainConfig(
            outer_comm=pt_config.OuterCommConfig(compression="quantize")), num_groups=3, **kw)
        pairs = list(zip(ps.residual, js.residual))
        if kw:
            pairs += list(zip(ps.residual2, js.residual2))
        else:
            assert ps.residual2 is None and js.residual2 is None
        for x, y in pairs:
            assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert len({x.data_ptr() for x, _ in pairs}) == len(pairs)  # nothing shared
    assert PO.outer_init(_pt(a), pt_config.TrainConfig(), num_groups=2,
                         needs_residual=True).residual[0].shape == (2, *a[0].shape)
    assert jax.tree_util.tree_structure(js.num_syncs).num_leaves == 1
