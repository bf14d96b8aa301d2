"""The port's compressed and hierarchical outer sync against the reference.

Same numpy inputs through ``repro`` and ``repro_torch``, on the CPU, where
the port's quantize and dequantize wrappers run their plain versions: the
dequantize (against the reference's Pallas kernel in interpret mode and
its oracle), the int4 wire packing, the per-source-scale reductions of the
int8 wire and of rs-ag, ``compress_delta`` with error feedback, each
strategy's ``sim_reduce`` and ``sim_dispatch``, and 12 steps of
``SimulatedRun`` against the reference simulator. Everything elementwise
or summed in a fixed order agrees bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from repro.core import outer as JO  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.quantize import _dequantize_pallas  # noqa: E402
from repro.sync import resolve_strategy as jax_resolve  # noqa: E402
from repro.sync import strategies as JS  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import outer as PO  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import quantize as QK  # noqa: E402
from repro_torch.kernels import wire as W  # noqa: E402
from repro_torch.kernels.ref import dequantize_blockwise_ref  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.sync import (Chunked, Hierarchical, Int8Wire,  # noqa: E402
                              resolve_strategy)

EPS = np.finfo(np.float32).eps


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _eq(port, ref):
    """Bit for bit, for float and integer arrays alike."""
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        np.testing.assert_array_equal(a, b)


def _quantized(rng, n, bits, block):
    """Random (q, scales) as the reference's quantizer makes them, with
    a zero block (scale 0) first when there is room."""
    x = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    x[:min(block, n // 2)] = 0.0
    q, s = JR.quantize_blockwise_ref(jnp.asarray(x), bits=bits, block=block)
    return np.asarray(q), np.asarray(s)


# ===========================================================================
# the dequantize kernel's plain version and wrapper
# ===========================================================================


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block", [32, 64, 256])
def test_dequantize_matches_reference_kernel_and_oracle(block, bits):
    rng = np.random.default_rng(block + bits)
    q, s = _quantized(rng, 37 * block + 5, bits, block)  # padded to 38 blocks
    assert q.shape == (38 * block,)
    want = np.asarray(_dequantize_pallas(jnp.asarray(q), jnp.asarray(s), block=block,
                                         interpret=True))
    _eq(np.asarray(JR.dequantize_blockwise_ref(jnp.asarray(q), jnp.asarray(s), block=block)),
        want)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    _eq(dequantize_blockwise_ref(qt, st, block=block), want)
    before = QK.dequantize_launches
    _eq(kops.dequantize_blockwise(qt, st, block=block), want)
    assert QK.dequantize_launches == before  # the CPU runs no kernel
    # the round trip through the port's own quantizer is the same
    x = torch.from_numpy((rng.standard_normal(3 * block + 1) * 1e-3).astype(np.float32))
    qp, sp = kops.quantize_blockwise(x, bits=bits, block=block)
    qj, sj = JR.quantize_blockwise_ref(jnp.asarray(x.numpy()), bits=bits, block=block)
    _eq(kops.dequantize_blockwise(qp, sp, block=block),
        _dequantize_pallas(qj, sj, block=block, interpret=True))


def test_dequantize_ragged_payload_raises_everywhere():
    q, s = np.zeros(300, np.int8), np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="ragged"):
        _dequantize_pallas(jnp.asarray(q), jnp.asarray(s), block=256, interpret=True)
    with pytest.raises(ValueError, match="ragged"):
        JR.dequantize_blockwise_ref(jnp.asarray(q), jnp.asarray(s), block=256)
    with pytest.raises(ValueError, match="ragged"):
        dequantize_blockwise_ref(torch.from_numpy(q), torch.from_numpy(s), block=256)
    with pytest.raises(ValueError, match="ragged"):
        kops.dequantize_blockwise(torch.from_numpy(q), torch.from_numpy(s), block=256)
    # the check comes before the device's branch
    with pytest.raises(ValueError, match="ragged"):
        kops.dequantize_blockwise(torch.zeros(300, dtype=torch.int8, device="meta"),
                                  torch.zeros(2, device="meta"), block=256)


def test_dequantize_wrapper_refuses_other_devices_and_layouts():
    with pytest.raises(ValueError, match="unsupported device"):
        kops.dequantize_blockwise(torch.zeros(512, dtype=torch.int8, device="meta"),
                                  torch.zeros(2, device="meta"), block=256)
    with pytest.raises(ValueError):
        kops.dequantize_blockwise(torch.zeros((2, 256), dtype=torch.int8),
                                  torch.zeros(2), block=256)
    with pytest.raises(ValueError):
        kops.dequantize_blockwise(torch.zeros(256, dtype=torch.int8), torch.zeros(1), block=0)


# ===========================================================================
# wire packing and the per-source reductions
# ===========================================================================


@pytest.mark.parametrize("n", [1, 2, 7, 255, 1001])
def test_pack_unpack_wire_bitwise(n):
    rng = np.random.default_rng(n)
    q4 = rng.integers(-7, 8, n).astype(np.int8)
    q4[:min(n, 15)] = np.arange(-7, 8)[:min(n, 15)]  # every int4 value
    w = W.pack_wire(torch.from_numpy(q4), 4)
    wj = JR.pack_wire(jnp.asarray(q4), 4)
    _eq(w, wj)
    assert w.dtype == torch.uint8 and w.shape == ((n + 1) // 2,)
    _eq(W.unpack_wire(w, 4, n), JR.unpack_wire(wj, 4, n))
    _eq(W.unpack_wire(w, 4, n), q4)
    q8 = rng.integers(-127, 128, n).astype(np.int8)
    _eq(W.unpack_wire(W.pack_wire(torch.from_numpy(q8), 8), 8, n), q8)


def test_block_counts_match_reference():
    for n, block, align in [(1, 256, 1), (1000, 256, 4), (256 * 7, 256, 3), (5, 1, 2)]:
        assert W.aligned_block_count(n, block, align) == JR.aligned_block_count(n, block, align)
    for nb, e in [(1, 1), (7, 2), (9, 4), (12, 3)]:
        assert W.wire_shard_blocks(nb, e) == JR.wire_shard_blocks(nb, e)
    with pytest.raises(ValueError):
        W.wire_shard_blocks(4, 0)


def _sources(E, nb, bits, block, seed):
    rng = np.random.default_rng(seed)
    qs, ss = zip(*[_quantized(rng, nb * block - 3, bits, block) for _ in range(E)])
    return np.stack(qs), np.stack(ss)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("E", [2, 3, 4])
def test_wire_reductions_bitwise(E, bits):
    """The ring's sum, the reduce-scatter and the rs/ag round trip (with and
    without a second residual) at a block count that E does not divide."""
    block, nb = 32, 7
    q, s = _sources(E, nb, bits, block, seed=10 * E + bits)
    qj, sj, qt, st = jnp.asarray(q), jnp.asarray(s), torch.from_numpy(q), torch.from_numpy(s)
    wg = torch.stack([W.pack_wire(qt[j], bits) for j in range(E)])
    wgj = jnp.stack([JR.pack_wire(qj[j], bits) for j in range(E)])
    _eq(W.dequant_sum_sources(wg, st, bits=bits, block=block),
        JR.dequant_sum_sources(wgj, sj, bits=bits, block=block))
    _eq(W.ring_allreduce_qs_ref(qt, st, block=block, bits=bits),
        JR.ring_allreduce_qs_ref(qj, sj, block=block, bits=bits))
    for e in range(E):
        ws, ss = W.shard_slot_wire(qt[e], st[e], bits=bits, block=block, endpoints=E)
        wsj, ssj = JR.shard_slot_wire(qj[e], sj[e], bits=bits, block=block, endpoints=E)
        _eq(ws, wsj)
        _eq(ss, ssj)
    _eq(W.reduce_scatter_qs_ref(qt, st, block=block, bits=bits),
        JR.reduce_scatter_qs_ref(qj, sj, block=block, bits=bits))
    _eq(W.dequant_concat_sources(wg, st, bits=bits, block=block),
        JR.dequant_concat_sources(wgj, sj, bits=bits, block=block))
    slot = W.wire_shard_blocks(nb, E) * block
    r2 = (np.random.default_rng(E).standard_normal((E, slot)) * 1e-5).astype(np.float32)
    for res in (None, r2):
        p, nr = W.rs_ag_qs_ref(qt, st, block=block, bits=bits,
                               residual2=None if res is None else torch.from_numpy(res))
        pj, nrj = JR.rs_ag_qs_ref(qj, sj, block=block, bits=bits,
                                  residual2=None if res is None else jnp.asarray(res))
        _eq(p, pj)
        _eq(nr, nrj)
    # all-ones weights: the weighted sum is the unweighted one bit for bit
    _eq(W.dequant_sum_sources(wg, st, bits=bits, block=block, weights=np.ones(E)),
        W.dequant_sum_sources(wg, st, bits=bits, block=block))


# ===========================================================================
# compress_delta and the outer state
# ===========================================================================

SHAPES = ((8, 16), (16,), (3, 5, 7), (1,))


def _leaves(rng, shapes=SHAPES, scale=1e-3):
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bits,block", [(8, 256), (4, 32), (8, 64)])
def test_compress_delta_three_rounds_bitwise(bits, block):
    """c = Δθ + r, quantize, dequantize, r' = c − payload, three rounds with
    the residual carried; payload + r' == c exactly."""
    rng = np.random.default_rng(bits * block)
    r, rj = None, None
    for _ in range(3):
        d = _leaves(rng)
        p, r_new = PO.compress_delta([torch.from_numpy(x) for x in d], r, bits=bits,
                                     block=block)
        pj, rj = JO.compress_delta([jnp.asarray(x) for x in d], rj, bits=bits, block=block)
        for a, b, x, y in zip(p, pj, r_new, rj):
            _eq(a, b)
            _eq(x, y)
        c = [torch.from_numpy(x) + (0 if r is None else rr) for x, rr in
             zip(d, r if r is not None else [None] * len(d))]
        for a, x, cc in zip(p, r_new, c):
            assert torch.equal(a + x, cc)
        r = r_new
    tc = pt_config.TrainConfig(outer_comm=pt_config.OuterCommConfig(
        compression="quantize", bits=bits, block=block))
    p2, _ = PO.compress_delta([torch.from_numpy(x) for x in d], None, tc)
    pj2, _ = JO.compress_delta([jnp.asarray(x) for x in d], None, bits=bits, block=block)
    for a, b in zip(p2, pj2):
        _eq(a, b)


# strategy configs: (id, OuterCommConfig kwargs, G, P)
STRATS = [
    ("quantize_g2", {"compression": "quantize"}, 2, 1),
    ("quantize_int4_b64_g2", {"compression": "quantize", "bits": 4, "block": 64}, 2, 1),
    ("quantize_g4", {"compression": "quantize"}, 4, 1),
    ("int8wire_g2", {"compression": "int8-wire"}, 2, 1),
    ("int4wire_g3", {"compression": "int8-wire", "bits": 4, "block": 32}, 3, 1),
    ("rsag_g1", {"compression": "rs-ag"}, 1, 1),
    ("rsag_g2", {"compression": "rs-ag"}, 2, 1),
    ("rsag_int4_g3", {"compression": "rs-ag", "bits": 4, "block": 32}, 3, 1),
    ("hier_quantize_g4p2", {"compression": "quantize", "hierarchical": True}, 4, 2),
    ("hier_int8wire_g4p2", {"compression": "int8-wire", "hierarchical": True}, 4, 2),
    ("chunked2_quantize_g2", {"compression": "quantize", "chunks": 2}, 2, 1),
]
# where the payload is a mean of more than two terms, XLA and torch may
# associate the sum differently: within 8 fp32 ulps of the leaf's scale
# (as tests/test_torch_outer.py:test_flat_fp32_sim_dispatch_vs_reference)
ASSOCIATES = {"quantize_g4", "hier_quantize_g4p2"}


def _strategies(comm):
    return (resolve_strategy(pt_config.OuterCommConfig(**comm)),
            jax_resolve(jax_config.OuterCommConfig(**comm)))


def _assert_payload(sid, got, want):
    if sid in ASSOCIATES:
        scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=8 * EPS * scale)
    else:
        _eq(got, want)


def _residual_pairs(strat, r, rj):
    if strat.needs_residual2:
        return list(zip(r[0] + r[1], list(rj[0]) + list(rj[1])))
    return list(zip(r, rj))


@pytest.mark.parametrize("sid,comm,G,P", STRATS, ids=[s[0] for s in STRATS])
def test_sim_reduce_matches_reference(sid, comm, G, P):
    """Two rounds of each strategy's reduction, the new residuals carried:
    the payload bit for bit (or within 8 ulps where a mean of more than two
    terms may associate differently) and the residuals bit for bit."""
    strat, jstrat = _strategies(comm)
    assert strat.name == jstrat.name
    rng = np.random.default_rng(G * 7 + len(sid))
    zeros = [np.zeros((G, *s), np.float32) for s in SHAPES]
    r = [torch.from_numpy(z) for z in zeros]
    rj = [jnp.asarray(z) for z in zeros]
    if strat.needs_residual2:
        r, rj = (r, [x.clone() for x in r]), (rj, list(rj))
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    for _ in range(2):
        d = [np.stack(x) for x in zip(*[_leaves(rng) for _ in range(G)])]
        p, r = strat.sim_reduce([torch.from_numpy(x) for x in d], r, tc, num_pods=P)
        pj, rj = jstrat.sim_reduce([jnp.asarray(x) for x in d], rj, jtc, num_pods=P)
        for a, b in zip(p, pj):
            _assert_payload(sid, a, b)
        for a, b in _residual_pairs(strat, r, rj):
            _eq(a, b)


@pytest.mark.parametrize("sid,comm,G,P", [s for s in STRATS if s[0] in (
    "quantize_g2", "int8wire_g2", "rsag_g2", "hier_int8wire_g4p2")],
    ids=["quantize_g2", "int8wire_g2", "rsag_g2", "hier_int8wire_g4p2"])
def test_sim_dispatch_matches_reference(sid, comm, G, P):
    """Per-group Δθ = θ_g − anchor, the reduction, the outer update: the
    target, momentum and residuals bit for bit; with ``inplace`` the new
    residuals are written over the old tensors."""
    strat, jstrat = _strategies(comm)
    rng = np.random.default_rng(G + 100)
    groups = [_leaves(rng, scale=1.0) for _ in range(G)]
    anchor = _leaves(rng, scale=1.0)
    mom = _leaves(rng)
    jtc, tc = jax_config.TrainConfig(), pt_config.TrainConfig()
    jstate = JO.outer_init([jnp.asarray(a) for a in anchor], jtc, num_groups=G,
                           needs_residual=True, needs_residual2=strat.needs_residual2)
    jstate = jstate._replace(momentum=[jnp.asarray(m) for m in mom])
    state = PO.outer_init([torch.from_numpy(a) for a in anchor], tc, num_groups=G,
                          needs_residual=True, needs_residual2=strat.needs_residual2)
    state = state._replace(momentum=[torch.from_numpy(m.copy()) for m in mom])
    for _ in range(2):
        stacked = [jnp.stack([jnp.asarray(g[i]) for g in groups]) for i in range(len(SHAPES))]
        jt, jstate = jstrat.sim_dispatch(stacked, jstate, jtc, mu=jnp.float32(0.9),
                                         lr=jnp.float32(0.7), num_pods=P)
        old = state.residual
        t, state = strat.sim_dispatch([[torch.from_numpy(x) for x in g] for g in groups],
                                      state, tc, mu=0.9, lr=0.7, num_pods=P, inplace=True)
        assert all(a is b for a, b in zip(state.residual, old))
        for a, b in zip(t + state.momentum + state.residual,
                        list(jt) + list(jstate.momentum) + list(jstate.residual)):
            _eq(a, b)
        if strat.needs_residual2:
            for a, b in zip(state.residual2, jstate.residual2):
                _eq(a, b)
        groups = [[x + (rng.standard_normal(x.shape) * 1e-3).astype(np.float32) for x in g]
                  for g in groups]
    assert state.num_syncs == 2
    # all-ones weights: the target, momentum and residuals bit for bit those
    # of the fixed mean (G is 2 or 4 here, where 1/G is exact)
    leaves = [[torch.from_numpy(x) for x in g] for g in groups]
    fixed = strat.sim_dispatch(leaves, state, tc, mu=0.9, lr=0.7, num_pods=P)
    ones = strat.sim_dispatch(leaves, state, tc, mu=0.9, lr=0.7, num_pods=P,
                              weights=np.ones(G))
    for a, b in zip(fixed[0] + fixed[1].momentum + fixed[1].residual,
                    ones[0] + ones[1].momentum + ones[1].residual):
        assert torch.equal(a, b)


def test_combinators_refuse_rs_ag_as_the_reference_does():
    for cls, jcls in ((Hierarchical, JS.Hierarchical), (Chunked, JS.Chunked)):
        with pytest.raises(ValueError):
            jcls(inner=JS.Int8Wire(reduce_scatter=True))
        with pytest.raises(ValueError):
            cls(inner=Int8Wire(reduce_scatter=True))
    rs = Int8Wire(reduce_scatter=True)
    d = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        rs.sim_reduce_leaf(d, None, None, pod_grouped=True)


# ===========================================================================
# SimulatedRun against the reference simulator
# ===========================================================================

MC_KW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)
# Measured on the CPU over these four runs: every step's loss within
# 4.8e-7, the final parameters within 2.8e-5, momentum within 1.3e-5 and
# the residuals within 1.5e-5. The inner steps differ by summation order
# (XLA's against torch's), and the reference jits its dispatch, where XLA
# may contract ``c − q·s`` into a fused multiply-add: a Δθ one ulp apart
# can round to the neighbouring int8 value, which moves that element's
# payload, and its residual, by one quantization step (about 1.4e-5 here,
# twice the largest residual). So the run is held to a tolerance, not to
# bits: the loss to 1e-5, the state to about three quantization steps.
LOSS_TOL, STATE_TOL = 1e-5, 5e-5

RUNS = [("quantize_d0", {"compression": "quantize"}, 0),
        ("quantize_d1", {"compression": "quantize"}, 1),
        ("int8wire_d0", {"compression": "int8-wire"}, 0),
        ("rsag_d0", {"compression": "rs-ag"}, 0)]


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("rid,comm,delay", RUNS, ids=[r[0] for r in RUNS])
def test_simulated_run_matches_reference(rid, comm, delay):
    """12 steps, G = 2: lazy start, two warmup accumulates, the switch to
    groups and four compressed outer syncs, the same batches fed to both."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, MC_KW["vocab_size"], (4, 17)).astype(np.int32)
               for _ in range(12)]
    jtc = jax_config.TrainConfig(**TC_KW, sync_delay=delay,
                                 outer_comm=jax_config.OuterCommConfig(**comm))
    tc = pt_config.TrainConfig(**TC_KW, sync_delay=delay,
                               outer_comm=pt_config.OuterCommConfig(**comm))
    jr = JaxRun(jax_config.ModelConfig(**MC_KW), jtc, num_groups=2, seed=0)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr = SimulatedRun(pt_config.ModelConfig(**MC_KW), tc, num_groups=2, device="cpu",
                      params=params_from_jax(tree, pt_config.ModelConfig(**MC_KW),
                                             device="cpu", training=True))
    pr._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                  "labels": torch.from_numpy(batches[s][:, 1:])}
    assert pr.strategy.name == jr.strategy.name and pr.plan.needs_residual
    jh, ph = jr.run(12), pr.run(12)
    jr.flush()
    pr.flush()
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=0, atol=LOSS_TOL)
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs) == 6
    pairs = list(zip([t.detach() for _, t in param_leaves(pr.eval_params())],
                     _np_leaves(jr.eval_params())))
    pairs += list(zip(pr.state.outer.momentum, _np_leaves(jr.state.outer.momentum)))
    pairs += list(zip(pr.state.outer.residual, _np_leaves(jr.state.outer.residual)))
    if comm["compression"] == "rs-ag":
        pairs += list(zip(pr.state.outer.residual2, _np_leaves(jr.state.outer.residual2)))
    else:
        assert pr.state.outer.residual2 is None
    for t, x in pairs:
        assert tuple(t.shape) == x.shape
        assert np.abs(t.numpy() - x).max() <= STATE_TOL
    # the residual is live: quantization dropped something
    assert max(float(r.abs().max()) for r in pr.state.outer.residual) > 0
