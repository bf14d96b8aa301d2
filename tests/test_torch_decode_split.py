"""The split-context decode kernel and the RMSNorm backward's order, on the CPU.

The CUDA kernels (``csrc/decode_attention.cu``, ``csrc/rmsnorm.cu``) run only
on the card, where ``chip_smoke.py`` holds them against their plain
versions. Here their arithmetic runs in plain PyTorch, in the kernels'
order, against the reference package:

- the paged decode split over the context: per-split (m, l, acc) over the
  spans of the wrapper's own :func:`split_size`, merged in split order,
  against the reference's Pallas kernel in interpret mode;
- the wrapper's split count and workspace come from the table's capacity
  alone: it reads neither ``context_lens`` nor ``block_tables``;
- the RMSNorm backward's dscale, summed in the kernels' two-level fixed
  order, against ``jax.vjp`` of the reference norm; its grid is a function
  of (rows, D).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import rmsnorm as RK  # noqa: E402

NEG_INF = -1e30
# chip_smoke.py's bound on dscale: within 1e-5 of its largest |value|
RMS_DSCALE_REL = 1e-5


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _build.SIGNATURES:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


# ===========================================================================
# paged decode, split over the context
# ===========================================================================


def _inputs(seed, *, H, Hkv, hd, bs, T, cls, quantized=False):
    """numpy q, pools, tables (distinct shuffled blocks, -1 past the
    context) and context lengths; int8 pools with positive row scales."""
    rng = np.random.default_rng(seed)
    B = len(cls)
    need = [-(-c // bs) for c in cls]
    N = sum(need) + 2
    perm = rng.permutation(np.arange(1, N))
    tables = np.full((B, T), -1, np.int32)
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used:used + n]
        used += n
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    if quantized:
        kp = rng.integers(-127, 128, (N, bs, Hkv, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (N, bs, Hkv, hd)).astype(np.int8)
        ks = (rng.random((N, bs, Hkv)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((N, bs, Hkv)) * 0.02 + 0.001).astype(np.float32)
        return q, kp, vp, tables, np.asarray(cls, np.int32), ks, vs
    kp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(cls, np.int32), None, None


def _live_splits(cl, window, T, bs, span):
    """The splits the merge kernel reads: [s_lo, s_hi), as it computes them."""
    lo = max(0, cl - window) if window > 0 else 0
    hi = min(cl, T * bs)
    s_lo = lo // span
    return range(s_lo, -(-hi // span) if hi > lo else s_lo)


def _split_decode(q, kp, vp, tables, cls, ks, vs, *, window=0, softcap=0.0):
    """The split kernel's algebra in fp32: for every split of the
    wrapper's span, (m, l, acc) over its live positions; then the live
    splits merged in index order. -> (out (B, H, hd), [live split ids])."""
    q, kp, vp = (torch.from_numpy(a) for a in (q, kp, vp))
    B, H, hd = q.shape
    _, bs, Hkv, _ = kp.shape
    G, T = H // Hkv, tables.shape[1]
    span, S = DK.split_size(T, bs), DK.num_splits(T, bs)
    bt = torch.from_numpy(tables).long().clamp_min(0)
    k, v = kp[bt].float(), vp[bt].float()  # (B, T, bs, Hkv, hd)
    if ks is not None:
        k = k * torch.from_numpy(ks)[bt][..., None]
        v = v * torch.from_numpy(vs)[bt][..., None]
    k, v = k.reshape(B, T * bs, Hkv, hd), v.reshape(B, T * bs, Hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(B, Hkv, G, hd), k) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    out = torch.zeros((B, Hkv, G, hd))
    live_ids = []
    for b in range(B):
        cl = int(cls[b])
        lo = max(0, cl - window) if window > 0 else 0
        hi = min(cl, T * bs)
        parts = []
        for split in range(S):
            a, e = max(split * span, lo), min(hi, (split + 1) * span)
            if a >= e:
                continue
            sb = s[b, ..., a:e]  # (Hkv, G, n)
            m = sb.amax(-1)
            p = torch.exp(sb - m[..., None])
            parts.append((split, m, p.sum(-1), torch.einsum("hgk,khd->hgd", p, v[b, a:e])))
        live_ids.append([p[0] for p in parts])
        assert live_ids[-1] == list(_live_splits(cl, window, T, bs, span))
        if not parts:
            continue
        mx = torch.stack([p[1] for p in parts]).amax(0)
        lsum, acc = torch.zeros_like(mx), torch.zeros((Hkv, G, hd))
        for _, m, l_s, acc_s in parts:  # split order
            w = torch.exp(m - mx)
            lsum = lsum + l_s * w
            acc = acc + acc_s * w[..., None]
        out[b] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd), live_ids


def _jax(args, *, window=0, softcap=0.0):
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    return np.asarray(jax_paged_decode(*jargs, window=window, softcap=softcap,
                                       interpret=True))


# name, H, Hkv, hd, bs, T, context lengths, window, softcap, int8 pools
DECODE_CASES = [
    ("gpt2_xl_heads", 25, 25, 64, 16, 12, [150, 37], 0, 0.0, False),
    ("qwen3_heads", 16, 8, 128, 16, 10, [130, 64], 0, 0.0, False),
    ("ends_on_split_boundaries", 4, 2, 32, 16, 12, [128, 64, 192], 0, 0.0, False),
    ("window_cuts_a_split", 4, 2, 32, 16, 12, [150, 100], 40, 0.0, False),
    ("splits_wholly_masked", 4, 2, 32, 8, 40, [190, 250], 30, 0.0, False),
    ("empty_slots", 4, 4, 32, 16, 8, [0, 70, 0, 5], 0, 0.0, False),
    ("softcap", 4, 2, 32, 16, 12, [170, 33], 0, 30.0, False),
    ("int8_pools", 16, 8, 128, 16, 10, [140, 9], 0, 0.0, True),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_split_decode_vs_pallas(case):
    """The split-and-merge algebra at every case's capacity (2 to 5 splits
    of 64) against the Pallas kernel, fp32, within 1e-5."""
    name, H, Hkv, hd, bs, T, cls, window, softcap, quantized = case
    args = _inputs(len(name), H=H, Hkv=Hkv, hd=hd, bs=bs, T=T, cls=cls,
                   quantized=quantized)
    out, live = _split_decode(*args, window=window, softcap=softcap)
    ref = _jax(args, window=window, softcap=softcap)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-5
    assert DK.num_splits(T, bs) >= 2
    for b, cl in enumerate(cls):
        if cl == 0:
            assert live[b] == [] and np.abs(out[b].numpy()).max() == 0.0
    if name == "splits_wholly_masked":  # windows past split 0; capacity past cl
        assert all(ids and ids[0] > 0 and ids[-1] < DK.num_splits(T, bs) - 1
                   for ids in live)
    if name == "ends_on_split_boundaries":
        assert live == [[0, 1], [0], [0, 1, 2]]


def test_split_count_comes_from_the_table_capacity_alone():
    """``split_size`` / ``num_splits`` take (T, bs): spans of 64 until a
    table would need more than 16 splits, then doubled up to 1024."""
    assert (DK.split_size(34, 16), DK.num_splits(34, 16)) == (64, 9)
    assert (DK.split_size(64, 16), DK.num_splits(64, 16)) == (64, 16)
    assert (DK.split_size(256, 16), DK.num_splits(256, 16)) == (256, 16)
    assert (DK.split_size(257, 16), DK.num_splits(257, 16)) == (512, 9)
    assert (DK.split_size(1, 7), DK.num_splits(1, 7)) == (64, 1)
    assert DK.split_size(1 << 20, 16) == DK.MAX_SPAN
    for T, bs in [(3, 16), (34, 16), (64, 16), (512, 16), (100, 7)]:
        span = DK.split_size(T, bs)
        assert span % 32 == 0 and DK.MIN_SPAN <= span <= DK.MAX_SPAN
        assert DK.num_splits(T, bs) == -(-T * bs // span)


def test_wrapper_reads_no_context_length_or_table(monkeypatch):
    """The launch takes its span and workspace from shapes: on meta tensors,
    whose values cannot be read, it launches, and two launches with other
    context lengths pass the same span and a workspace of the same size."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    shapes = []
    empty = torch.empty

    def recording_empty(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 else size)
        return empty(*size, **kw)

    B, H, Hkv, hd, bs, T = 4, 16, 8, 128, 16, 34
    for dev, cls in (("meta", None), ("cpu", [100, 250, 400, 544]), ("cpu", [1, 0, 0, 2])):
        q = torch.zeros((B, H, hd), device=dev, dtype=torch.bfloat16)
        pool = torch.zeros((9, bs, Hkv, hd), device=dev, dtype=torch.bfloat16)
        bt = torch.zeros((B, T), device=dev, dtype=torch.int32)
        cl = (torch.zeros((B,), device=dev, dtype=torch.int32) if cls is None
              else torch.tensor(cls, dtype=torch.int32))
        DK._check(q, pool, pool, bt, cl, None, None)
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", recording_empty)
            DK._launch(q, pool, pool, bt, cl, None, None, 0, 0.0)
    args = [c[1] for c in rec.calls]
    assert [c[0] for c in rec.calls] == ["paged_decode_attention_launch"] * 3
    assert all(len(a) == len(_build.SIGNATURES["paged_decode_attention_launch"]) for a in args)
    span_at = 17  # q..partial (9), dtypes (2), B H Hkv hd bs T (6), then the span
    assert {a[span_at] for a in args} == {DK.split_size(T, bs)} == {64}
    assert {a[9 + 2:9 + 2 + 6] for a in args} == {(B, H, Hkv, hd, bs, T)}
    assert shapes == [(B, Hkv, DK.num_splits(T, bs), H // Hkv, hd + 2)] * 3


# ===========================================================================
# RMSNorm backward: dscale in the kernels' order
# ===========================================================================

COL_RUNS = 16  # csrc/rmsnorm.cu: kColRuns


def _bwd_warps(vpl):  # csrc/rmsnorm.cu: BwdShape<VPL>::kWarps
    return 64 // max(vpl, 4)


def _dscale_in_kernel_order(x, g, r, vec):
    """dscale = sum over rows of g x r, added as the register-path backward
    and the column sum add it, for rows loaded ``vec`` values a lane (8 for
    bf16, 4 for fp32): block b takes rows b, b + nblocks, ...; each of
    its row groups adds its rows in turn; the groups of a warp add in an xor
    tree, the warps in a halving tree; then sixteen warps a column add
    contiguous runs of the blocks' rows, and the runs add in order. fp32."""
    rows, D = x.shape
    nvec = D // vec
    assert nvec <= 256, "the register path"
    lpr = min(32, 1 << max(0, (nvec - 1).bit_length()))
    vpl = 1 << max(0, (-(-nvec // 32) - 1).bit_length())
    warps = _bwd_warps(vpl)
    rpw = 32 // lpr
    ng = warps * rpw
    nblocks = RK.bwd_blocks(rows, D)
    contrib = (g * x) * r[:, None]  # each row's g x r, fp32
    partial = []
    for blk in range(nblocks):
        mine = list(range(blk, rows, nblocks))  # local row l is row l * nblocks + blk
        groups = []
        for grp in range(ng):
            acc = torch.zeros(D)
            for row in mine[grp::ng]:
                acc = acc + contrib[row]
            groups.append(acc)
        sums = []
        for w in range(warps):
            v = groups[w * rpw:(w + 1) * rpw]
            off = 1
            while off < rpw:
                v = [v[i] + v[i ^ off] for i in range(rpw)]
                off *= 2
            sums.append(v[0])
        half = warps // 2
        while half:
            sums = [sums[i] + sums[i + half] if i < half else sums[i]
                    for i in range(len(sums))]
            half //= 2
        partial.append(sums[0])
    per = -(-nblocks // COL_RUNS)
    dscale = torch.zeros(D)
    for run in range(COL_RUNS):
        t = torch.zeros(D)
        for blk in range(run * per, min(nblocks, (run + 1) * per)):
            t = t + partial[blk]
        dscale = dscale + t
    return dscale, nblocks


@pytest.mark.parametrize("rows,D,vec", [
    (2048, 128, 8),   # qk-norm rows in bf16: 16 lanes a row, two rows a warp
    (96, 2048, 8),    # block-norm rows in bf16: a warp a row, 8 vectors a lane
    (333, 128, 4),    # fp32: a warp a row, ragged runs of rows
    (37, 40, 4),      # 10 vectors: 16 lanes, one block
])
def test_rmsnorm_bwd_dscale_order_vs_jax_vjp(rows, D, vec):
    """The backward's two-level dscale order in fp32 against ``jax.vjp`` of
    the reference's ``rmsnorm_ref``, within chip_smoke.py's dscale bound."""
    rng = np.random.default_rng(rows + D)
    x = (rng.standard_normal((rows, D)) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((rows, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: JREF.rmsnorm_ref(a, b, eps=1e-6),
                     jnp.asarray(x), jnp.asarray(s))
    _, jds = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x)
    r = torch.rsqrt(xt.square().mean(-1) + 1e-6)
    ds, nblocks = _dscale_in_kernel_order(xt, torch.from_numpy(g), r, vec)
    assert nblocks == RK.bwd_blocks(rows, D) >= 1
    assert np.abs(ds.numpy() - jds).max() <= RMS_DSCALE_REL * np.abs(jds).max()


def test_rmsnorm_bwd_grid_depends_on_rows_and_D_only(monkeypatch):
    """One block per 16384 elements, at most one an SM (132): the grid and
    the workspace it sizes are the same for any dtype and any values."""
    assert RK.bwd_blocks(2048, 2048) == RK.bwd_blocks(32768, 128) == 132
    assert RK.bwd_blocks(1, 2048) == RK.bwd_blocks(37, 40) == 1
    assert RK.bwd_blocks(1024, 128) == 8
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for scale_by in (1.0, 100.0):
            x = (torch.from_numpy(rng.standard_normal((96, 2048)).astype(np.float32))
                 * scale_by).to(dt)
            rstd = torch.ones(96)
            RK._launch_bwd(x, torch.ones(2048), rstd, torch.ones_like(x))
    nblocks_at = 10  # x scale dy rstd dx dscale partial (7), dtype, rows, D, then nblocks
    got = {(a[nblocks_at - 2], a[nblocks_at - 1], a[nblocks_at]) for _, a in rec.calls}
    assert got == {(96, 2048, RK.bwd_blocks(96, 2048))} == {(96, 2048, 12)}
    assert all(a[-2] == 0 for _, a in rec.calls)  # the card's index, then the stream
