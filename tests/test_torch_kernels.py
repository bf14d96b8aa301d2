"""The PyTorch port's kernels on the CPU against the reference's Pallas kernels.

On a CPU tensor each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version; here that is held against the reference package's Pallas
kernel run in interpret mode, on the same numpy inputs. The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.quantize import quantize_blockwise as jax_quantize  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import pier_update as PK  # noqa: E402
from repro_torch.kernels import quantize as QK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402


def _bf16_np(x):
    """numpy fp32 values of x rounded to bf16 (as both frameworks round)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# ===========================================================================
# blockwise quantize: bit for bit
# ===========================================================================


@pytest.mark.parametrize("n,block,bits,dtype", [
    (64 * 37, 64, 8, "float32"),      # KV rows (block = head_dim)
    (1000, 64, 8, "float32"),         # ragged tail
    (256 * 9 + 17, 256, 8, "float32"),  # outer-wire block, ragged
    (256 * 5, 256, 4, "float32"),     # int4 in int8
    (64 * 20, 64, 8, "bfloat16"),     # bf16 KV written straight from the model
])
def test_quantize_bitwise_vs_pallas(n, block, bits, dtype):
    rng = np.random.default_rng(n + block + bits)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x[block:3 * block] = 0.0  # whole zero blocks: scale 0, values 0
    if dtype == "bfloat16":
        x = _bf16_np(x)
        qj, sj = jax_quantize(jnp.asarray(x, jnp.bfloat16), bits=bits,
                              block=block, interpret=True)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        qj, sj = jax_quantize(jnp.asarray(x), bits=bits, block=block,
                              interpret=True)
        xt = torch.from_numpy(x)
    before = QK.launches
    qt, st = QK.quantize_blockwise(xt, bits=bits, block=block)
    assert QK.launches == before  # a CPU tensor never counts as a launch
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    # the round trip stays within half a step of every block
    deq = R.dequantize_blockwise_ref(qt, st, block=block).numpy()[:n]
    step = np.repeat(st.numpy(), block)[:n]
    assert np.all(np.abs(deq - x) <= 0.5 * step + 1e-7)


def test_quantize_rejects_bad_input():
    with pytest.raises(ValueError):
        QK.quantize_blockwise(torch.zeros(4, 4))
    with pytest.raises(ValueError):
        QK.quantize_blockwise(torch.zeros(8), bits=3)
    with pytest.raises(ValueError):
        R.dequantize_blockwise_ref(torch.zeros(10, dtype=torch.int8),
                                   torch.zeros(1), block=8)


# ===========================================================================
# flash attention: fp32, <= 1e-5
# ===========================================================================


@pytest.mark.parametrize("S,H,Hkv,hd,causal,window,softcap", [
    (16, 4, 4, 32, True, 0, 0.0),
    (40, 4, 2, 64, True, 8, 0.0),      # GQA 2:1, window
    (128, 4, 1, 32, True, 0, 20.0),    # MQA, softcap
    (40, 2, 2, 64, False, 0, 0.0),     # bidirectional
    (128, 8, 2, 32, True, 32, 30.0),   # GQA 4:1, window + softcap
])
def test_flash_plain_vs_pallas(S, H, Hkv, hd, causal, window, softcap):
    rng = np.random.default_rng(S * 7 + H)
    q = rng.standard_normal((2, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, S, Hkv, hd)).astype(np.float32)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, softcap=softcap,
                    interpret=True)
    before = FK.launches
    out = kops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window, softcap=softcap)
    assert FK.launches == before
    assert out.shape == (2, S, H, hd) and out.dtype == torch.float32
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


def test_flash_rejects_layouts_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 12)  # head_dim not a multiple of 8
    with pytest.raises(ValueError):
        FK.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):  # 4 heads over 3 kv heads
        FK.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    q1 = torch.zeros(1, 1, 4, 16)  # S = 1 is taken (no TPU tiling limit)
    assert kops.flash_attention(q1, q1, q1).shape == (1, 1, 4, 16)


def test_wrappers_never_run_plain_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, which refuses what it cannot launch."""
    q = torch.zeros(1, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FK.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        QK.quantize_blockwise(torch.zeros(8, device="meta"))
    z = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PK.pier_update(z, z, z, 0.9, 1.0)
    qd = torch.zeros(2, 4, 16, device="meta")
    pool = torch.zeros(3, 4, 4, 16, device="meta")
    bt = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    cl = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        DK.paged_decode_attention(qd, pool, pool, bt, cl)


# ===========================================================================
# flash attention backward: the plain FA-2 algebra against jax.grad, and
# the CUDA path's autograd contract
# ===========================================================================

FLASH_BWD_CASES = [
    # B, S, H, Hkv, hd, causal, window, softcap
    (2, 40, 4, 2, 64, True, 0, 0.0),     # GQA 2:1
    (1, 33, 4, 1, 32, True, 0, 0.0),     # MQA, ragged S
    (1, 50, 2, 2, 40, True, 8, 0.0),     # window, hd 40
    (2, 29, 4, 2, 64, True, 0, 20.0),    # softcap
    (1, 24, 2, 2, 128, False, 0, 0.0),   # bidirectional, hd 128
    (3, 1, 2, 2, 64, True, 0, 0.0),      # S = 1
]


def _flash_bwd_inputs(B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd))]


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,softcap", FLASH_BWD_CASES)
def test_flash_backward_plain_vs_jax_grad(B, S, H, Hkv, hd, causal, window, softcap):
    """dQ, dK, dV within 2e-5 (fp32, other summation orders) of ``jax.vjp``
    through the reference's ``flash_attention_ref``, both for the plain
    backward kernel (``flash_attention_bwd_ref``, from the forward's lse)
    and for autograd through the CPU path."""
    from repro.kernels.ref import flash_attention_ref as jax_flash_ref

    q, k, v, do = _flash_bwd_inputs(B, S, H, Hkv, hd, S + hd)
    opts = dict(causal=causal, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, **opts),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = R.flash_attention_fwd_ref(qt, kt, vt, **opts)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    plain = R.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot, **opts)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    kops.flash_attention(qg, kg, vg, **opts).backward(dot)
    for got in (plain, (qg.grad, kg.grad, vg.grad)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert np.abs(g.numpy() - w).max() <= 2e-5


def test_flash_autograd_function_gives_q_k_v_gradients(monkeypatch):
    """On a CUDA tensor ``flash_attention`` is ``FlashAttentionFn``: its
    output carries a ``grad_fn`` and its backward returns dQ, dK and dV.
    Here the two kernel launches are replaced by their plain versions, so
    the contract (saved tensors, lse hand-off, gradient order) runs on the
    CPU; the kernels themselves are checked on the card by chip_smoke.py."""
    calls = []

    def fake_fwd(q, k, v, causal, window, softcap, want_lse):
        calls.append("fwd")
        out, lse = R.flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                             softcap=softcap)
        return out, (lse if want_lse else None)

    def fake_bwd(q, k, v, out, lse, dout, causal, window, softcap):
        calls.append("bwd")
        return R.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                         window=window, softcap=softcap)

    monkeypatch.setattr(FK, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(FK, "_launch_bwd", fake_bwd)
    q, k, v, do = _flash_bwd_inputs(2, 20, 4, 2, 32, 1)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FK.FlashAttentionFn.apply(*ts, True, 0, 0.0)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    assert calls == ["fwd", "bwd"]
    refs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    R.flash_attention_ref(*refs, causal=True).backward(torch.from_numpy(do))
    for t, r in zip(ts, refs):
        assert t.grad is not None and t.grad.shape == t.shape
        assert float((t.grad - r.grad).abs().max()) <= 1e-5


# ===========================================================================
# paged decode attention
# ===========================================================================

# the reference's KERNEL_SHAPES (tests/test_serving.py): B, H, Hkv, hd, N, bs, T
KERNEL_SHAPES = [
    (2, 4, 4, 64, 8, 16, 3),   # mha
    (3, 8, 2, 64, 8, 16, 3),   # gqa 4:1
    (2, 4, 1, 32, 6, 8, 4),    # mqa
]


def _paged_inputs(seed, B, H, Hkv, hd, N, bs, T, *, quantized=False):
    """numpy q, pools, tables and context lengths (distinct blocks per row);
    int8 pools come from the reference's quantize kernel."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    tables = np.full((B, T), -1, np.int32)
    cls = np.zeros((B,), np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for b in range(B):
        n_blk = min(int(rng.integers(1, T + 1)), len(perm) - used)
        tables[b, :n_blk] = perm[used:used + n_blk]
        used += n_blk
        cls[b] = int(rng.integers(1, n_blk * bs + 1))
    kf = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    vf = rng.standard_normal((N, bs, Hkv, hd)).astype(np.float32)
    if not quantized:
        return q, kf, vf, tables, cls, None, None

    def q8(x):
        qv, s = jax_quantize(jnp.asarray(x.reshape(-1)), bits=8, block=hd,
                             interpret=True)
        return (np.asarray(qv).reshape(x.shape),
                np.asarray(s).reshape(x.shape[:-1]))

    (kq, ks), (vq, vs) = q8(kf), q8(vf)
    return q, kq, vq, tables, cls, ks, vs


def _both(args, *, window=0, softcap=0.0, dtype="float32"):
    """(port output, reference output) as fp32 numpy arrays."""
    q, kp, vp, bt, cl, ks, vs = args
    if dtype == "bfloat16":
        q, kp, vp = _bf16_np(q), _bf16_np(kp), _bf16_np(vp)
        jq = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
        tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    else:
        jq = [jnp.asarray(a) for a in (q, kp, vp)]
        tq = [torch.from_numpy(a) for a in (q, kp, vp)]
    jrest = [jnp.asarray(a) if a is not None else None for a in (bt, cl, ks, vs)]
    trest = [torch.from_numpy(a) if a is not None else None for a in (bt, cl, ks, vs)]
    ref = jax_paged_decode(*jq, *jrest, window=window, softcap=softcap,
                           interpret=True)
    before = DK.launches
    out = kops.paged_decode_attention(*tq, *trest, window=window, softcap=softcap)
    assert DK.launches == before
    assert out.dtype == tq[0].dtype and out.shape == tuple(q.shape)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("B,H,Hkv,hd,N,bs,T", KERNEL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_vs_pallas(B, H, Hkv, hd, N, bs, T, dtype):
    out, ref = _both(_paged_inputs(B * 10 + H, B, H, Hkv, hd, N, bs, T),
                     dtype=dtype)
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5
    else:  # one bf16 rounding of the output apart, at most
        assert np.all(np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("window,softcap", [(6, 0.0), (0, 30.0), (6, 30.0)])
def test_decode_window_softcap_vs_pallas(window, softcap):
    out, ref = _both(_paged_inputs(3, 2, 4, 2, 32, 6, 8, 3),
                     window=window, softcap=softcap)
    assert np.abs(out - ref).max() <= 1e-5


def test_decode_int8_pools_vs_pallas():
    out, ref = _both(_paged_inputs(5, 2, 4, 2, 64, 6, 8, 3, quantized=True))
    assert np.abs(out - ref).max() <= 1e-5


def test_decode_empty_slot_gives_zeros():
    args = list(_paged_inputs(7, 2, 4, 2, 32, 6, 8, 3))
    args[4] = args[4].copy()
    args[4][1] = 0
    out, ref = _both(tuple(args))
    assert np.abs(out[1]).max() == 0.0 and np.abs(out[0]).max() > 0.0
    assert np.abs(out - ref).max() <= 1e-5


def test_decode_rejects_bad_input():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(3, 4, 2, 16)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    cl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # int8 pools without scales
        DK.paged_decode_attention(q, pool.to(torch.int8), pool.to(torch.int8), bt, cl)
    with pytest.raises(ValueError):  # 4 heads over 3 kv heads
        DK.paged_decode_attention(q, torch.zeros(3, 4, 3, 16),
                                  torch.zeros(3, 4, 3, 16), bt, cl)
    with pytest.raises(ValueError):  # table rows != batch
        DK.paged_decode_attention(q, pool, pool, bt[:1], cl)
    assert DK.paged_decode_supported(25, 25, 64) == (True, "")
    assert not DK.paged_decode_supported(8, 3, 64)[0]
    assert not DK.paged_decode_supported(8, 8, 512)[0]
