"""The tensor-core route of the port's flash attention, on the CPU.

The tensor-core kernels (``csrc/flash_attention_tc.cu``,
``csrc/flash_attention_tc256.cu``, ``csrc/flash_attention_bwd_tc.cu``) run
only on the card, where ``chip_smoke.py`` holds them against their plain
versions. Here: which entry point a CUDA forward and backward take for
each dtype and head_dim (the library replaced by a recorder), that every C
entry point has a ``ctypes`` signature row with its arguments' types, and
that the tensor-core forwards' arithmetic keeps the output within the
card's bf16 bounds of the reference's Pallas kernel: at head_dim 64, 112
and 128 P enters P V as three bf16 terms (closer to the reference than P
rounded once to bf16, as FlashAttention-style kernels do), at 112 on a
tile zero-padded to 128 columns with the scale of 112; at head_dim 256 P
is rounded once and O rescaled, then accumulated.
"""

import ctypes
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

# chip_smoke.py's bounds for bf16 attention (BF16_MAX_REL's forward use is
# absolute at unit-scale outputs; LSE_TOL is absolute)
BF16_FWD_MAX_ABS, BF16_RMS_REL, LSE_TOL = 2e-2, 1e-2, 1e-4


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


@pytest.mark.parametrize("dtype,hd,tc,tc_bwd", [
    pytest.param("bfloat16", 64, True, True, id="bfloat16-64-True"),     # GPT-2
    pytest.param("bfloat16", 128, True, True, id="bfloat16-128-True"),   # Qwen3
    pytest.param("float32", 64, False, False, id="float32-64-False"),
    pytest.param("float32", 128, False, False, id="float32-128-False"),
    pytest.param("bfloat16", 40, False, False, id="bfloat16-40-False"),
    # RecurrentGemma-9B: the forward on the tensor cores, the backward not
    pytest.param("bfloat16", 256, True, False, id="bfloat16-256-fwd-True-bwd-False"),
    # Kimi-K2: the same (no model trains at hd 112)
    pytest.param("bfloat16", 112, True, False, id="bfloat16-112"),
])
def test_route_follows_dtype_and_head_dim(monkeypatch, dtype, hd, tc, tc_bwd):
    """The forward of bf16 at hd 64, 112, 128 or 256 launches the
    tensor-core entry point, the backward of bf16 at hd 64 or 128 the
    tensor-core one; anything else the CUDA-core ones, with the argument
    count of their signature rows. Every launch moves ``launches`` /
    ``bwd_launches``, tensor-core ones ``tc_launches`` / ``tc_bwd_launches``
    too, and the hd-112 and hd-256 forwards ``tc112_launches`` and
    ``tc256_launches``."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name in ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches",
                 "tc112_launches", "tc256_launches"):
        monkeypatch.setattr(FK, name, 0)
    dt = getattr(torch, dtype)
    B, S, H, Hkv = 2, 33, 4, 2
    q = torch.zeros((B, S, H, hd), dtype=dt)
    k, v = torch.zeros((B, S, Hkv, hd), dtype=dt), torch.zeros((B, S, Hkv, hd), dtype=dt)
    assert FK.tensor_core_route(q) is tc and FK.tensor_core_bwd_route(q) is tc_bwd
    out, lse = FK._launch_fwd(q, k, v, True, 0, 0.0, want_lse=True)
    FK._launch_bwd(q, k, v, out, lse, torch.zeros_like(q), True, 0, 0.0)

    assert [c[0] for c in rec.calls] == [
        "flash_attention_fwd" + ("_tc_launch" if tc else "_launch"),
        "flash_attention_bwd" + ("_tc_launch" if tc_bwd else "_launch")]
    for name, args in rec.calls:
        assert len(args) == len(_build.SIGNATURES[name])
    (_, fwd), (_, bwd) = rec.calls
    shape = [B, S, H, Hkv, hd]
    code = _build.DTYPE_CODES[dt]
    # the tensor-core entry points take bf16 only, so no dtype code; their
    # backward does not read the output
    assert list(fwd[5:10] if tc else fwd[5:11]) == (shape if tc else [code, *shape])
    assert list(bwd[9:14] if tc_bwd else bwd[10:16]) == (shape if tc_bwd else [code, *shape])
    # scale, then the card's index and the stream
    assert fwd[-3] == bwd[-3] == pytest.approx(1.0 / math.sqrt(hd))
    assert fwd[-2] == bwd[-2] == 0
    assert (FK.launches, FK.bwd_launches, FK.tc_launches, FK.tc_bwd_launches,
            FK.tc112_launches, FK.tc256_launches) == (
        1, 1, int(tc), int(tc_bwd), int(tc and hd == 112), int(tc and hd == 256))


def _c_entries():
    """Every ``extern "C" int`` function of the sources: name -> types."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params = [" ".join(p.split()) for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = [re.match(r"(.*?)\s*\w+$", p).group(1) for p in params]
    return out


def _ctype(c_type: str):
    if c_type.count("*") == 2:  # void**, const void* const*
        return ctypes.POINTER(ctypes.c_void_p)
    if "*" in c_type:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "unsigned long long": ctypes.c_ulonglong}[c_type]


def test_every_c_entry_point_has_its_signature_row():
    """A static parse of csrc/*.cu: each entry point has a SIGNATURES row
    with as many arguments of the same types. A missing row would let
    ctypes pass a pointer as a 32-bit int."""
    entries = _c_entries()
    assert "flash_attention_fwd_tc_launch" in entries
    assert "flash_attention_bwd_tc_launch" in entries
    assert set(entries) == set(_build.SIGNATURES)
    for name, types in entries.items():
        assert [_ctype(t) for t in types] == list(_build.SIGNATURES[name]), name


def test_every_launch_entry_point_binds_the_thread_to_its_card():
    """A static parse of csrc/*.cu: every ``*_launch`` entry point takes
    ``int device`` just before its stream and calls ``cudaSetDevice(device)``
    before anything else, so a thread with no current context (autograd's,
    or a rank's on a card other than 0) launches on the tensors' card."""
    launches = 0
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+_launch)\(([^)]*)\)\s*\{', text):
            launches += 1
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            assert params[-2:] == ["int device", "void* stream"], m.group(1)
            body = text[m.end():].lstrip()
            first = body.split(";")[0]
            assert "cudaSetDevice(device)" in first, (m.group(1), first)
    assert launches == len([n for n in _build.SIGNATURES if n.endswith("_launch")]) == 13


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tc_forward(q, k, v, *, causal, block_k, window=0, split=True, scale=None):
    """The tensor-core forwards' arithmetic in plain PyTorch: fp32 scores of
    the bf16 inputs times ``scale`` (1 / sqrt(hd) of the inputs' width by
    default), masked causally and to ``window``; an online softmax over
    ``block_k``-key tiles in the log2 domain. With ``split`` (hd 64 and
    128, ``flash_attention_tc.cu``) P enters P V as hi = bf16(P), mid =
    bf16(P - hi) and lo = bf16(P - hi - mid), and each tile's P V, summed
    apart, is added to the rescaled O in fp32; without it (hd 256,
    ``flash_attention_tc256.cu``) P is rounded once to bf16, O is rescaled
    and then P V accumulated onto it. O / l rounded to bf16, l and the
    log-sum-exp from the fp32 P. -> (out bf16, lse fp32 (B,H,S))."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    neg = -1e30
    m = torch.full((B, H, S), neg)
    l_sum = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        x = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * (scale * math.log2(math.e))
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        visible = (kpos <= qpos) | (not causal)
        if window > 0:
            visible = visible & (qpos - kpos < window)
        x = torch.where(visible, x, torch.full_like(x, neg))
        mx = torch.maximum(m, x.amax(-1))
        base = torch.where(mx == neg, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        if split:
            terms = [_bf16(p)]
            terms.append(_bf16(p - terms[0]))
            terms.append(_bf16(p - terms[0] - terms[1]))
            pv = sum(torch.einsum("bhqk,bkhd->bhqd", t, vt) for t in terms)
            acc = acc * alpha[..., None] + pv
        else:
            acc = acc * alpha[..., None]
            acc += torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vt)
        m = mx
    l_sum = l_sum.clamp_min(1e-30)
    out = (acc / l_sum[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, (m + torch.log2(l_sum)) * math.log(2.0)


def _tile_forward(q, k, v, **kw):
    """``_tc_forward`` as the kernel runs it: on q, k, v zero-padded to the
    tile width (head_dim rounded up to 64: 128 at hd 112, where TMA reads
    the columns past the tensor as zeros) with the scale of the real
    head_dim, its output cut back to that head_dim. -> (out, lse, the
    padding's output columns)."""
    hd = q.shape[-1]
    pad = -(-hd // 64) * 64 - hd
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    out, lse = _tc_forward(q, k, v, scale=1.0 / math.sqrt(hd), **kw)
    return out[..., :hd], lse, out[..., hd:]


@pytest.mark.parametrize("H,Hkv,hd,block_k,S,window", [
    # GPT-2 XL's heads; the kernel's key tile at hd 64
    pytest.param(25, 25, 64, 128, 128, 0, id="25-25-64-128"),
    # Qwen3-1.7B's; at hd 128
    pytest.param(16, 8, 128, 64, 128, 0, id="16-8-128-64"),
    # hd 256 (flash_attention_tc256.cu, key tile 64): RecurrentGemma-9B's
    # MQA 16:1; a window of 64 keys across tiles; GQA 2:1 at a ragged S
    pytest.param(16, 1, 256, 64, 128, 0, id="mqa16-hd256-s128"),
    pytest.param(4, 1, 256, 64, 200, 64, id="window64-hd256-s200"),
    pytest.param(4, 2, 256, 64, 77, 0, id="gqa2-hd256-s77"),
    # hd 112 (the hd-128 instance on a padded tile, key tile 64): Kimi-K2's
    # GQA 8:1; at a ragged S with a window of 64 keys across tiles
    pytest.param(64, 8, 112, 64, 128, 0, id="kimi-gqa8-hd112-s128"),
    pytest.param(64, 8, 112, 64, 77, 64, id="kimi-gqa8-hd112-s77-window64"),
])
def test_bf16_p_rounding_fits_the_card_bounds(H, Hkv, hd, block_k, S, window):
    """On the same numpy-seeded bf16 inputs (B 1, causal), the tensor-core
    forward's arithmetic at ``hd`` stays within chip_smoke.py's bf16 bounds
    of the reference's Pallas kernel (interpret mode, fp32), and its
    log-sum-exp within LSE_TOL of the port's plain version. At hd 64, 112
    and 128 its three-term P is also closer to the reference than P rounded
    once, which is the hd-256 kernel's arithmetic. At hd 112 it runs on the
    padded tile, whose padding's output columns are exactly 0."""
    rng = np.random.default_rng(hd + H)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, hd)).astype(np.float32))
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    ref = np.asarray(jax_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                               causal=True, window=window, interpret=True))
    split = hd != 256
    opts = dict(causal=True, block_k=block_k, window=window)
    out, lse, padding = _tile_forward(q, k, v, split=split, **opts)
    assert out.shape == q.shape and not padding.any()
    err = np.abs(out.float().numpy() - ref)
    rms = np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref)
    assert err.max() <= BF16_FWD_MAX_ABS and rms <= BF16_RMS_REL
    if split:
        once, _, _ = _tile_forward(q, k, v, split=False, **opts)
        rms_once = np.linalg.norm(once.float().numpy() - ref) / np.linalg.norm(ref)
        assert rms < rms_once
    _, lse_ref = R.flash_attention_fwd_ref(q.float(), k.float(), v.float(), causal=True,
                                           window=window)
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL
