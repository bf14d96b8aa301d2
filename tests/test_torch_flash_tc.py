"""The tensor-core route of the port's flash attention, on the CPU.

The tensor-core kernels (``csrc/flash_attention_tc.cu``,
``csrc/flash_attention_bwd_tc.cu``) run only on the card, where
``chip_smoke.py`` holds them against their plain versions. Here: which
entry point a CUDA launch takes for each dtype and head_dim (the library
replaced by a recorder), that every C entry point has a ``ctypes``
signature row with its arguments' types, and that the tensor-core
forward's arithmetic, P entering P V as three bf16 terms, keeps its output
within the card's bf16 bounds of the reference's Pallas kernel (and closer
to it than P rounded once to bf16, as FlashAttention-style kernels do).
"""

import ctypes
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("dtype,hd,tc", [
    ("bfloat16", 64, True),     # GPT-2
    ("bfloat16", 128, True),    # Qwen3
    ("float32", 64, False),
    ("float32", 128, False),
    ("bfloat16", 40, False),
    ("bfloat16", 256, False),
])
def test_route_follows_dtype_and_head_dim(monkeypatch, dtype, hd, tc):
    """bf16 at hd 64 or 128 launches the tensor-core entry points, anything
    else the CUDA-core ones, with the argument count of their signature
    rows; every launch moves ``launches`` / ``bwd_launches``, tensor-core
    ones ``tc_launches`` / ``tc_bwd_launches`` too."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name in ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches"):
        monkeypatch.setattr(FK, name, 0)
    dt = getattr(torch, dtype)
    B, S, H, Hkv = 2, 33, 4, 2
    q = torch.zeros((B, S, H, hd), dtype=dt)
    k, v = torch.zeros((B, S, Hkv, hd), dtype=dt), torch.zeros((B, S, Hkv, hd), dtype=dt)
    assert FK.tensor_core_route(q) is tc
    out, lse = FK._launch_fwd(q, k, v, True, 0, 0.0, want_lse=True)
    FK._launch_bwd(q, k, v, out, lse, torch.zeros_like(q), True, 0, 0.0)

    suffix = "_tc_launch" if tc else "_launch"
    assert [c[0] for c in rec.calls] == [f"flash_attention_fwd{suffix}",
                                         f"flash_attention_bwd{suffix}"]
    for name, args in rec.calls:
        assert len(args) == len(_build.SIGNATURES[name])
    (_, fwd), (_, bwd) = rec.calls
    shape = [B, S, H, Hkv, hd]
    if tc:  # bf16 only, so no dtype code; the backward does not read the output
        assert list(fwd[5:10]) == shape and list(bwd[9:14]) == shape
    else:
        code = _build.DTYPE_CODES[dt]
        assert list(fwd[5:11]) == [code, *shape] and list(bwd[10:16]) == [code, *shape]
    # scale, then the card's index and the stream
    assert fwd[-3] == bwd[-3] == pytest.approx(1.0 / math.sqrt(hd))
    assert fwd[-2] == bwd[-2] == 0
    assert (FK.launches, FK.bwd_launches, FK.tc_launches, FK.tc_bwd_launches) == (
        1, 1, int(tc), int(tc))


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


def _tc_forward(q, k, v, *, causal, block_k, split=True):
    """The tensor-core forward's arithmetic in plain PyTorch: fp32 scores of
    the bf16 inputs; an online softmax over ``block_k``-key tiles in the
    log2 domain; P into P V as hi = bf16(P), mid = bf16(P - hi) and lo =
    bf16(P - hi - mid) (with ``split``; else rounded once to bf16), each
    tile's P V added to O in fp32; O / l rounded to bf16, l and the
    log-sum-exp from the fp32 P. -> (out bf16, lse fp32 (B,H,S))."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
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
        x = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * (1.0 / math.sqrt(hd) * math.log2(math.e))
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
            x = torch.where(kpos <= qpos, x, torch.full_like(x, neg))
        mx = torch.maximum(m, x.amax(-1))
        base = torch.where(mx == neg, torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        terms = [_bf16(p)]
        if split:
            terms.append(_bf16(p - terms[0]))
            terms.append(_bf16(p - terms[0] - terms[1]))
        pv = sum(torch.einsum("bhqk,bkhd->bhqd", t, vt) for t in terms)
        acc = acc * alpha[..., None] + pv
        m = mx
    l_sum = l_sum.clamp_min(1e-30)
    out = (acc / l_sum[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, (m + torch.log2(l_sum)) * math.log(2.0)


@pytest.mark.parametrize("H,Hkv,hd,block_k", [
    (25, 25, 64, 128),   # GPT-2 XL's heads; the kernel's key tile at hd 64
    (16, 8, 128, 64),    # Qwen3-1.7B's; at hd 128
])
def test_bf16_p_rounding_fits_the_card_bounds(H, Hkv, hd, block_k):
    """On the same numpy-seeded bf16 inputs (B 1, S 128, causal), the
    tensor-core forward's arithmetic stays within chip_smoke.py's bf16
    bounds of the reference's Pallas kernel (interpret mode, fp32), closer
    to it than with P rounded once, and its log-sum-exp within LSE_TOL of
    the port's plain version."""
    rng = np.random.default_rng(hd + H)
    S = 128
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, hd)).astype(np.float32))
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    ref = np.asarray(jax_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                               causal=True, interpret=True))
    out, lse = _tc_forward(q, k, v, causal=True, block_k=block_k)
    once, _ = _tc_forward(q, k, v, causal=True, block_k=block_k, split=False)
    err = np.abs(out.float().numpy() - ref)
    rms = np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref)
    assert err.max() <= BF16_FWD_MAX_ABS and rms <= BF16_RMS_REL
    rms_once = np.linalg.norm(once.float().numpy() - ref) / np.linalg.norm(ref)
    assert rms < rms_once
    _, lse_ref = R.flash_attention_fwd_ref(q.float(), k.float(), v.float(), causal=True)
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL
