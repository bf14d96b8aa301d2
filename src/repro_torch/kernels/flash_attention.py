"""Flash attention forward: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/flash_attention.py:flash_attention``; the
kernel is ``csrc/flash_attention.cu``. A CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version
``kernels/ref.py:flash_attention_ref``. Forward only, as in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch and nowhere else; a caller may reset it to 0).
launches = 0


def check_shapes(q, k, v) -> None:
    """Raise on a layout the kernel does not take (any device)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,S,H,hd), k/v (B,S,Hkv,hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv != 0:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if hd % 8 != 0 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple of 8 and <= 256")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,Hkv,hd) -> (B,S,H,hd) in q.dtype."""
    global launches
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q/k/v")
    B, S, H, hd = q.shape
    if B * H >= 2 ** 31 or (S + 63) // 64 > 65535:
        raise ValueError(f"flash_attention: grid too large for B*H={B * H}, S={S}")
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd, int(bool(causal)),
        int(window), float(softcap), 1.0 / math.sqrt(hd),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches += 1
    return out
