"""Blockwise int8 quantization and dequantization: the CUDA kernels' wrappers.

Counterparts of ``repro/kernels/quantize.py:quantize_blockwise`` and
``dequantize_blockwise``; the kernels are ``csrc/quantize.cu`` and
``csrc/dequantize.cu``. A CUDA tensor launches the kernel (or raises), a
CPU tensor takes the plain version in ``kernels/ref.py``; each kernel agrees
with its plain version bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dequantize_blockwise_ref, quantize_blockwise_ref

# Launches of each CUDA kernel in this process (each wrapper adds one per
# launch and nowhere else; a caller may reset them to 0).
launches = 0  # quantize_blockwise
dequantize_launches = 0


def quantize_blockwise(x: torch.Tensor, *, bits: int = 8, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (N,) float -> (q int8 (nblocks*block,), scales f32 (nblocks,)).

    The payload is padded to whole blocks; callers slice the dequantized
    result back to N.
    """
    if x.dim() != 1:
        raise ValueError(f"quantize_blockwise takes a flat (N,) tensor, got {tuple(x.shape)}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if x.device.type == "cpu":
        return quantize_blockwise_ref(x, bits=bits, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_blockwise: unsupported device {x.device}")
    return _launch(x, bits, block)


def _launch(x: torch.Tensor, bits: int, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on x's card and stream -> (q, scales). The C entry point
    picks the vector kernel for an aligned x whose block is a power-of-two
    number of 16-byte vectors, the scalar one otherwise."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_blockwise kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_blockwise kernel needs a contiguous input")
    n = x.shape[0]
    nb = (n + block - 1) // block
    q = torch.empty((nb * block,), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    qmax = float(2 ** (bits - 1) - 1)
    lib = _build.lib()
    err = lib.quantize_blockwise_launch(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], n, q.data_ptr(),
        scales.data_ptr(), nb, block, qmax, float(np.float32(1.0 / qmax)),
        x.device.index or 0, _build.stream_ptr(x.device))
    _build.check(err, "quantize_blockwise")
    launches += 1
    return q, scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256
                         ) -> torch.Tensor:
    """(nblocks*block,) int8 + (nblocks,) f32 -> f32 (nblocks*block,).

    A payload that is not whole blocks raises ``ValueError`` on any device,
    as the reference does: pass :func:`quantize_blockwise`'s output
    unsliced.
    """
    global dequantize_launches
    if q.dim() != 1:
        raise ValueError(f"dequantize_blockwise takes a flat (N,) payload, got {tuple(q.shape)}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    nq = q.shape[0]
    if nq % block != 0:
        raise ValueError(
            f"ragged quantized payload: {nq} values do not fill whole blocks "
            f"of {block} (quantize_blockwise pads to whole blocks; pass its "
            f"output unsliced)")
    nb = nq // block
    if q.device.type == "cpu":
        return dequantize_blockwise_ref(q, scales, block=block)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize_blockwise: unsupported device {q.device}")
    if scales.device != q.device:
        raise ValueError(f"dequantize_blockwise: scales on {scales.device}, payload on {q.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_blockwise kernel takes int8 values and float32 scales, "
                        f"got {q.dtype} and {scales.dtype}")
    if tuple(scales.shape) != (nb,):
        raise ValueError(f"dequantize_blockwise: {nb} blocks need ({nb},) scales, got "
                         f"{tuple(scales.shape)}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_blockwise kernel needs contiguous tensors")
    out = torch.empty((nq,), dtype=torch.float32, device=q.device)
    if nq == 0:  # nothing to launch
        return out
    lib = _build.lib()
    err = lib.dequantize_blockwise_launch(q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                          nq, block, q.device.index or 0,
                                          _build.stream_ptr(q.device))
    _build.check(err, "dequantize_blockwise")
    dequantize_launches += 1
    return out
