"""Blockwise int8 quantization: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/quantize.py:quantize_blockwise``; the kernel
is ``csrc/quantize.cu``. A CUDA tensor launches the kernel (or raises), a
CPU tensor takes the plain version ``kernels/ref.py:quantize_blockwise_ref``;
the two agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_blockwise_ref

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch and nowhere else; a caller may reset it to 0).
launches = 0


def quantize_blockwise(x: torch.Tensor, *, bits: int = 8, block: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (N,) float -> (q int8 (nblocks*block,), scales f32 (nblocks,)).

    The payload is padded to whole blocks; callers slice the dequantized
    result back to N.
    """
    global launches
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
        _build.stream_ptr(x.device))
    _build.check(err, "quantize_blockwise")
    launches += 1
    return q, scales
