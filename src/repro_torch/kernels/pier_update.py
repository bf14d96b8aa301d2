"""Fused Pier outer update: the CUDA kernel's wrapper.

Counterpart of ``repro/kernels/pier_update.py:pier_update``; the kernel is
``csrc/pier_update.cu``. A CUDA tensor launches the kernel (or raises), a
CPU tensor takes the plain version ``kernels/ref.py:pier_update_ref``; the
two agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pier_update_ref

# Launches of the CUDA kernel in this process (the wrapper adds one per
# launch and nowhere else; a caller may reset it to 0).
launches = 0

FORMULATIONS = {"nesterov_torch": 0, "nesterov_classic": 1, "sgd": 2}


def pier_update(anchor: torch.Tensor, momentum: torch.Tensor, delta: torch.Tensor,
                mu, lr, formulation: str = "nesterov_torch", *,
                p_out: Optional[torch.Tensor] = None,
                m_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf's outer update -> (p fp32, m_new in momentum's dtype).

    ``anchor``, ``momentum`` and ``delta`` are same-shape tensors (fp32 or
    bf16; any shape, read as flat). ``mu`` and ``lr`` are scalars, rounded
    to fp32 once here. ``p_out`` (fp32) and ``m_out`` (momentum's dtype)
    are optional outputs written in place; they may be ``anchor`` and
    ``momentum`` themselves, which is how the outer state is updated
    without a model-sized temporary.
    """
    global launches
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown outer optimizer {formulation!r}")
    if not (anchor.shape == momentum.shape == delta.shape):
        raise ValueError(f"pier_update: shapes differ: {tuple(anchor.shape)}, "
                         f"{tuple(momentum.shape)}, {tuple(delta.shape)}")
    for name, out, dt in (("p_out", p_out, torch.float32), ("m_out", m_out, momentum.dtype)):
        if out is not None and (out.shape != anchor.shape or out.dtype != dt
                                or out.device != anchor.device):
            raise ValueError(f"pier_update: {name} must be a {dt} tensor of shape "
                             f"{tuple(anchor.shape)} on {anchor.device}")
    mu32, lr32 = np.float32(mu), np.float32(lr)
    if anchor.device.type == "cpu":
        p, m = pier_update_ref(anchor, momentum, delta, mu=mu32, lr=lr32,
                               formulation=formulation)
        m = m.to(momentum.dtype)
        if p_out is not None:
            p = p_out.copy_(p)
        if m_out is not None:
            m = m_out.copy_(m)
        return p, m
    if anchor.device.type != "cuda":
        raise ValueError(f"pier_update: unsupported device {anchor.device}")
    ts = (anchor, momentum, delta) + tuple(t for t in (p_out, m_out) if t is not None)
    if any(t.device != anchor.device for t in ts):
        raise ValueError("pier_update: all tensors must be on one device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in (anchor, momentum, delta)):
        raise TypeError("pier_update kernel takes float32 or bfloat16 tensors, got "
                        f"{anchor.dtype}, {momentum.dtype}, {delta.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pier_update kernel needs contiguous tensors")
    p = p_out if p_out is not None else torch.empty(anchor.shape, dtype=torch.float32,
                                                    device=anchor.device)
    m = m_out if m_out is not None else torch.empty_like(momentum)
    codes = _build.DTYPE_CODES
    lib = _build.lib()
    err = lib.pier_update_launch(
        anchor.data_ptr(), codes[anchor.dtype], momentum.data_ptr(), codes[momentum.dtype],
        delta.data_ptr(), codes[delta.dtype], p.data_ptr(), m.data_ptr(),
        anchor.numel(), float(mu32), float(lr32), FORMULATIONS[formulation],
        anchor.device.index or 0, _build.stream_ptr(anchor.device))
    _build.check(err, "pier_update")
    launches += 1
    return p, m
