"""Global-norm gradient clipping (``repro/optim/clip.py``; Table I: 1.0)."""

from __future__ import annotations

import numpy as np
import torch


def global_norm(grads) -> torch.Tensor:
    """fp32 sqrt of the sum, in leaf order, of each leaf's sum of squares."""
    total = None
    for g in grads:
        s = torch.square(g.float()).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (in place) to a global norm of at most ``max_norm``.

    Returns (grads, pre-clip norm); the scale stays on the device, so no
    host sync.
    """
    norm = global_norm(grads)
    limit = torch.tensor(np.float32(max_norm), device=norm.device)
    scale = torch.clamp(limit / torch.clamp_min(norm, 1e-12), max=1.0)
    for g in grads:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm
