"""AdamW written out by hand (``repro/optim/adamw.py``).

    m <- b1 m + (1-b1) g           v <- b2 v + (1-b2) g^2
    m_hat = m / (1-b1^t)           v_hat = v / (1-b2^t)
    theta <- theta - lr * (m_hat / (sqrt(v_hat) + eps) + wd * theta)

The same operations in the same order as the reference, each a separate
fp32 operation, so the two round alike. ``torch.optim.AdamW`` is not used:
it adds eps after ``sqrt(v) / sqrt(1-b2^t)`` and decays the weights before
the step, which rounds differently. Moments are stored in
``tc.opt_state_dtype``; the update math runs in fp32; parameters and
moments are updated in place (the reference returns new trees).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import torch_dtype


class AdamWState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: List[torch.Tensor]  # first moments, in leaf order
    nu: List[torch.Tensor]  # second moments


def adamw_init(leaves, tc: TrainConfig) -> AdamWState:
    """``leaves``: ``[(name, param)]`` (``transformer.param_leaves``)."""
    dt = torch_dtype(tc.opt_state_dtype)
    dev = leaves[0][1].device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros(p.shape, dtype=dt, device=dev) for _, p in leaves],
        nu=[torch.zeros(p.shape, dtype=dt, device=dev) for _, p in leaves])


def clone_state(state: AdamWState) -> AdamWState:
    return AdamWState(count=state.count.clone(), mu=[m.clone() for m in state.mu],
                      nu=[v.clone() for v in state.nu])


def decay_mask(name: str) -> bool:
    """True if the leaf gets weight decay (matmuls yes; norms, biases and
    positions no), from its last key as ``repro/optim/adamw.py:_decay_mask``."""
    last = name.rsplit(".", 1)[-1]
    if last in ("scale", "bias") or last.startswith("b_"):
        return False
    if "norm" in last or last == "lambda":
        return False
    if last == "positions":
        return False
    return True


@torch.no_grad()
def adamw_update(grads, state: AdamWState, leaves, tc: TrainConfig, lr) -> AdamWState:
    """One AdamW step over ``leaves`` (``[(name, param)]``) in place.

    ``grads`` are in leaf order; ``lr`` is the fp32 scalar of ``lr_at``.
    Returns the state (its tensors updated in place, its count advanced).
    """
    dev = state.count.device

    def f32(x):
        # fp32 0-dim tensors on the leaves' device: every product, sum and
        # quotient below is then an fp32 operation on that device (a CPU
        # scalar divisor would turn a division into a reciprocal multiply)
        return torch.tensor(np.float32(x), device=dev)

    b1, b2 = f32(tc.adam_beta1), f32(tc.adam_beta2)
    omb1, omb2 = f32(1.0 - tc.adam_beta1), f32(1.0 - tc.adam_beta2)
    eps, wd, lr_t, one = f32(tc.adam_eps), f32(tc.weight_decay), f32(lr), f32(1.0)
    state.count.add_(1)
    cf = state.count.float()
    c1 = one - torch.pow(b1, cf)
    c2 = one - torch.pow(b2, cf)
    for (name, p), g, m, v in zip(leaves, grads, state.mu, state.nu):
        gf = g.float()
        mf = b1 * m.float() + omb1 * gf
        vf = b2 * v.float() + omb2 * (gf * gf)
        m.copy_(mf)
        v.copy_(vf)
        step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        del mf, vf
        if decay_mask(name):
            step = step + wd * p.float()
        p.copy_(p.float() - lr_t * step)
    return state
