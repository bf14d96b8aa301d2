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


# Elements of a leaf updated at a time: the update's fp32 temporaries (two,
# four with narrower moments) are of this size, not of a whole leaf (a
# smaller leaf is one slice). The update is elementwise, so slicing a leaf
# changes no bit of it; it keeps a 256 000-row token table
# (RecurrentGemma-9B's 1.05 B values) from adding 4 GB temporaries beside
# the training state.
UPDATE_SLICE = 1 << 26


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

    def update(p, g, m, v, decay):
        # each operation rounded once in fp32, written through two fp32
        # temporaries: fp32 moments and parameters are updated in place
        # (.float() is then the tensor itself); narrower ones are read into
        # fp32 copies and stored back rounded (the step reads the fp32 ones)
        gf, mf, vf, pf = (x.float() for x in (g, m, v, p))
        t = torch.mul(omb1, gf)
        mf.mul_(b1).add_(t)
        torch.mul(gf, gf, out=t)
        t.mul_(omb2)
        vf.mul_(b2).add_(t)
        for store, f in ((m, mf), (v, vf)):
            if store is not f:
                store.copy_(f)
        torch.div(vf, c2, out=t)
        t.sqrt_().add_(eps)
        step = torch.div(mf, c1).div_(t)
        if decay:
            step.add_(torch.mul(wd, pf, out=t))
        pf.sub_(step.mul_(lr_t))
        if p is not pf:
            p.copy_(pf)

    for (name, p), g, m, v in zip(leaves, grads, state.mu, state.nu):
        if not all(x.is_contiguous() for x in (p, m, v)):
            update(p, g, m, v, decay_mask(name))
            continue
        # a flat slice at a time (views of the contiguous parameter and
        # moments, so the slices are written in place)
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        for i in range(0, p.numel(), UPDATE_SLICE):
            update(*(x[i:i + UPDATE_SLICE] for x in flat), decay_mask(name))
    return state
