"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Counterpart of ``repro/models/rglru.py``. Recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_i x_t + b_i)            # input gate
    log a_t = -c * softplus(Lambda) * r_t   # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A whole sequence runs the linear recurrence as a log-depth scan (Hillis and
Steele: ceil(log2 S) rounds, each combining every position with the one
``d`` before it) with the reference's combine; decode keeps the O(1)
state. The reference runs this outside any Pallas kernel (XLA's
``associative_scan``), so the port runs plain PyTorch on either device and
trains through autograd over the scan's rounds, as the reference
differentiates its scan; the input gate's clip halves the gradient at its
bounds as ``jnp.clip`` does (:func:`_clip`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv1d

_C = 8.0  # Griffin's fixed gate sharpness
_MAX_SQRT_GRADIENT = 1000.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig):
    D = cfg.d_model
    W = cfg.resolved_lru_width
    dev = gen.device
    p = {
        "w_x": L.dense_init(gen, (D, W)),  # recurrent branch in
        "w_y": L.dense_init(gen, (D, W)),  # gate branch in
        "conv": L.dense_init(gen, (cfg.conv1d_width, W), 0.1),
        "w_a": L.dense_init(gen, (W, W), 0.01),
        "b_a": torch.zeros((W,), device=dev),
        "w_i": L.dense_init(gen, (W, W), 0.01),
        "b_i": torch.zeros((W,), device=dev),
    }
    # Lambda so that a^c is uniform-ish in [0.9, 0.999] (Griffin A.2)
    u = 0.9 + 0.099 * torch.rand((W,), generator=gen, device=dev)
    p["lambda"] = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log(u)/c)
    p["w_down"] = L.out_proj_init(gen, (W, D), cfg.num_layers)
    return p


def _rglru_gates(p, u):
    """u: (B, S, W) conv output (fp32). Returns (log_a, gated_input)."""
    r = torch.sigmoid(u @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(u @ p["w_i"].float() + p["b_i"].float())
    log_a = -_C * F.softplus(p["lambda"].float()) * r
    a2 = torch.exp(2 * log_a)
    beta = torch.sqrt(_clip(1.0 - a2, 1.0 / _MAX_SQRT_GRADIENT ** 2, 1.0))
    return log_a, beta * (i * u)


def _clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: ``torch.clamp``'s values, and at a bound the
    gradient halved as ``jnp.clip``'s (a tie of its maximum or minimum),
    where ``torch.clamp`` passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _linear_scan(log_a, x0, h0: Optional[torch.Tensor]):
    """h_t = a_t h_{t-1} + x0_t over axis 1. log_a/x0: (B,S,W).

    An inclusive scan of the reference's combine
    ``(la_l, x_l), (la_r, x_r) -> (la_l + la_r, exp(la_r) x_l + x_r)`` in
    ceil(log2 S) rounds; round ``d`` combines position t with t - d.
    """
    if h0 is not None:
        x0 = x0.clone()
        x0[:, 0] += torch.exp(log_a[:, 0]) * h0
    la, h = log_a, x0
    S = h.shape[1]
    for r in range(math.ceil(math.log2(S)) if S > 1 else 0):
        d = 1 << r
        h = torch.cat([h[:, :d], torch.exp(la[:, d:]) * h[:, :-d] + h[:, d:]], dim=1)
        la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
    return h


def apply_rglru(p, x, cfg: ModelConfig, *, state=None, return_state=False):
    """Griffin recurrent block. state=None -> a whole sequence; else one step."""
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(x @ L.cast(p["w_y"], cfg), approximate="tanh")
    u = x @ L.cast(p["w_x"], cfg)
    if state is None:
        uc, _ = _causal_conv1d(u, L.cast(p["conv"], cfg))
        log_a, x0 = _rglru_gates(p, uc.float())
        h = _linear_scan(log_a, x0, None)
        new_state = None
        if return_state:
            W = p["conv"].shape[0]
            new_state = {"hidden": h[:, -1].float(),
                         "conv": u[:, -(W - 1):].to(L.compute_dtype(cfg))}
    else:
        uc, new_conv = _causal_conv1d(u, L.cast(p["conv"], cfg), state["conv"])
        log_a, x0 = _rglru_gates(p, uc.float())
        h = torch.exp(log_a[:, 0]) * state["hidden"] + x0[:, 0]
        new_state = {"hidden": h, "conv": new_conv}
        h = h[:, None]
    return (h.to(x.dtype) * gate) @ L.cast(p["w_down"], cfg), new_state


def init_rglru_state(cfg: ModelConfig, batch: int, device):
    W = cfg.resolved_lru_width
    return {
        "hidden": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, W), dtype=L.compute_dtype(cfg),
                            device=device),
    }
