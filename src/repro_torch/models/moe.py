"""Mixture-of-Experts layer: top-k routing, shared experts.

Counterpart of ``repro/models/moe.py``. Dispatch is the reference's
sort-based "expert slots" formulation: token -> slot indices from a stable
argsort and ``searchsorted``, tokens scattered into an (experts, capacity,
d_model) buffer, the SwiGLU experts as batched products over the experts,
the outputs gathered back and weighted by router probability. The port
keeps one formulation, the reference's ``"flat"`` one (a flat buffer of
``E * C + 1`` rows whose last row takes the dropped assignments); on one
device its ``"indexed"`` one gives the same numbers, and the port has no
expert-sharded buffer that would need it. Every shape is fixed by the
token count: the capacity ``C`` is a host integer computed from ``T``, and
nothing reads a value back to the host, so a step queues on the card
without waiting.

Training differentiates the flat mode, as the reference trains with it.
The backward is deterministic, so a multi-process Trainer and the
simulator give the same bits: each token's K assignments are its row
broadcast, not gathered (``xf[arange(T*K) // K]`` would backpropagate
through an indexed accumulate whose order CUDA does not fix), so their
gradient is a sum over K; the scatter into the buffer and the gather out
of it touch each kept slot once. A dropped assignment's gradient is zero:
it was written to the sentinel row, which the experts never read. The
router's gradient flows through the mean probabilities of the
load-balance loss, the z-loss and the renormalized top-k probabilities
(the sort's backward puts each back at its expert); the per-expert count
``fe`` carries none, in either package.

Aux losses: the switch-style load-balance loss and the router z-loss,
returned with the per-expert load so ``transformer.forward`` can sum them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

# fp32 elements of one draw of expert weights: an expert tensor is drawn a
# slab of experts at a time and cast to its storage, so the fp32 draw of a
# whole tensor (22.5 GB for one of Kimi-K2's (384, 7168, 2048)) never exists
SLAB_ELEMENTS = 1 << 28


def _experts(gen: torch.Generator, shape, draw, dtype: torch.dtype) -> torch.Tensor:
    """An (E, a, b) expert tensor in ``dtype``, drawn by ``draw(gen, shape)``
    (fp32) a slab of experts at a time."""
    E, a, b = shape
    per = max(1, SLAB_ELEMENTS // (a * b))
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e0 in range(0, E, per):
        out[e0:e0 + per] = draw(gen, (min(per, E - e0), a, b))
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, training: bool = False):
    """Router (std 0.02 / sqrt(D / 768), kept fp32), the routed experts'
    SwiGLU weights (E, D, F) / (E, F, D), each made in its storage
    (``layers.stored_dtype``; serving storage unless ``training``), and
    the shared experts as one MLP of ``moe_d_ff * num_shared_experts``."""
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def store(name):
        return L.stored_dtype(name, cfg, training=training)

    p = {"router": L.dense_init(gen, (D, E), scale=0.02 / math.sqrt(D / 768)),
         "w_gate": _experts(gen, (E, D, F_), L.dense_init, store("w_gate")),
         "w_up": _experts(gen, (E, D, F_), L.dense_init, store("w_up")),
         "w_down": _experts(gen, (E, F_, D),
                            lambda g, s: L.out_proj_init(g, s, cfg.num_layers),
                            store("w_down"))}
    if cfg.num_shared_experts > 0:
        p["shared"] = L.init_mlp(gen, cfg, d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def expert_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slot count, rounded up to a multiple of 8 (the reference's
    TPU layout; the port keeps it so both drop the same tokens)."""
    raw = num_tokens * cfg.num_experts_per_tok / cfg.num_experts
    cap = int(math.ceil(raw * cfg.expert_capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def route(logits: torch.Tensor, k: int):
    """fp32 router logits (T, E) -> (probs, top-k probs renormalized, top-k
    expert ids). Equal probabilities keep the lower expert id first, as
    ``jax.lax.top_k`` documents (a stable descending sort, on either
    device)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (out, {"aux_loss", "z_loss", "load"})."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = expert_capacity(T, cfg)
    dev = x.device
    xf = x.reshape(T, D)

    # ---- routing (fp32) ----
    logits = xf.float() @ p["router"].float()
    probs, topk_probs, topk_idx = route(logits, K)

    # ---- aux losses ----
    flat_expert = topk_idx.reshape(-1)  # (T*K,)
    me = probs.mean(dim=0)
    assign = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_expert, torch.ones(T * K, dtype=torch.float32, device=dev))
    fe = assign / (T * K)
    aux_loss = E * torch.sum(fe * me)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- slot assignment (sort-based; earlier tokens keep their slots) ----
    sort_idx = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[sort_idx]
    first = torch.searchsorted(sorted_expert, torch.arange(E, device=dev), side="left")
    pos_in_expert = torch.arange(T * K, device=dev) - first[sorted_expert]
    slot_sorted = torch.where(pos_in_expert < C, sorted_expert * C + pos_in_expert, E * C)
    # invert the sort: the slot of each assignment, E*C = dropped
    slot = torch.empty_like(slot_sorted).scatter_(0, sort_idx, slot_sorted)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    # assignment a is token a // K's row (the reference's xf[token_of_assign]);
    # the sentinel row takes every dropped one
    buf[slot] = xf[:, None].expand(T, K, D).reshape(T * K, D)
    expert_in = buf[:E * C].view(E, C, D)

    # ---- expert computation (SwiGLU), batched over the experts ----
    gate = torch.bmm(expert_in, L.cast(p["w_gate"], cfg))
    up = torch.bmm(expert_in, L.cast(p["w_up"], cfg))
    expert_out = torch.bmm(F.silu(gate) * up, L.cast(p["w_down"], cfg))

    # ---- combine: gather back and weight by router prob ----
    out_buf = torch.cat([expert_out.reshape(E * C, D),
                         torch.zeros((1, D), dtype=x.dtype, device=dev)])
    per_assign = out_buf[slot]  # (T*K, D); dropped -> the zero row
    weighted = per_assign * topk_probs.reshape(-1)[:, None].to(x.dtype)
    out = weighted.view(T, K, D).sum(dim=1).to(x.dtype).view(B, S, D)

    if "shared" in p:
        out = out + L.apply_mlp(p["shared"], x, cfg)
    return out, {"aux_loss": aux_loss, "z_loss": z_loss, "load": fe}

