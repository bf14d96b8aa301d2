"""Shared building blocks: norms, the MLP, embeddings, initializers.

Counterpart of ``repro/models/layers.py``. Functions take ``(params, x,
cfg)`` as there; the parameters are ``nn.ParameterDict``s with the
reference's key names and layouts (``transformer.as_module``).

Storage: the reference keeps every leaf in ``cfg.param_dtype`` and casts
matmul weights and the learned positions to ``cfg.dtype`` at each use
(:func:`cast`). For training the port does the same, so the gradient
reaches the fp32 leaf and the optimizers update fp32 masters (LayerNorm's
scale and bias, the learned positions and an encoder's ``positions``
among them). For serving
it casts those leaves once, when the parameters are built, which gives the
same forward numbers in half the memory (:func:`stored_dtype`); the cast at
use is then a no-op. Norm parameters, the leaves the reference reads in
fp32 (the recurrent blocks' gates, ``_COMPUTE_DTYPE_LEAVES``) and the token table stay in
``cfg.param_dtype`` either way: norms compute in fp32, and the tied logits
table is read in fp32 (``lm_logits``), while looked-up embedding rows are
cast to ``cfg.dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops

# leaves the reference casts to cfg.dtype at every use (``L.cast``). The
# set is keyed by leaf name alone, so a name joins it only if every block
# that has a leaf of that name casts it: the recurrent blocks' gate weights
# and biases (RG-LRU ``w_a``, ``b_a``, ``w_i``, ``b_i``, ``lambda``; mLSTM
# ``w_igate``, ``b_igate``, ``w_fgate``, ``b_fgate``; sLSTM ``w_i``,
# ``w_f``, ``w_z``, ``w_o``, ``b_*``, ``r_*``) and the per-head
# ``out_norm`` are read in fp32 there, and stay in ``cfg.param_dtype``. So
# do MLA's ``w_uk`` and ``w_uv``: its absorbed decode reads them in fp32
# (``repro/models/mla.py:136-148``), its prefill casts them at use. MoE's
# ``router`` is read in fp32 too; its experts' ``w_gate`` / ``w_up`` /
# ``w_down`` are cast at use, as MLA's down- and up-projections are.
_COMPUTE_DTYPE_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "positions",
     "w_x", "w_y", "conv", "w_dq", "w_uq", "w_q", "w_dkv", "w_kr"})


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def stored_dtype(leaf_name: str, cfg: ModelConfig, *, training: bool = False) -> torch.dtype:
    """dtype a parameter leaf is kept in (see the module docstring)."""
    if leaf_name in _COMPUTE_DTYPE_LEAVES and not training:
        return compute_dtype(cfg)
    return torch_dtype(cfg.param_dtype)


def cast(leaf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A matmul weight or the positions table at its use, in ``cfg.dtype``
    (``repro/models/layers.py:cast``); no copy when it is stored so."""
    return leaf.to(compute_dtype(cfg))


# ---------------------------------------------------------------------------
# init helpers (fp32; the caller casts with stored_dtype)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None):
    """Truncated normal at +-3 std; default std 0.02 (GPT-2 / Megatron)."""
    std = 0.02 if scale is None else scale
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-3 * std, b=3 * std,
                                       generator=gen)


def out_proj_init(gen: torch.Generator, shape, num_layers: int):
    """Residual-branch output proj init, scaled by 1/sqrt(2L) (GPT-2)."""
    return dense_init(gen, shape, 0.02 / math.sqrt(2 * max(num_layers, 1)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(gen: torch.Generator, cfg: ModelConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    p = {"scale": torch.ones((dim,), device=gen.device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), device=gen.device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm computed in fp32, cast back to x's dtype."""
    if cfg.norm != "layernorm":
        return kops.rmsnorm(x, p["scale"], eps=cfg.norm_eps)
    xf = x.float()
    y = F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(),
                     p["bias"].float(), cfg.norm_eps)
    return y.to(x.dtype)


def rms_norm_headwise(x, scale, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3/Chameleon): normalize over head_dim."""
    return kops.rmsnorm(x, scale, eps=eps)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    p = {}
    if cfg.activation == "swiglu":
        p["w_gate"] = dense_init(gen, (cfg.d_model, d_ff))
    p["w_up"] = dense_init(gen, (cfg.d_model, d_ff))
    p["w_down"] = out_proj_init(gen, (d_ff, cfg.d_model), cfg.num_layers)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    """Position-wise MLP, SwiGLU or GELU. x: (..., d_model).

    ``jax.nn.gelu`` defaults to the tanh approximation, hence
    ``approximate="tanh"``; ``jax.nn.silu`` is ``F.silu``.
    """
    up = x @ cast(p["w_up"], cfg)
    if cfg.activation == "swiglu":
        h = F.silu(x @ cast(p["w_gate"], cfg)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ cast(p["w_down"], cfg)


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------


def init_embeddings(gen: torch.Generator, cfg: ModelConfig):
    p = {"tokens": dense_init(gen, (cfg.vocab_size, cfg.d_model))}
    if cfg.positional == "learned":
        p["positions"] = dense_init(gen, (cfg.max_position_embeddings, cfg.d_model))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(p, tokens, cfg: ModelConfig, *, position_offset: int = 0):
    """tokens: (B, S) integer -> (B, S, D) in cfg.dtype."""
    x = p["tokens"][tokens.long()].to(compute_dtype(cfg))
    if cfg.positional == "learned":
        positions = position_offset + torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + cast(p["positions"][positions], cfg)[None]
    return x


def lm_logits(p, x, cfg: ModelConfig):
    """x: (..., D) -> (..., V); fp32 logits from the fp32 table."""
    if cfg.tie_embeddings:
        logits = F.linear(x.float(), p["tokens"].float())
    else:
        logits = x.float() @ p["lm_head"].float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (S,) or (B, S). Rotates the two halves
    of head_dim in fp32 and casts back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]  # (S, hd/2)
        angles = angles[None, :, None, :]  # (1, S, 1, hd/2)
    else:
        angles = positions[..., None].float() * freqs  # (B, S, hd/2)
        angles = angles[:, :, None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
