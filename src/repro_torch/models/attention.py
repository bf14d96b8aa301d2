"""GQA / MQA / MHA self-attention, the no-cache (training / prefill) path.

Counterpart of ``repro/models/attention.py``. The attention itself goes
through ``kernels.ops.flash_attention``: on a CUDA tensor that launches the
hand-written flash kernel (and raises on a layout it does not take), on a
CPU tensor it runs the plain masked softmax of the reference's XLA path
(``attention.py:123-154``, with positions 0..S-1 for queries and keys).
qk-norm (``layers.rms_norm_headwise``, the RMSNorm kernel on the card) and
RoPE are applied as the reference applies them; the decode cache of the
dense serve path is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    p = {
        "wq": L.dense_init(gen, (cfg.d_model, cfg.num_heads, hd)),
        "wk": L.dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd)),
        "wv": L.dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd)),
        "wo": L.out_proj_init(gen, (cfg.num_heads, hd, cfg.d_model), cfg.num_layers),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((hd,), device=gen.device)
        p["k_norm"] = torch.ones((hd,), device=gen.device)
    return p


def gqa_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """Grouped-query attention over positions 0..S-1 of q and k/v.

    q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H, hd) in q.dtype.
    """
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)


def _project_qkv(p, x, xkv, cfg: ModelConfig):
    """x (B,S,D) -> q (B,S,H,hd); xkv -> k, v (B,S,Hkv,hd). wq is (D,H,hd).
    With qk-norm, q and k are normalized per head (before RoPE)."""
    B, S, D = x.shape
    q = (x @ L.cast(p["wq"], cfg).reshape(D, -1)).view(B, S, p["wq"].shape[1], -1)
    Bk, Sk, _ = xkv.shape
    k = (xkv @ L.cast(p["wk"], cfg).reshape(D, -1)).view(Bk, Sk, p["wk"].shape[1], -1)
    v = (xkv @ L.cast(p["wv"], cfg).reshape(D, -1)).view(Bk, Sk, p["wv"].shape[1], -1)
    if "q_norm" in p:
        q = L.rms_norm_headwise(q, p["q_norm"])
        k = L.rms_norm_headwise(k, p["k_norm"])
    return q, k, v


def apply_self_attention(p, x, cfg: ModelConfig, *, window: int = 0,
                         return_kv: bool = False, causal: bool = True):
    """Self-attention over x (B, S, D) at positions 0..S-1, no cache.

    Returns (out, extra) where extra is the (k, v) pair when ``return_kv``
    (prefill collects them for the cache; k after RoPE), else None.
    """
    q, k, v = _project_qkv(p, x, x, cfg)
    if cfg.positional == "rope":
        positions = torch.arange(x.shape[1], device=x.device)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    out = gqa_attention(q, k, v, causal=causal, window=window, softcap=0.0)
    B, S, H, hd = out.shape
    out = out.reshape(B, S, H * hd) @ L.cast(p["wo"], cfg).reshape(H * hd, -1)
    return out, ((k, v) if return_kv else None)
