"""Multi-head Latent Attention (DeepSeek-V2) [arXiv:2405.04434].

Counterpart of ``repro/models/mla.py``. Training / prefill uses the
decompressed formulation (per-head K/V materialized from the latent
``c_kv``); decode uses the *absorbed* formulation against a latent cache of
``kv_lora_rank + qk_rope_head_dim`` values per token. The reference
computes both in plain ``jnp`` (it never reaches a Pallas kernel), and so
does the port in plain PyTorch, softmax in fp32; the latent norms
(``q_norm``, ``kv_norm``, eps 1e-6) go through the RMSNorm kernel
(``layers.rms_norm_headwise``), two launches a layer.

Training differentiates the decompressed path: the two latent norms
through the RMSNorm kernel's backward at (B·S, ``q_lora_rank``) and
(B·S, ``kv_lora_rank``), the rest through autograd. The reference splits
the queries into blocks (``_resolve_chunk``) to bound the memory of its
scores; each query row sums the same terms either way, so the port keeps
the whole-sequence form, whose (B, H, S, S) fp32 scores and
probabilities are what it costs.

Storage: ``w_dq``, ``w_uq``, ``w_q``, ``w_dkv``, ``w_kr`` and ``wo`` are
cast to ``cfg.dtype`` at each use (serving storage keeps them so);
``w_uk`` and ``w_uv`` stay in ``cfg.param_dtype``, because the absorbed
decode reads them in fp32, and the prefill casts them at use.

Cache layout (the dense serve path): ``{"ckv": (B, max_len, r), "krope":
(B, max_len, dr) in cfg.dtype, "pos": (B, max_len) int32 (-1 marks an
unwritten slot), "length": int}``, the reference's, with ``length`` a host
integer as in ``models/attention.py``: the token fed to a decode step sits
at position ``length``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import layers as L


def init_mla(gen: torch.Generator, cfg: ModelConfig):
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    p = {}
    if cfg.q_lora_rank > 0:
        p["w_dq"] = L.dense_init(gen, (cfg.d_model, cfg.q_lora_rank))
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), device=gen.device)
        p["w_uq"] = L.dense_init(gen, (cfg.q_lora_rank, H, dn + dr))
    else:
        p["w_q"] = L.dense_init(gen, (cfg.d_model, H, dn + dr))
    p["w_dkv"] = L.dense_init(gen, (cfg.d_model, r))
    p["kv_norm"] = torch.ones((r,), device=gen.device)
    p["w_kr"] = L.dense_init(gen, (cfg.d_model, dr))
    p["w_uk"] = L.dense_init(gen, (r, H, dn))
    p["w_uv"] = L.dense_init(gen, (r, H, dv))
    p["wo"] = L.out_proj_init(gen, (H, dv, cfg.d_model), cfg.num_layers)
    return p


def score_scale(cfg: ModelConfig) -> float:
    """``1 / sqrt(dn + dr)``, rounded as the reference computes it (fp32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(cfg.qk_nope_head_dim
                                                      + cfg.qk_rope_head_dim)))


def _proj(x, w, cfg: ModelConfig):
    """x (B, S, a) times w (a, ...) cast to cfg.dtype -> (B, S, ...)."""
    out = x @ L.cast(w, cfg).reshape(w.shape[0], -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def _queries(p, x, cfg: ModelConfig, positions):
    dn = cfg.qk_nope_head_dim
    if "w_dq" in p:
        cq = L.rms_norm_headwise(_proj(x, p["w_dq"], cfg), p["q_norm"])
        q = _proj(cq, p["w_uq"], cfg)
    else:
        q = _proj(x, p["w_q"], cfg)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, x, cfg: ModelConfig, positions):
    ckv = L.rms_norm_headwise(_proj(x, p["w_dkv"], cfg), p["kv_norm"])
    krope = _proj(x, p["w_kr"], cfg)
    krope = L.apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, krope


def apply_mla(p, x, cfg: ModelConfig, *, cache: Optional[dict] = None,
              return_kv: bool = False):
    """MLA over x (B, S, D) -> (out, extra), as ``attention.apply_self_attention``:

    - training / prefill (``cache=None``): positions 0..S-1, causal; with
      ``return_kv`` extra is the latent streams ``(ckv, krope)``, else None;
    - decode (``cache`` given): x is the one new token at position
      ``cache["length"]``; extra is the new cache, whose tensors are the old
      ones written in place.
    """
    B, S = x.shape[:2]
    scale = score_scale(cfg)
    start = 0 if cache is None else cache["length"]
    positions = torch.arange(start, start + S, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    ckv, krope = _latents(p, x, cfg, positions)

    if cache is None:
        # decompressed: per-head K/V from the latents
        k_nope = _proj(ckv, p["w_uk"], cfg)
        v = _proj(ckv, p["w_uv"], cfg)
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krope.float())) * scale
        causal = positions[None, :] <= positions[:, None]
        probs = torch.softmax(torch.where(causal, scores, NEG_INF), dim=-1)
        out = torch.einsum("bhqk,bkhv->bqhv", probs, v.float()).to(x.dtype)
        extra = (ckv, krope) if return_kv else None
    else:
        # absorbed: scores and values against the latent cache
        if start + S > cache["ckv"].shape[1]:
            raise ValueError(f"MLA decode at position {start} past a cache of "
                             f"{cache['ckv'].shape[1]} slots")
        cache["ckv"][:, start:start + S] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, start:start + S] = krope.to(cache["krope"].dtype)
        cache["pos"][:, start:start + S] = positions.to(torch.int32)
        c_kv, c_kr, c_pos = cache["ckv"].float(), cache["krope"].float(), cache["pos"]
        q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), p["w_uk"].float())
        scores = (torch.einsum("bqhr,bkr->bhqk", q_eff, c_kv)
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), c_kr)) * scale
        valid = (c_pos[:, None, :] >= 0) & (c_pos[:, None, :] <= positions[None, :, None])
        probs = torch.softmax(torch.where(valid[:, None], scores, NEG_INF), dim=-1)
        o_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_kv)
        out = torch.einsum("bqhr,rhv->bqhv", o_lat, p["w_uv"].float()).to(x.dtype)
        extra = {**cache, "length": start + S}

    H, dv = out.shape[2], out.shape[3]
    out = out.reshape(B, S, H * dv) @ L.cast(p["wo"], cfg).reshape(H * dv, -1)
    return out, extra


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Empty latent cache. ``pos`` = -1 marks unwritten slots."""
    dt = L.compute_dtype(cfg)
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                                 device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
            "length": 0}


def mla_cache_from_kv(cfg: ModelConfig, ckv, krope, *, max_len: int):
    """A latent cache from prefill's ``(ckv, krope)`` streams at positions
    0..S-1."""
    B, S = ckv.shape[:2]
    cache = init_mla_cache(cfg, B, max_len, device=ckv.device)
    cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :S] = krope.to(cache["krope"].dtype)
    cache["pos"][:, :S] = torch.arange(S, dtype=torch.int32, device=ckv.device)
    cache["length"] = S
    return cache
