"""Model forward passes against the paged KV pool.

Counterpart of ``repro/serve/paged_model.py``:

- :func:`paged_prefill` runs the ordinary forward with ``collect_kv=True``
  over one (padded) prompt, whose attention is the flash kernel on the
  card, and scatters the collected K/V streams into the sequence's blocks.
  Pad tokens' K/V lands in the pool but is masked at decode time by
  ``context_lens``.
- :func:`paged_decode_step` feeds one token per slot at per-sequence
  positions (RoPE at each slot's own position); its attention is the paged
  decode kernel gathering through each sequence's block table. An MoE
  layer routes every slot's token, an empty slot's too, as the reference
  does, so the capacity is that of ``max_slots`` tokens.

Matmul weights and the learned positions are cast to ``cfg.dtype`` at use
(``layers.cast``), as the reference does, so either parameter storage
serves: serving storage (already in ``cfg.dtype``, the cast is a no-op) or
training storage (fp32 masters).

Only architectures passing ``kv_cache.paged_supported`` (and ported:
``transformer.check_ported``) come through here. The pools are updated in
place (``kv_cache.write_token`` / ``write_prefill``) and returned.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KC


def _embed(p, tokens, positions, cfg: ModelConfig):
    """tokens (B, 1) + per-sequence absolute positions (B,) -> (B, 1, D).

    ``layers.embed_tokens`` broadcasts one offset across the batch;
    continuous batching needs a position per sequence, so the learned
    position is looked up per row here.
    """
    x = p["tokens"][tokens].to(L.compute_dtype(cfg))
    if cfg.positional == "learned":
        x = x + L.cast(p["positions"][positions], cfg)[:, None]
    return x


def paged_prefill(params, cfg: ModelConfig, tokens, pools, block_table, *,
                  pcfg: KC.PagedCacheConfig):
    """Prefill one prompt into its blocks.

    tokens (1, S) with S a multiple of ``pcfg.block_size`` (the engine pads;
    right-padding is harmless under the causal mask). block_table (S / bs,)
    int32 physical block ids. Returns (logits (1, S, V), pools).
    """
    logits, aux = T.forward(params, cfg, {"tokens": tokens}, collect_kv=True)
    for kv_i, li in enumerate(KC.kv_layer_indices(cfg)):
        k, v = aux["kv"][li]
        pools = KC.write_prefill(pools, kv_i, block_table, k[0], v[0], pcfg=pcfg)
    return logits, pools


def paged_decode_step(params, cfg: ModelConfig, pools, tokens, positions,
                      block_tables, context_lens, *,
                      pcfg: KC.PagedCacheConfig):
    """One decode step over every slot of the batch.

    tokens (B,) int32, the token fed at ``positions`` (B,) int32.
    block_tables (B, T) int32. context_lens (B,) int32: tokens visible
    *including* this one (``positions + 1`` for live slots, 0 for empty
    slots, whose rows compute garbage into the sink block and come out as
    zero logits).

    Returns (logits (B, V) fp32, pools).
    """
    B = tokens.shape[0]
    bs = pcfg.block_size
    active = context_lens > 0
    rows = torch.arange(B, device=tokens.device)
    blk_idx = torch.clamp(positions.long() // bs, 0, block_tables.shape[1] - 1)
    write_blocks = torch.where(active, block_tables[rows, blk_idx],
                               KC.SINK_BLOCK).to(torch.int32)
    slots = (positions % bs).to(torch.int32)

    pos = positions.long()
    pos2d = pos[:, None]  # (B, 1)
    x = _embed(params["embed"], tokens[:, None].long(), pos, cfg)
    quantized = "k_scale" in pools
    for kv_i, li in enumerate(KC.kv_layer_indices(cfg)):
        lp = params["layers"][li]
        h = L.apply_norm(lp["norm1"], x, cfg)
        q, k, v = A._project_qkv(lp["mix"], h, h, cfg)  # (B, 1, H/Hkv, hd)
        if cfg.positional == "rope":
            q = L.apply_rope(q, pos2d, cfg.rope_theta)
            k = L.apply_rope(k, pos2d, cfg.rope_theta)
        pools = KC.write_token(pools, kv_i, write_blocks, slots,
                               k[:, 0], v[:, 0], pcfg=pcfg)
        out = kops.paged_decode_attention(
            q[:, 0], pools["k"][kv_i], pools["v"][kv_i],
            block_tables, context_lens,
            pools["k_scale"][kv_i] if quantized else None,
            pools["v_scale"][kv_i] if quantized else None,
            window=T._layer_window(cfg, li))
        H, hd = out.shape[1], out.shape[2]
        wo = L.cast(lp["mix"]["wo"], cfg).reshape(H * hd, -1)
        x = x + (out.reshape(B, H * hd) @ wo)[:, None]
        if "mlp" in lp:
            h = L.apply_norm(lp["norm2"], x, cfg)
            if T._layer_uses_moe(cfg, li):  # every slot routes, empty ones too
                mlp_out, _ = MOE.apply_moe(lp["mlp"], h, cfg)
            else:
                mlp_out = L.apply_mlp(lp["mlp"], h, cfg)
            x = x + mlp_out

    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.lm_logits(params["embed"], x, cfg)[:, 0]  # (B, V)
    return torch.where(active[:, None], logits, 0.0), pools
