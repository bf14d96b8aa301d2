"""GQA / MQA / MHA self-attention and an encoder-decoder's cross-attention:
training / prefill, and the dense serve path's decode caches.

Counterpart of ``repro/models/attention.py``. Without a cache the attention
goes through ``kernels.ops.flash_attention``: on a CUDA tensor that
launches the hand-written flash kernel (and raises on a layout it does not
take), on a CPU tensor it runs the plain masked softmax of the reference's
XLA path (``attention.py:123-154``, with positions 0..S-1 for queries and
keys). qk-norm (``layers.rms_norm_headwise``, the RMSNorm kernel on the
card) and RoPE are applied as the reference applies them.

Decode cache (the dense serve path): ``{"k", "v": (B, size, Hkv, hd) in
cfg.dtype, "pos": (B, size) int32 (-1 marks an unwritten slot), "length":
int}``, the reference's layout, with ``length`` a host integer (the dense
path's positions are in lockstep, so the host knows them). A window layer's
cache is a ring of ``size = window`` slots (slot = position % size); any
other layer's is a linear buffer. The decode step's attention goes through
the paged decode kernel (``kernels.ops.paged_decode_attention``): the
contiguous cache is viewed, without a copy, as a pool of ``B * size /
DENSE_BLOCK`` blocks with an identity block table, over a context of
``min(length + 1, size)`` and no window. That is exact: a ring of ``window``
slots holds exactly the last ``window`` positions, and a linear buffer holds
its positions in order with its unwritten slots past the context. So a
linear buffer's size is rounded up to a multiple of ``DENSE_BLOCK``, and a
ring whose window is not a multiple of it raises.

Cross-attention (Whisper's decoder): every query sees every one of the
encoder's ``Skv`` keys (the reference's ``gqa_attention`` with
``q_positions = Skv``), so in training and prefill it is the flash kernel
with keys of another length than the queries and no mask
(``causal=False``). Its decode cache, built once at prefill, is
``{"k", "v": (B, size, Hkv, hd) in cfg.dtype, "tables": (B, size /
DENSE_BLOCK) int32, "context": (B,) int32}`` with ``size`` = ``Skv``
rounded up to a multiple of :data:`DENSE_BLOCK` (1 504 rows for 1 500
frames, the last 4 zeros past the context): a decode step's one query
attends over it through the paged decode kernel, viewed as a pool as the
self-attention cache is, over a context of ``Skv``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, cross: bool = False):
    """Projections (fp32); qk-norm scales when ``cfg.use_qk_norm``, but not
    for cross-attention (``repro/models/attention.py:86``)."""
    hd = cfg.resolved_head_dim
    p = {
        "wq": L.dense_init(gen, (cfg.d_model, cfg.num_heads, hd)),
        "wk": L.dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd)),
        "wv": L.dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd)),
        "wo": L.out_proj_init(gen, (cfg.num_heads, hd, cfg.d_model), cfg.num_layers),
    }
    if cfg.use_qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), device=gen.device)
        p["k_norm"] = torch.ones((hd,), device=gen.device)
    return p


def gqa_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """Grouped-query attention over positions 0..S-1 of q and k/v.

    q (B, S, H, hd), k/v (B, Skv, Hkv, hd) -> (B, S, H, hd) in q.dtype;
    ``Skv`` other than ``S`` only without a mask (cross-attention).
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
                         return_kv: bool = False, causal: bool = True,
                         cache: Optional[dict] = None):
    """Self-attention over x (B, S, D).

    - training / prefill: ``cache=None``, positions 0..S-1; with
      ``return_kv`` extra is the (k, v) pair (k after RoPE), else None;
    - decode: ``cache`` given (the module docstring's layout), x is the one
      new token at position ``cache["length"]``; extra is the new cache,
      whose tensors are the old ones written in place.
    """
    q, k, v = _project_qkv(p, x, x, cfg)
    if cache is None:
        if cfg.positional == "rope":
            positions = torch.arange(x.shape[1], device=x.device)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        out = gqa_attention(q, k, v, causal=causal, window=window, softcap=0.0)
        extra = (k, v) if return_kv else None
    else:
        out, extra = _decode_attention(q, k, v, cache, cfg, window=window)
    B, S, H, hd = out.shape
    out = out.reshape(B, S, H * hd) @ L.cast(p["wo"], cfg).reshape(H * hd, -1)
    return out, extra


# ---------------------------------------------------------------------------
# the dense decode cache
# ---------------------------------------------------------------------------

DENSE_BLOCK = 16  # slots a block of the cache's pool view holds


def cache_size(max_len: int, window: int = 0) -> int:
    """Slots of a layer's decode cache: a ring of ``window`` slots when the
    context can outgrow the window, else ``max_len`` rounded up to a
    multiple of :data:`DENSE_BLOCK` (the positions never wrap there, and
    all of them lie inside any window)."""
    if window > 0 and max_len >= window:
        if window % DENSE_BLOCK:
            raise ValueError(f"a ring cache of window {window} cannot be viewed as blocks of "
                             f"{DENSE_BLOCK} slots")
        return window
    return -(-max_len // DENSE_BLOCK) * DENSE_BLOCK


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, window: int = 0,
               device):
    """Empty KV cache. ``pos`` = -1 marks unwritten slots."""
    hd = cfg.resolved_head_dim
    size = cache_size(max_len, window)
    kv = dict(dtype=L.compute_dtype(cfg), device=device)
    return {"k": torch.zeros((batch, size, cfg.num_kv_heads, hd), **kv),
            "v": torch.zeros((batch, size, cfg.num_kv_heads, hd), **kv),
            "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
            "length": 0}


def cache_from_kv(cfg: ModelConfig, k, v, *, max_len: int, window: int = 0):
    """A decode cache from prefill's (k, v) streams at positions 0..S-1.

    A ring keeps only the last ``size`` tokens, in ring order (slot = pos %
    size), so decode's writes continue the ring.
    """
    B, S = k.shape[:2]
    cache = init_cache(cfg, B, max_len, window=window, device=k.device)
    size = cache["k"].shape[1]
    keep = min(S, size)
    positions = torch.arange(S - keep, S, device=k.device)
    slots = positions % size if window > 0 else positions
    cache["k"][:, slots] = k[:, S - keep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, S - keep:].to(cache["v"].dtype)
    cache["pos"][:, slots] = positions.to(torch.int32)
    cache["length"] = S
    return cache


def _block_view(cache_t):
    """(B, size, Hkv, hd) -> the pool view (B * size / DENSE_BLOCK,
    DENSE_BLOCK, Hkv, hd) of the same storage."""
    B, size = cache_t.shape[:2]
    if size % DENSE_BLOCK or not cache_t.is_contiguous():
        raise ValueError(f"a cache of {size} slots (contiguous: {cache_t.is_contiguous()}) "
                         f"cannot be viewed as blocks of {DENSE_BLOCK}")
    return cache_t.view(B * size // DENSE_BLOCK, DENSE_BLOCK, *cache_t.shape[2:])


def _decode_attention(q, k, v, cache, cfg: ModelConfig, *, window: int):
    """Write the new token's k / v at its slot, then attend over the cache
    through the paged decode kernel (the module docstring's view)."""
    cache_k, cache_v, cache_pos = cache["k"], cache["v"], cache["pos"]
    B, size = cache_k.shape[:2]
    start = cache["length"]
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one token a sequence, got {q.shape[1]}")
    if window <= 0 and start >= size:
        raise ValueError(f"the decode cache of {size} slots is full")
    if cfg.positional == "rope":
        positions = torch.full((1,), start, dtype=torch.int64, device=q.device)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    slot = start % size if window > 0 else start
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    cache_pos[:, slot] = start
    nblk = size // DENSE_BLOCK
    tables = torch.arange(B * nblk, dtype=torch.int32, device=q.device).view(B, nblk)
    context = torch.full((B,), min(start + 1, size), dtype=torch.int32, device=q.device)
    out = kops.paged_decode_attention(q[:, 0].contiguous(), _block_view(cache_k),
                                      _block_view(cache_v), tables, context)
    return out[:, None], {"k": cache_k, "v": cache_v, "pos": cache_pos, "length": start + 1}


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder) and its decode cache
# ---------------------------------------------------------------------------


def encoder_kv(p, enc_out, cfg: ModelConfig):
    """Cross-attention K/V from the encoder's output (B, Skv, D) -> k, v
    (B, Skv, Hkv, hd) in cfg.dtype; no qk-norm, no positions."""
    B, Skv, D = enc_out.shape
    k = (enc_out @ L.cast(p["wk"], cfg).reshape(D, -1)).view(B, Skv, p["wk"].shape[1], -1)
    v = (enc_out @ L.cast(p["wv"], cfg).reshape(D, -1)).view(B, Skv, p["wv"].shape[1], -1)
    return k, v


def apply_cross_attention(p, x, encoder_kv, cfg: ModelConfig):
    """Cross-attention of x (B, S, D) over the encoder's keys.

    ``encoder_kv`` is the (k, v) pair of :func:`encoder_kv` (training,
    prefill: the flash kernel, non-causal, keys of another length) or a
    cross cache of :func:`cross_cache_from_kv` (decode: x is one token, and
    the paged decode kernel reads the cache as a pool). Returns (B, S, D).
    """
    B, S, D = x.shape
    q = (x @ L.cast(p["wq"], cfg).reshape(D, -1)).view(B, S, p["wq"].shape[1], -1)
    if isinstance(encoder_kv, dict):
        if S != 1:
            raise ValueError(f"a cross cache takes one query token a sequence, got {S}")
        c = encoder_kv
        out = kops.paged_decode_attention(q[:, 0].contiguous(), _block_view(c["k"]),
                                          _block_view(c["v"]), c["tables"], c["context"])
        out = out[:, None]
    else:
        k, v = encoder_kv
        out = gqa_attention(q, k, v, causal=False)
    H, hd = out.shape[2:]
    return out.reshape(B, S, H * hd) @ L.cast(p["wo"], cfg).reshape(H * hd, -1)


def init_cross_cache(cfg: ModelConfig, batch: int, *, device,
                     kv_len: Optional[int] = None):
    """A zero cross cache for ``kv_len`` encoder positions (default
    ``cfg.encoder_seq_len``), its rows rounded up to a multiple of
    :data:`DENSE_BLOCK` (the module docstring's layout)."""
    kv_len = cfg.encoder_seq_len if kv_len is None else kv_len
    size = -(-kv_len // DENSE_BLOCK) * DENSE_BLOCK
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = dict(dtype=L.compute_dtype(cfg), device=device)
    nblk = size // DENSE_BLOCK
    return {"k": torch.zeros(shape, **kv), "v": torch.zeros(shape, **kv),
            "tables": torch.arange(batch * nblk, dtype=torch.int32,
                                   device=device).view(batch, nblk),
            "context": torch.full((batch,), kv_len, dtype=torch.int32, device=device)}


def cross_cache_from_kv(cfg: ModelConfig, k, v):
    """The decode cache of one layer's cross K/V (B, Skv, Hkv, hd): written
    into the padded buffer, whose rows past ``Skv`` stay zero."""
    B, Skv = k.shape[:2]
    cache = init_cross_cache(cfg, B, device=k.device, kv_len=Skv)
    cache["k"][:, :Skv] = k
    cache["v"][:, :Skv] = v
    return cache
