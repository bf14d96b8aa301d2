"""Paged/blocked KV cache for continuous-batching decode.

Counterpart of ``repro/serve/kv_cache.py``. K/V lives in a fixed pool of
``num_blocks`` blocks of ``block_size`` token slots, shared by every
sequence and every attention layer:

    k_pool / v_pool   (L_kv, num_blocks, block_size, Hkv, hd)

A sequence owns an ordered list of physical block ids (its *block table*);
logical token ``t`` lives in block ``table[t // block_size]`` slot
``t % block_size``. Blocks are handed out by the host-side free-list
:class:`BlockAllocator` and returned when the sequence completes.

Physical block 0 is a reserved *sink*: empty decode slots in a batched
step write there, so their garbage never lands in a live sequence.

int8 block format: with ``quantized=True`` the pools store int8 values plus
one fp32 absmax scale per (block, slot, kv-head) row of ``hd`` elements,
written by the blockwise quantize kernel with ``block = hd`` and read by the
decode kernel, which dequantizes as it loads.

The pools are preallocated tensors that :func:`write_token` and
:func:`write_prefill` update in place with ``index_put_``, where the
reference, whose arrays are immutable, returns new pools from
``.at[].set``. Both return the pools, so callers read the same either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

SINK_BLOCK = 0  # reserved physical block for inactive decode slots


@dataclass(frozen=True)
class PagedCacheConfig:
    """Shape/format of the shared block pool."""

    num_blocks: int = 64  # total physical blocks, incl. the sink
    block_size: int = 16  # token slots per block
    quantized: bool = False  # int8 blocks + fp32 per-(slot, head) scales
    quant_bits: int = 8
    dtype: Optional[str] = None  # unquantized pool dtype; None = compute dtype

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the sink)")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1: {self.block_size}")

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` token slots."""
        return -(-num_tokens // self.block_size)

    def pool_dtype(self, cfg: ModelConfig) -> torch.dtype:
        """Element dtype of unquantized pools (the model compute dtype
        unless overridden, e.g. fp32 for the parity tests)."""
        return L.torch_dtype(self.dtype) if self.dtype else L.compute_dtype(cfg)


def kv_layer_indices(cfg: ModelConfig) -> List[int]:
    """Decoder layers that carry a KV cache (attn / local_attn blocks)."""
    return [i for i in range(cfg.num_layers) if cfg.uses_kv_cache(i)]


def paged_supported(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether the paged decode path covers this architecture."""
    if cfg.attention_kind != "gqa":
        return False, f"attention_kind={cfg.attention_kind!r} (dense path)"
    if cfg.is_encoder_decoder:
        return False, "encoder-decoder (dense path)"
    kinds = {cfg.block_kind(i) for i in range(cfg.num_layers)}
    bad = kinds - {"attn", "local_attn"}
    if bad:
        return False, f"recurrent blocks {sorted(bad)} (dense path)"
    if cfg.num_heads % max(cfg.num_kv_heads, 1) != 0:
        return False, (f"H={cfg.num_heads} not a multiple of "
                       f"Hkv={cfg.num_kv_heads}")
    return True, ""


def init_pools(cfg: ModelConfig, pcfg: PagedCacheConfig, device) -> Dict[str, torch.Tensor]:
    """Zero-initialized pools for every KV-carrying layer, on ``device``."""
    lkv = len(kv_layer_indices(cfg))
    hd = cfg.resolved_head_dim
    shape = (lkv, pcfg.num_blocks, pcfg.block_size, cfg.num_kv_heads, hd)
    if pcfg.quantized:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    dt = pcfg.pool_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def pool_nbytes(cfg: ModelConfig, pcfg: PagedCacheConfig) -> int:
    """Device-memory footprint of the pools."""
    lkv = len(kv_layer_indices(cfg))
    hd = cfg.resolved_head_dim
    elems = (lkv * pcfg.num_blocks * pcfg.block_size * cfg.num_kv_heads * hd)
    if pcfg.quantized:
        return 2 * (elems + elems // hd * 4)  # int8 payload + fp32 scales
    return 2 * elems * pcfg.pool_dtype(cfg).itemsize


# ---------------------------------------------------------------------------
# device-side writes (in place)
# ---------------------------------------------------------------------------


def _quantize_rows(x: torch.Tensor, *, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-quantize the trailing hd axis: one fp32 scale per row.

    The quantize kernel with ``block = hd``; it converts its input to fp32
    itself, as the reference's ``x.astype(float32)`` does first.
    """
    hd = x.shape[-1]
    q, s = kops.quantize_blockwise(x.reshape(-1), bits=bits, block=hd)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def write_token(pools: Dict[str, torch.Tensor], layer: int, block_ids, slots,
                k, v, *, pcfg: PagedCacheConfig) -> Dict[str, torch.Tensor]:
    """Scatter one decode step's K/V in place: block_ids/slots (B,), k/v (B, Hkv, hd)."""
    idx = (block_ids.long(), slots.long())
    if pcfg.quantized:
        kq, ks = _quantize_rows(k, bits=pcfg.quant_bits)
        vq, vs = _quantize_rows(v, bits=pcfg.quant_bits)
        pools["k"][layer].index_put_(idx, kq)
        pools["v"][layer].index_put_(idx, vq)
        pools["k_scale"][layer].index_put_(idx, ks)
        pools["v_scale"][layer].index_put_(idx, vs)
        return pools
    dt = pools["k"].dtype
    pools["k"][layer].index_put_(idx, k.to(dt))
    pools["v"][layer].index_put_(idx, v.to(dt))
    return pools


def write_prefill(pools: Dict[str, torch.Tensor], layer: int, block_table,
                  k, v, *, pcfg: PagedCacheConfig) -> Dict[str, torch.Tensor]:
    """Scatter a prefilled sequence's K/V stream into its blocks, in place.

    ``k``/``v`` are (S, Hkv, hd) with S a whole number of blocks (the
    engine pads prompts to a block multiple; pad slots are masked at
    attention time by ``context_lens``); ``block_table`` is (S / bs,).
    """
    bs = pcfg.block_size
    nb, rem = divmod(k.shape[0], bs)
    if rem:
        raise ValueError(
            f"prefill stream length {k.shape[0]} is not a whole number of "
            f"blocks of {bs}; pad the prompt to a block multiple")
    kb = k.reshape(nb, bs, *k.shape[1:])
    vb = v.reshape(nb, bs, *v.shape[1:])
    idx = (block_table.long(),)
    if pcfg.quantized:
        kq, ks = _quantize_rows(kb, bits=pcfg.quant_bits)
        vq, vs = _quantize_rows(vb, bits=pcfg.quant_bits)
        pools["k"][layer].index_put_(idx, kq)
        pools["v"][layer].index_put_(idx, vq)
        pools["k_scale"][layer].index_put_(idx, ks)
        pools["v_scale"][layer].index_put_(idx, vs)
        return pools
    dt = pools["k"].dtype
    pools["k"][layer].index_put_(idx, kb.to(dt))
    pools["v"][layer].index_put_(idx, vb.to(dt))
    return pools


# ---------------------------------------------------------------------------
# host-side block allocator
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Free-list allocator over the physical blocks of one pool.

    Host-side and strictly bookkeeping. Invariants (property-tested):

    - a block is never handed out twice without an intervening ``free``;
    - ``free`` of an unallocated block raises (double-free guard);
    - ``num_free + len(allocated)`` is conserved at ``num_blocks - 1``
      (block 0 is the reserved sink and never circulates).
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the sink)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, SINK_BLOCK, -1))
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> frozenset:
        return frozenset(self._allocated)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        blk = self._free.pop()
        self._allocated.add(blk)
        return blk

    def alloc_many(self, n: int) -> List[int]:
        if n > self.num_free:
            raise RuntimeError(
                f"KV block pool exhausted: need {n}, have {self.num_free}")
        return [self.alloc() for _ in range(n)]

    def free(self, block: int) -> None:
        if block not in self._allocated:
            raise ValueError(
                f"freeing block {block} that is not allocated "
                f"(double free or sink/out-of-range id)")
        self._allocated.remove(block)
        self._free.append(block)

    def free_many(self, blocks) -> None:
        for b in blocks:
            self.free(b)
