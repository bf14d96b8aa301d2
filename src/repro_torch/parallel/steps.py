"""Serve steps of the paged path (``repro/parallel/steps.py:build_paged_serve_steps``).

The reference jits the steps over a device mesh; the port runs them
eagerly on one device and has no mesh yet. The steps run without autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KC
from repro_torch.serve import paged_model as PM


@dataclass
class PagedServeBundle:
    decode_step: Callable
    prefill_step: Callable
    init_pools: Callable
    device: torch.device


def build_paged_serve_steps(mc: ModelConfig, *, pcfg: KC.PagedCacheConfig,
                            device="cuda") -> PagedServeBundle:
    T.check_ported(mc)
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, pools, tokens, positions, block_tables, context_lens):
        return PM.paged_decode_step(params, mc, pools, tokens, positions,
                                    block_tables, context_lens, pcfg=pcfg)

    @torch.no_grad()
    def prefill_step(params, tokens, pools, block_table, last_index: int):
        logits, pools = PM.paged_prefill(params, mc, tokens, pools, block_table,
                                         pcfg=pcfg)
        # serving semantics: only the last real token's logits leave the
        # step (``last_index`` skips the block-padding tail)
        return logits[:, last_index], pools

    return PagedServeBundle(
        decode_step=decode_step, prefill_step=prefill_step,
        init_pools=lambda: KC.init_pools(mc, pcfg, dev), device=dev)
