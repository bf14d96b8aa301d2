"""Model registry: the public entry points of the model (``repro/models/registry.py``).

``init_params`` / ``forward`` / ``loss_fn`` for training;
``init_decode_state`` / ``prefill`` / ``decode_step`` for the dense serve
path (a static batch in lockstep: every architecture the port runs, and the
only one for models with recurrent blocks or MLA; GQA attention models
also serve through the paged path, ``repro_torch.serve``). An
encoder-decoder's state also holds each decoder layer's cross K/V
(``cross_kv``), which ``prefill`` builds once from one encoding of the
frames. The reference's scanned-layer branches are left out, as the port
does not scan layers. ``count_params`` is not ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

init_params = T.init_params
forward = T.forward


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy (+ MoE aux losses). batch: {"tokens",
    "labels"}, both (B, S), and for an encoder-decoder "frames", (B,
    S_enc, D) frame embeddings (:func:`forward`).

    Positions with label < 0 are masked out. Returns (total, metrics) with
    the reference's metric keys; an MoE model's total adds
    ``router_aux_loss_coef * moe_aux + 1e-4 * moe_z``, in the reference's
    order, and the training steps differentiate that total. Whisper trains
    through this function and its gradient on batches with frames, then an
    AdamW step, as the reference does (its simulator's and Trainer's token
    batches carry no frames): the gradient reaches the encoder's subtree
    and its ``positions`` through the encoder's non-causal flash attention
    and each decoder layer's cross-attention over keys of another length.
    """
    logits, aux = forward(params, cfg, batch)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    labels_safe = labels.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom
    total = loss
    if cfg.is_moe:
        total = total + cfg.router_aux_loss_coef * aux["moe_aux"] + 1e-4 * aux["moe_z"]
    metrics = {"lm_loss": loss, "moe_aux": aux["moe_aux"], "moe_z": aux["moe_z"],
               "tokens": mask.sum()}
    return total, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _layer_state(cfg: ModelConfig, layer_idx: int, batch: int, max_len: int, device):
    kind = cfg.block_kind(layer_idx)
    if T._is_mla(cfg, kind):
        return MLA.init_mla_cache(cfg, batch, max_len, device=device)
    if kind in T.ATTENTION_KINDS:
        return A.init_cache(cfg, batch, max_len, window=T._layer_window(cfg, layer_idx),
                            device=device)
    if kind == "mlstm":
        return SSM.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return SSM.init_slstm_state(cfg, batch, device)
    return RG.init_rglru_state(cfg, batch, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Decode state: per-layer caches / recurrent states, and the position
    of the next token (a host integer: the batch moves in lockstep)."""
    T.check_ported(cfg)
    dev = resolve_device(device)
    state: Dict[str, Any] = {"layers": [_layer_state(cfg, i, batch, max_len, dev)
                                        for i in range(cfg.num_layers)],
                             "position": 0}
    if cfg.is_encoder_decoder:
        state["cross_kv"] = [A.init_cross_cache(cfg, batch, device=dev)
                             for _ in range(cfg.num_layers)]
    return state


def decode_step(params, cfg: ModelConfig, state, tokens):
    """One serving step: tokens (B, 1) -> (logits (B, 1, V), new_state).

    The caches' tensors and the recurrent states' are updated in place or
    replaced; the old ``state`` is not to be used again.
    """
    pos = state["position"]
    x = L.embed_tokens(params["embed"], tokens, cfg, position_offset=pos)
    cross = state.get("cross_kv")
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        x, extra, _ = T._decoder_layer_fwd(lp, x, cfg, i, state=state["layers"][i],
                                           encoder_kv=None if cross is None else cross[i])
        new_layers.append(extra)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.lm_logits(params["embed"], x, cfg)
    return logits, {**state, "layers": new_layers, "position": pos + 1}


def prefill(params, cfg: ModelConfig, batch, *, max_len: int, last_only: bool = False):
    """Process whole prompts, returning (logits, decode_state).

    Attention layers hand their (k, v) streams to a cache, MLA layers their
    latents to a latent cache; recurrent layers their final state; an
    encoder-decoder's layers (batch["frames"] encoded once) their cross
    K/V to a cross cache.
    ``last_only``: logits of the last position alone.
    """
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens exceeds max_len {max_len}")
    logits, aux = forward(params, cfg, batch, collect_kv=True, last_only=last_only)
    layers = []
    for i, stream in enumerate(aux["kv"]):
        if T._is_mla(cfg, cfg.block_kind(i)):
            ckv, krope = stream
            stream = MLA.mla_cache_from_kv(cfg, ckv, krope, max_len=max_len)
        elif cfg.block_kind(i) in T.ATTENTION_KINDS:
            k, v = stream
            stream = A.cache_from_kv(cfg, k, v, max_len=max_len,
                                     window=T._layer_window(cfg, i))
        layers.append(stream)
    state: Dict[str, Any] = {"layers": layers, "position": S}
    if cfg.is_encoder_decoder:
        state["cross_kv"] = [A.cross_cache_from_kv(cfg, k, v) for k, v in aux["cross_kv"]]
    return logits, state
