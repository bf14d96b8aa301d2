"""Decoder (and encoder-decoder) stack: parameters and the training /
prefill / decode forward.

Counterpart of ``repro/models/transformer.py`` for decoders with unscanned
layers whose blocks are attention ("attn" / "local_attn": GQA, or MLA with
``attention_kind="mla"``), RG-LRU ("rglru", Griffin) or xLSTM ("mlstm" /
"slstm"), each followed by an MLP or, from layer ``first_dense_layers`` of
an MoE model on, the routed-experts layer. An encoder-decoder (Whisper)
adds a bidirectional encoder stack over stubbed frame embeddings
(:func:`encode`) and, in each decoder layer, a cross-attention sub-block
(``norm_cross`` / ``cross``) between the self-attention and the MLP.
Models with recurrent blocks, MLA or an encoder serve through the dense
path (``registry.prefill`` / ``decode_step``). Every architecture that
:func:`check_ported` accepts trains: the backward runs through the flash
kernels (an encoder-decoder's cross-attention over keys of another length
among them), the MoE dispatch, MLA's decompressed attention and, by
autograd over plain PyTorch, the recurrent blocks' scans. An
encoder-decoder trains through ``registry.loss_fn`` on a batch with
``"frames"``; the simulator and the Trainer draw token batches, which carry
none, and refuse it (:func:`check_token_batches`).

Parameters are an ``nn.ModuleDict`` tree with the reference's key names and
layouts, so the state-dict key ``layers.3.mix.wq`` is the reference's pytree
path ``layers/3/mix/wq`` and ``wq`` is ``(D, H, hd)``. Serving parameters
(the default) keep matmul weights in ``cfg.dtype`` and never require grad;
training parameters (``training=True``) keep every leaf in
``cfg.param_dtype`` and require grad (``layers.stored_dtype``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM

ATTENTION_KINDS = ("attn", "local_attn")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def block_kinds(cfg: ModelConfig) -> set:
    return {cfg.block_kind(i) for i in range(cfg.num_layers)}


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    if cfg.is_encoder_decoder and cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder with attention_kind={cfg.attention_kind!r} "
            f"is not ported")
    if cfg.attention_kind not in ("gqa", "mla", "none"):
        raise NotImplementedError(
            f"{cfg.name}: attention_kind={cfg.attention_kind!r} is not ported")
    unknown = block_kinds(cfg) - set(ATTENTION_KINDS + RECURRENT_KINDS)
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")
    if cfg.positional not in ("learned", "rope", "none") or cfg.activation not in (
            "gelu", "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: positional={cfg.positional!r}, activation="
            f"{cfg.activation!r} are not ported")


def check_token_batches(cfg: ModelConfig, who: str, source: str) -> None:
    """Raise for an encoder-decoder in ``who``, whose batches come from
    ``source`` and hold tokens and labels only."""
    check_ported(cfg)
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{who}: {cfg.name} is an encoder-decoder, and the {source} batches carry no "
            f"\"frames\" (in the reference too, where its loss_fn fails on them with a "
            f"KeyError); train it through models.registry.loss_fn on a batch with frames")


def _layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    kind = cfg.block_kind(layer_idx)
    return cfg.local_window if kind == "local_attn" else cfg.sliding_window


def _layer_has_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind in ("mlstm", "slstm"):
        return False
    return cfg.d_ff > 0 or cfg.is_moe


def _layer_uses_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.is_moe and layer_idx >= cfg.first_dense_layers


def _is_mla(cfg: ModelConfig, kind: str) -> bool:
    """Whether a block of ``kind`` is MLA attention (latent K/V and cache)."""
    return kind in ATTENTION_KINDS and cfg.attention_kind == "mla"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


_INIT_MIX = {"attn": A.init_attention, "local_attn": A.init_attention,
             "mlstm": SSM.init_mlstm, "slstm": SSM.init_slstm, "rglru": RG.init_rglru}


def init_decoder_layer(gen: torch.Generator, cfg: ModelConfig, layer_idx: int, *,
                       training: bool = False):
    """One layer's parameters in fp32, but for the routed experts, which are
    made in their storage (``moe.init_moe``; ``training`` picks it). An
    encoder-decoder's layer has a cross-attention sub-block."""
    kind = cfg.block_kind(layer_idx)
    p: Dict[str, Any] = {"norm1": L.init_norm(gen, cfg),
                         "mix": (MLA.init_mla if _is_mla(cfg, kind) else _INIT_MIX[kind])(
                             gen, cfg)}
    if cfg.is_encoder_decoder:
        p["norm_cross"] = L.init_norm(gen, cfg)
        p["cross"] = A.init_attention(gen, cfg, cross=True)
    if _layer_has_mlp(cfg, kind):
        p["norm2"] = L.init_norm(gen, cfg)
        p["mlp"] = (MOE.init_moe(gen, cfg, training=training)
                    if _layer_uses_moe(cfg, layer_idx) else L.init_mlp(gen, cfg))
    return p


def init_encoder_layer(gen: torch.Generator, cfg: ModelConfig):
    """One encoder layer's parameters (fp32): self-attention and an MLP."""
    return {"norm1": L.init_norm(gen, cfg), "mix": A.init_attention(gen, cfg),
            "norm2": L.init_norm(gen, cfg), "mlp": L.init_mlp(gen, cfg)}


def as_module(tree, cfg: ModelConfig, device=None, *, training: bool = False) -> nn.Module:
    """Nested dicts / lists of tensors -> the port's parameter module.

    Each leaf is cast to :func:`layers.stored_dtype` of its key and moved to
    ``device`` (default: where it lies); it requires grad when ``training``.
    A dict of leaves is an ``nn.ParameterDict``; one that also holds dicts
    (an MoE layer's ``shared`` MLP beside its ``router`` and experts) is one
    too, with those dicts as its submodules, so the state-dict keys stay
    the reference's pytree paths (``layers.1.mlp.shared.w_up``).
    """
    def build(node, name):
        if isinstance(node, dict):
            if any(isinstance(v, torch.Tensor) for v in node.values()):
                return nn.ParameterDict({
                    k: (nn.Parameter(v.to(device=device,
                                          dtype=L.stored_dtype(k, cfg, training=training)),
                                     requires_grad=training)
                        if isinstance(v, torch.Tensor) else build(v, k))
                    for k, v in node.items()})
            return nn.ModuleDict({k: build(v, k) for k, v in node.items()})
        if isinstance(node, (list, tuple)):
            return nn.ModuleList([build(v, name) for v in node])
        raise TypeError(f"unexpected parameter node {type(node).__name__} at {name!r}")

    return build(tree, "")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                training: bool = False) -> nn.Module:
    """Random parameters from ``seed``, made on ``device`` (default: the card),
    in serving storage or, with ``training``, in training storage.

    The numbers come from a ``torch.Generator`` on that device, so the same
    seed gives other weights on the card than on the CPU; to hold two
    devices to the same weights, make them on one and copy.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # each part is cast to its storage as soon as it is made (in the order
    # the generator draws them), so the fp32 draws of the whole model never
    # coexist: a 14.8 B model's 59 GB of them would not fit on an 80 GB card
    parts = {"embed": as_module(L.init_embeddings(gen, cfg), cfg, training=training),
             "final_norm": as_module(L.init_norm(gen, cfg), cfg, training=training)}
    parts["layers"] = nn.ModuleList([as_module(init_decoder_layer(gen, cfg, i,
                                                                  training=training), cfg,
                                               training=training)
                                     for i in range(cfg.num_layers)])
    if cfg.is_encoder_decoder:
        # the reference's subtree {"layers", "final_norm", "positions"}
        # (repro/models/transformer.py:141-149), made a layer at a time
        parts["encoder"] = nn.ParameterDict({
            "layers": nn.ModuleList([as_module(init_encoder_layer(gen, cfg), cfg,
                                               training=training)
                                     for _ in range(cfg.encoder_layers)]),
            "final_norm": as_module(L.init_norm(gen, cfg), cfg, training=training),
            "positions": nn.Parameter(
                L.dense_init(gen, (cfg.encoder_seq_len, cfg.d_model)).to(
                    L.stored_dtype("positions", cfg, training=training)),
                requires_grad=training)})
    return nn.ModuleDict(parts)


def param_leaves(params: nn.Module):
    """``[(name, tensor)]`` in the reference's pytree leaf order.

    ``jax.tree_util`` flattens dicts by sorted key and lists by index; the
    optimizers and the outer sync walk the leaves in that order, so sums
    over leaves (the global gradient norm) add up as the reference's do.
    """
    out = []

    def walk(node, prefix):
        if isinstance(node, nn.ParameterDict):
            for k in sorted(node.keys()):
                if isinstance(node[k], nn.Module):
                    walk(node[k], prefix + k + ".")
                else:
                    out.append((prefix + k, node[k]))
        elif isinstance(node, nn.ModuleDict):
            for k in sorted(node.keys()):
                walk(node[k], prefix + k + ".")
        elif isinstance(node, nn.ModuleList):
            for i, child in enumerate(node):
                walk(child, f"{prefix}{i}.")
        else:
            raise TypeError(f"unexpected parameter node {type(node).__name__}")

    walk(params, "")
    return out


def with_leaves(template: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """A parameter module of ``template``'s structure whose leaves are
    ``tensors`` (keyed by :func:`param_leaves` name), requiring no grad."""
    def build(node, prefix):
        if isinstance(node, nn.ParameterDict):
            return nn.ParameterDict({
                k: (build(node[k], prefix + k + ".") if isinstance(node[k], nn.Module)
                    else nn.Parameter(tensors[prefix + k], requires_grad=False))
                for k in node.keys()})
        if isinstance(node, nn.ModuleDict):
            return nn.ModuleDict({k: build(node[k], prefix + k + ".") for k in node.keys()})
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList([build(c, f"{prefix}{i}.") for i, c in enumerate(node)])
        raise TypeError(f"unexpected parameter node {type(node).__name__}")

    return build(template, "")


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _apply_mix(lp, x, cfg: ModelConfig, kind: str, *, window: int, state=None,
               return_kv: bool = False):
    if _is_mla(cfg, kind):
        return MLA.apply_mla(lp, x, cfg, cache=state, return_kv=return_kv)
    if kind in ATTENTION_KINDS:
        return A.apply_self_attention(lp, x, cfg, window=window, cache=state,
                                      return_kv=return_kv)
    if kind == "mlstm":
        return SSM.apply_mlstm(lp, x, cfg, state=state, return_state=return_kv)
    if kind == "slstm":
        return SSM.apply_slstm(lp, x, cfg, state=state, return_state=return_kv)
    return RG.apply_rglru(lp, x, cfg, state=state, return_state=return_kv)


def _decoder_layer_fwd(lp, x, cfg: ModelConfig, layer_idx: int, *, state=None,
                       return_kv: bool = False, encoder_kv=None):
    """One decoder layer. Returns (x, extra, aux): extra is an attention
    layer's (k, v) pair, an MLA layer's (ckv, krope) latents or a recurrent
    layer's final state (with ``return_kv``), the layer's new state (with
    ``state``: decode), else None; aux is an MoE layer's stats
    (``moe.apply_moe``), else None. ``encoder_kv``: an encoder-decoder
    layer's cross K/V (``attention.apply_cross_attention``)."""
    h = L.apply_norm(lp["norm1"], x, cfg)
    mix_out, extra = _apply_mix(lp["mix"], h, cfg, cfg.block_kind(layer_idx),
                                window=_layer_window(cfg, layer_idx), state=state,
                                return_kv=return_kv)
    x = x + mix_out
    if encoder_kv is not None:
        h = L.apply_norm(lp["norm_cross"], x, cfg)
        x = x + A.apply_cross_attention(lp["cross"], h, encoder_kv, cfg)
    aux = None
    if "mlp" in lp:
        h = L.apply_norm(lp["norm2"], x, cfg)
        if _layer_uses_moe(cfg, layer_idx):
            mlp_out, aux = MOE.apply_moe(lp["mlp"], h, cfg)
        else:
            mlp_out = L.apply_mlp(lp["mlp"], h, cfg)
        x = x + mlp_out
    return x, extra, aux


def encode(params, cfg: ModelConfig, frames):
    """The encoder over (stubbed) frame embeddings (B, S_enc, D) -> (B,
    S_enc, D) in cfg.dtype: learned positions, then bidirectional
    self-attention layers (non-causal, no window) and the final norm."""
    enc = params["encoder"]
    x = frames.to(L.compute_dtype(cfg))
    x = x + L.cast(enc["positions"][: x.shape[1]], cfg)[None]
    for lp in enc["layers"]:
        h = L.apply_norm(lp["norm1"], x, cfg)
        mix, _ = A.apply_self_attention(lp["mix"], h, cfg, window=0, causal=False)
        x = x + mix
        h = L.apply_norm(lp["norm2"], x, cfg)
        x = x + L.apply_mlp(lp["mlp"], h, cfg)
    return L.apply_norm(enc["final_norm"], x, cfg)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            collect_kv: bool = False, last_only: bool = False):
    """Training/prefill forward. batch: {"tokens": (B, S) integer} and, for
    an encoder-decoder, "frames": (B, S_enc, D) frame embeddings.

    Returns (logits (B, S, V) fp32, aux) where aux = {"moe_aux", "moe_z"}
    (the MoE layers' load-balance and z losses summed over the layers; zeros
    without MoE layers) plus, when ``collect_kv``, "kv": per layer, an
    attention layer's (k, v) streams, an MLA layer's latents or a recurrent
    layer's final state, and for an encoder-decoder "cross_kv": per layer,
    the cross-attention's (k, v) over the encoder's output (the frames are
    encoded once, each layer's cross K/V projected once).
    ``last_only``: the logits of the last position alone, (B, 1, V) (a
    serving prefill, whose other rows nobody reads).
    """
    check_ported(cfg)
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    enc_out = None
    if cfg.is_encoder_decoder:
        if batch.get("frames") is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the batch needs \"frames\"")
        enc_out = encode(params, cfg, batch["frames"])
    moe_aux = moe_z = torch.zeros((), device=x.device)
    kv_streams, cross_streams = [], []
    for i, lp in enumerate(params["layers"]):
        ekv = None if enc_out is None else A.encoder_kv(lp["cross"], enc_out, cfg)
        x, extra, stats = _decoder_layer_fwd(lp, x, cfg, i, return_kv=collect_kv,
                                             encoder_kv=ekv)
        if stats is not None:
            moe_aux, moe_z = moe_aux + stats["aux_loss"], moe_z + stats["z_loss"]
        if collect_kv:
            kv_streams.append(extra)
            cross_streams.append(ekv)
    if last_only:
        x = x[:, -1:].contiguous()
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.lm_logits(params["embed"], x, cfg)
    aux = {"moe_aux": moe_aux, "moe_z": moe_z}
    if collect_kv:
        aux["kv"] = kv_streams
        if enc_out is not None:
            aux["cross_kv"] = cross_streams
    return logits, aux
