"""Model registry: the public entry points of the model (``repro/models/registry.py``).

``init_params`` / ``forward`` / ``loss_fn`` for the ported dense decoders.
The dense decode path (``prefill`` / ``decode_step``) and ``count_params``
are not ported yet; serving goes through the paged path
(``repro_torch.serve``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T

init_params = T.init_params
forward = T.forward


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy. batch: {"tokens", "labels"}, both (B, S).

    Positions with label < 0 are masked out. Returns (loss, metrics) with
    the reference's metric keys. MoE models raise (``T.check_ported``), so
    the reference's router aux and z terms never apply here.
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
    metrics = {"lm_loss": loss, "moe_aux": aux["moe_aux"], "moe_z": aux["moe_z"],
               "tokens": mask.sum()}
    return loss, metrics
