"""Parameters of the reference package, carried into the port.

``params_from_jax`` takes the reference's parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference's side) and returns
the port's parameter module, so that both packages compute the same model.
Key names and layouts carry over unchanged: the pytree path
``layers/3/mix/wq`` becomes the state-dict key ``layers.3.mix.wq``, the
recurrent blocks' leaves included (mLSTM's (H, dh, dh) projections and
(H, dh) ``out_norm``, the (W, C) conv kernels, RG-LRU's ``lambda``), and
the MoE and MLA ones (an MoE layer's fp32 ``router``, its (E, D, F) /
(E, F, D) experts and its ``shared`` MLP, ``layers.1.mlp.shared.w_up``;
MLA's projections, with ``w_uk`` and ``w_uv`` kept in fp32), and an
encoder-decoder's ``encoder`` subtree (``encoder.layers.0.mix.wq``,
``encoder.final_norm.scale``, ``encoder.positions``) and each decoder
layer's ``norm_cross`` / ``cross`` sub-block, each in the storage its name
gives (``layers.stored_dtype``): serving storage, or with ``training``
every leaf in ``cfg.param_dtype`` and requiring grad, as the training
paths of every architecture take them. This module imports no JAX: it
only reads numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T


def params_from_jax(tree, cfg: ModelConfig, device="cuda", *,
                    training: bool = False) -> torch.nn.Module:
    """Reference parameter pytree (nested dicts/lists of numpy arrays) ->
    the port's parameters on ``device``, each leaf in its stored dtype
    (serving storage, or training storage with ``training``)."""
    T.check_ported(cfg)
    dev = resolve_device(device)
    if isinstance(tree.get("layers"), dict):
        raise ValueError("params_from_jax expects unscanned layer params "
                         "(a list of layers, not a stacked 'scan' tree)")

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [to_torch(v) for v in node]
        return torch.from_numpy(np.array(node, dtype=np.float32))

    return T.as_module(to_torch(tree), cfg, device=dev, training=training)
