"""Host-memory offload of the outer-optimizer state (paper §V;
counterpart of ``repro/core/offload.py``).

Between outer events the anchor ``θ_{t−r}``, the momentum ``M`` and the
error-feedback residuals are touched once every ``r`` inner steps. With
``TrainConfig.offload_outer_state`` the Trainer keeps them in pinned host
memory between events: :func:`to_host` copies every tensor of the state
into ``pin_memory()`` tensors, :func:`to_device` copies it back onto the
card it came from with ``non_blocking=True`` on the current stream, so a
kernel enqueued after it on that stream (the pier update) reads the copy
finished. A CPU state stays where it is: there is nothing to offload, as
on the reference's CPU backend.
"""

from __future__ import annotations

from typing import Any

import torch


def supports_offload() -> bool:
    """True where there is a card to offload from."""
    return torch.cuda.is_available()


def _map(tree: Any, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(x, fn) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn) for x in tree)
    return tree


def to_host(tree: Any) -> Any:
    """Copy every CUDA tensor of ``tree`` (an ``OuterState``, lists,
    tensors) into pinned host memory, waiting for the copies; the card's
    tensors are freed when the caller drops the old tree."""
    def move(x):
        if x.device.type != "cuda":
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)  # a synchronous copy: the card's tensor may be freed next
        return h
    return _map(tree, move)


def to_device(tree: Any, device) -> Any:
    """Copy every pinned host tensor of ``tree`` onto ``device`` with
    ``non_blocking=True`` on the current stream (what the stream runs next
    sees the copy done). A CPU ``device`` returns the tree unchanged."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return tree
    return _map(tree, lambda x: x.to(dev, non_blocking=True) if x.device.type == "cpu" else x)
