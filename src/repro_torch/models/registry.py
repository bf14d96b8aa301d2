"""Model registry: the public entry points of the model (``repro/models/registry.py``).

``init_params`` / ``forward`` for the ported dense decoders. The loss, the
dense decode path (``prefill`` / ``decode_step``) and ``count_params`` are
not ported yet; serving goes through the paged path (``repro_torch.serve``).
"""

from __future__ import annotations

from repro_torch.models import transformer as T

init_params = T.init_params
forward = T.forward
