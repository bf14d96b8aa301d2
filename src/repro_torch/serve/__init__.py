"""Serving subsystem of the port (paged KV cache, continuous batching).

- :mod:`repro_torch.serve.kv_cache`: the shared block pool, written in
  place, its free-list allocator and the optional int8 block format.
- :mod:`repro_torch.serve.paged_model`: prefill and batched single-token
  decode against the pool (the flash and paged decode kernels).
- :mod:`repro_torch.serve.engine`: the continuous-batching engine and
  ``generate``.
- :mod:`repro_torch.serve.handoff`: the train-to-serve handoff, a poller
  that swaps newer checkpoints' parameters in between engine steps.
"""

from repro_torch.serve.engine import (EngineConfig, Request, RequestResult,  # noqa: F401
                                      ServeEngine, generate)
from repro_torch.serve.handoff import CheckpointPoller  # noqa: F401
from repro_torch.serve.kv_cache import (BlockAllocator, PagedCacheConfig,  # noqa: F401
                                        paged_supported)
