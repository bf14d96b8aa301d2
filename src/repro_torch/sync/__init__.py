"""The outer-sync strategy layer of the port (``repro/sync``): the flat
fp32 mean and the compressed, hierarchical and chunked strategies, in the
simulator's numeric model and (all but chunked) as the multi-process
Trainer's exchange."""

from repro_torch.sync.base import (OuterSyncStrategy, PendingReduce, ReduceCtx,  # noqa: F401
                                   SyncPlan, balanced_spans)
from repro_torch.sync.strategies import (PORTED, Chunked, FlatFP32,  # noqa: F401
                                         Hierarchical, Int8Wire, Quantized,
                                         resolve_strategy, strategy_name,
                                         validate_pod_grouping)
