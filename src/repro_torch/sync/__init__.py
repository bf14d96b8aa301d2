"""The outer-sync layer of the port (``repro/sync``): the flat fp32 mean and
the compressed, hierarchical and chunked strategies, in the simulator's
numeric model and (all but chunked) as the multi-process Trainer's
exchange; the weighted reductions of elastic membership; the delay and
sync controllers behind ``sync_delay="auto"``; and the membership state
machine. It exports what ``repro.sync`` exports, less ``Sharded``."""

from repro_torch.sync.base import (OuterSyncStrategy, PendingReduce, ReduceCtx,  # noqa: F401
                                   SyncPlan, balanced_spans, weighted_psum_mean,
                                   weighted_stack_mean)
from repro_torch.sync.controller import (AdaptiveSyncController,  # noqa: F401
                                         DelayDecisionAdapter, ScriptedSyncController,
                                         SyncController, SyncDecision, default_ladder)
from repro_torch.sync.delay import (DelayController, FixedDelayController,  # noqa: F401
                                    MeasuredDelayController, ModelDelayController)
from repro_torch.sync.membership import (ChurnEvent, ChurnSchedule,  # noqa: F401
                                         EventMembership, MembershipController)
from repro_torch.sync.strategies import (PORTED, Chunked, FlatFP32,  # noqa: F401
                                         Hierarchical, Int8Wire, Quantized,
                                         resolve_strategy, strategy_name,
                                         validate_pod_grouping)

__all__ = [
    "OuterSyncStrategy", "PendingReduce", "ReduceCtx", "SyncPlan",
    "balanced_spans", "weighted_psum_mean", "weighted_stack_mean",
    "AdaptiveSyncController", "DelayDecisionAdapter",
    "ScriptedSyncController", "SyncController", "SyncDecision",
    "default_ladder",
    "DelayController", "FixedDelayController", "MeasuredDelayController",
    "ModelDelayController",
    "ChurnEvent", "ChurnSchedule", "EventMembership",
    "MembershipController",
    "Chunked", "FlatFP32", "Hierarchical", "Int8Wire", "Quantized",
    "PORTED", "resolve_strategy", "strategy_name", "validate_pod_grouping",
]
