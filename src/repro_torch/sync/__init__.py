"""The outer-sync strategy layer of the port (``repro/sync``): so far the
flat fp32 mean of Δθ, the seed collective."""

from repro_torch.sync.base import OuterSyncStrategy, SyncPlan  # noqa: F401
from repro_torch.sync.strategies import (FlatFP32, resolve_strategy,  # noqa: F401
                                         validate_pod_grouping)
