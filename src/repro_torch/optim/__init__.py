"""Inner optimizer of the port: AdamW, global-norm clipping, LR schedules."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedules import lr_at  # noqa: F401
