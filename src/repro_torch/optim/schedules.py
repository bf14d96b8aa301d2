"""Inner learning-rate schedules (``repro/optim/schedules.py``): cosine
(Table I), WSD (MiniCPM), constant.

Computed on the host in numpy fp32, one operation at a time as the
reference's traced fp32 graph does; ``np.cos`` and XLA's cos may differ by
an ulp.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import TrainConfig

_F = np.float32


def lr_at(tc: TrainConfig, step: int) -> np.float32:
    """Inner LR at ``step`` (0-based), as an fp32 scalar."""
    s = _F(step)
    total = _F(tc.total_steps)
    warm = np.maximum(_F(tc.lr_warmup_frac) * total, _F(1.0))
    peak = _F(tc.inner_lr)
    floor = _F(tc.inner_min_lr)

    warm_lr = peak * (s + _F(1.0)) / warm

    if tc.lr_schedule == "constant":
        main_lr = peak
    elif tc.lr_schedule == "wsd":
        decay_start = total * _F(1.0 - tc.wsd_decay_frac)
        frac = np.clip((s - decay_start) / np.maximum(total - decay_start, _F(1.0)),
                       _F(0.0), _F(1.0))
        main_lr = peak + (floor - peak) * frac
    else:  # cosine
        prog = np.clip((s - warm) / np.maximum(total - warm, _F(1.0)), _F(0.0), _F(1.0))
        main_lr = floor + _F(0.5) * (peak - floor) * (_F(1.0) + np.cos(_F(np.pi) * prog))

    return _F(warm_lr if s < warm else main_lr)
