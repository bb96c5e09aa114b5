"""Resolution-window selection (reference Window.py).

Copied from repeatresolver_tpu/models/window.py (same functions, same bytes
written and read).

Coverage profile sampled every 100th column, low-coverage ends trimmed
at coverage * average, then `parts` equally spaced boundaries
(Window.py:41-60).
"""
from __future__ import annotations

import numpy as np

from ..config import WindowConfig


def window_boundaries(msa: np.ndarray, cfg: WindowConfig) -> list[int]:
    coverages = (msa[:, ::100] != 5).sum(axis=0)
    average = coverages.sum() // len(coverages)   # int division like py2
    start = 0
    while coverages[start] < cfg.coverage * average:
        start += 1
    start *= 100
    ende = len(coverages) - 1
    while coverages[ende] < cfg.coverage * average:
        ende -= 1
    ende *= 100
    bounds = [start]
    for p in range(cfg.parts):
        bounds.append(start + (p + 1) * (ende - start) // cfg.parts)
    return bounds
