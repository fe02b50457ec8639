"""TEPS accounting as the paper's §7.2 defines it: input edges / runtime,
harmonic mean over the roots."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def teps(m_input_edges: int, seconds: float) -> float:
    return m_input_edges / max(seconds, 1e-12)


def harmonic_mean(xs: Sequence[float]) -> float:
    xs = np.asarray([x for x in xs if x > 0], dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(xs.size / np.sum(1.0 / xs))
