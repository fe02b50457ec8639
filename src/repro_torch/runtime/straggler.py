"""Deadline-based straggler detection, the JAX package's
``runtime/straggler.py``.

Policy: track a trailing p95 of step wall-times; a step breaching
``factor * p95`` raises a straggler event.  ``BFSEngine.run_many(roots,
monitor=...)`` feeds it one root's wall time a step.  The event is
recorded in ``events`` and handed to ``on_straggler`` when one is given;
what to do about a slow step (re-dispatch, exclusion) is the caller's."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    window: int = 50
    factor: float = 3.0
    min_samples: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self._times: Deque[float] = deque(maxlen=self.window)
        self.events: List[Tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if len(self._times) >= self.min_samples:
            p95 = float(np.percentile(self._times, 95))
            if dt > self.factor * p95:
                self.events.append((step, dt, p95))
                if self.on_straggler is not None:
                    self.on_straggler(step, dt, p95)
                self._times.append(dt)
                return True
        self._times.append(dt)
        return False

    @property
    def deadline(self) -> Optional[float]:
        if len(self._times) < self.min_samples:
            return None
        return self.factor * float(np.percentile(self._times, 95))
