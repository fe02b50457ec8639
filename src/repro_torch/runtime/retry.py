"""Bounded capacity-escalation retry: shared types for self-healing
plan loops.

A capacity knob (``cap_x`` for the 1ds expand buckets) was sized from a
model, the run overflowed it, and instead of aborting the loop escalates
the knob geometrically (x2 per attempt, bounded attempts), rebuilds the
session and retries.  This module holds the exception and the structured
per-attempt log entries of such loops (``core/engine.py::
run_bfs_healed``), the JAX package's ``runtime/retry.py`` type for type,
so both packages report recovery identically.

Pure host bookkeeping: nothing here touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class RetryAttempt:
    """One attempt in an escalation loop.

    ``cap_name``/``cap_value`` identify the knob as it was for this
    attempt; ``outcome`` is ``"ok"``, ``"overflow"``, or ``"error"``;
    ``detail`` carries knob-specific context (overflowing levels, route
    counts, ...).
    """
    attempt: int
    cap_name: str
    cap_value: Any
    outcome: str
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"attempt": self.attempt, "cap_name": self.cap_name,
                "cap_value": self.cap_value, "outcome": self.outcome,
                "detail": dict(self.detail)}


class CapacityOverflow(RuntimeError):
    """A capacity knob overflowed and (if retried) escalation ran dry.

    Subclasses RuntimeError so existing ``pytest.raises(RuntimeError,
    match="route_slack")`` style call sites keep working.  Carries the
    knob identity and the full escalation history so a final failure
    reports every attempt, not just the last.
    """

    def __init__(self, message: str, *, cap_name: str = "",
                 cap_value: Any = None,
                 history: Optional[List[RetryAttempt]] = None):
        if history:
            trail = "; ".join(
                f"attempt {a.attempt}: {a.cap_name}={a.cap_value} -> "
                f"{a.outcome}" for a in history)
            message = f"{message} [escalation history: {trail}]"
        super().__init__(message)
        self.cap_name = cap_name
        self.cap_value = cap_value
        self.history: Tuple[RetryAttempt, ...] = tuple(history or ())

    def history_json(self) -> List[Dict[str, Any]]:
        return [a.to_json() for a in self.history]


def escalate(value, *, factor: int = 2, ceiling=None):
    """Next knob value: geometric growth, optionally clamped."""
    nxt = value * factor
    if ceiling is not None:
        nxt = min(nxt, ceiling)
    return nxt
