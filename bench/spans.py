"""The level partition of a traced window, read from the port's own spans
(``repro_torch/core/trace.py``) and the device operations.

``run.trace.host`` holds the window thread's host spans ``(name, start,
end)``, sorted by start, and ``run.trace.ops`` the device operations
``(name, start, end)``, both in the profiler's microseconds.  Inside
each search (``bfs.search``) the port opens ``bfs.start`` (the loop's
entry and its first reduction), then, a level at a time, each pod's step
(``bfs.td`` or ``bfs.bu``) and each pod's reduction with its host read
(``bfs.tail``).  A level runs from its first step to the end of its last
``bfs.tail``.

Each ``bfs.tail`` reads the card once: one device-to-host copy, which
waits for all the work queued before it.  So the device operations of a
level are those after the read that closed the level before it (or the
start) up to its own last read, in the order the card ran them, and no
other level's.  The partition takes the host spans for the levels'
order and directions, and the reads' copies on the device for the
boundaries: the profiler's device times can lag or lead its host times
by up to milliseconds (measured on an NVIDIA H100), so a device
operation is not placed by comparing its time with a host span's.  The
copies pair with the ``bfs.tail`` spans in order; where the window's
clip has cut copies off at either end, the pairing takes the offset at
which the copies' ends keep the steadiest distance to their spans' ends
(a pair one read off is a level's time, milliseconds, away).

A program without these spans (one older than them) yields no level and
no read, and the readers then read nothing.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Tuple

SEARCH, START, TAIL = "bfs.search", "bfs.start", "bfs.tail"
STEPS = {"bfs.td": "td", "bfs.bu": "bu"}
READ = "Memcpy DtoH"        # the device side of a host read


class Window:
    """The traced window's levels and reads on both clocks."""

    def __init__(self, trace):
        self.trace = trace
        self.ops = sorted(trace.ops, key=lambda op: op[1])
        self.tails: List[Tuple[float, float]] = []
        # [directions, first tail, last tail] of each level, host order
        self.levels: List[list] = []
        cur = None
        for name, s, e in trace.host:
            if name in (SEARCH, START):
                cur = None
            elif name in STEPS:
                if cur is None or cur[2] is not None:
                    cur = [set(), None, None]
                    self.levels.append(cur)
                cur[0].add(STEPS[name])
            elif name == TAIL:
                self.tails.append((s, e))
                if cur is not None:
                    if cur[1] is None:
                        cur[1] = len(self.tails) - 1
                    cur[2] = len(self.tails) - 1
        copies = [i for i, (n, _, _) in enumerate(self.ops) if READ in n]
        # tail index -> index in ``ops`` of its read's copy; None where
        # the window holds no copy or more copies than the loop's reads
        self.copy: Optional[Dict[int, int]] = None
        n, m = len(self.tails), len(copies)
        if 0 < m <= n:
            ends = [self.ops[c][2] for c in copies]
            first = min(range(n - m + 1), key=lambda a: _spread(
                [x - self.tails[a + j][1] for j, x in enumerate(ends)]))
            self.copy = {first + j: c for j, c in enumerate(copies)}

    def level_busy(self) -> Optional[Dict[str, float]]:
        """Device busy microseconds (the union) of each level's
        operations, summed by the level's direction; None if a level
        holds both directions, or there is no level or no pairing."""
        if self.copy is None or not self.levels:
            return None
        out = {"td": 0.0, "bu": 0.0}
        for dirs, first, last in self.levels:
            if len(dirs) > 1:
                return None
            if last is None or first - 1 not in self.copy \
                    or last not in self.copy:
                continue
            reach = float("-inf")
            for _, s, e in self.ops[self.copy[first - 1] + 1:
                                    self.copy[last] + 1]:
                lo = max(s, reach)
                if e > lo:
                    out[next(iter(dirs))] += e - lo
                    reach = e
        return out

    def tail_gaps(self) -> Optional[List[float]]:
        """For each ``bfs.tail`` that another span of its search follows:
        the card's idle microseconds from the end of its read's copy to
        the start of the next device operation; None if there is no
        pairing."""
        if self.copy is None:
            return None
        host = self.trace.host
        searches = [(s, e) for n, s, e in host if n == SEARCH]
        marks = sorted(s for n, s, _ in host
                       if n in STEPS or n in (START, TAIL))
        busy = self.trace.busy
        ends = [e for _, e in busy]
        out: List[float] = []
        for i, (s, e) in enumerate(self.tails):
            owner = [se for ss, se in searches if ss <= s and e <= se]
            nxt = bisect.bisect_left(marks, e)
            c = self.copy.get(i)
            if (not owner or nxt == len(marks) or marks[nxt] >= owner[0]
                    or c is None or c + 1 >= len(self.ops)):
                continue
            out.append(idle_between(busy, ends, self.ops[c][2],
                                    self.ops[c + 1][1]))
        return out


def _spread(xs: List[float]) -> float:
    """The median absolute deviation of ``xs`` from their median."""
    mid = statistics.median(xs)
    return statistics.median(abs(x - mid) for x in xs)


def idle_between(busy, ends, start: float, end: float) -> float:
    """Idle microseconds of the card in [start, end): the interval less
    the busy union ``busy`` (``ends`` its intervals' ends) inside it."""
    idle = end - start
    i = bisect.bisect_right(ends, start)
    while i < len(busy) and busy[i][0] < end:
        s, e = busy[i]
        idle -= min(e, end) - max(s, start)
        i += 1
    return max(idle, 0.0)
