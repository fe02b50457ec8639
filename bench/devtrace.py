"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer readers need: every device operation (kernels, copies, fills)
inside the window with its start and end, the busy union, the window's
length, the device operations that took most time, and the idle gaps
labelled by what the host was doing (the innermost host span open at the
gap, inside the spans that ``run.py`` opens around its calls).

Times are the profiler's microseconds; the reductions return seconds.
"""
from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

SPAN_PREFIX = "bench."        # the spans run.py opens
WINDOW = SPAN_PREFIX + "window"   # the span around the traced window
NAME_LEN = 160                # names in the breakdown are cut to this


def kernel_names(csrc: Path) -> List[str]:
    """The names of the ``__global__`` functions in a CUDA source tree."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    return sorted(names)


def matcher(names: Iterable[str]):
    """A predicate: does a profiler kernel name call one of ``names``
    (the identifier followed by its template or argument list)?"""
    names = list(names)
    if not names:
        return lambda _name: False
    pat = re.compile(r"(?<![A-Za-z0-9_])(?:" + "|".join(map(re.escape,
                                                          names))
                     + r")(?=[<(\s]|$)")
    return lambda name: pat.search(name) is not None


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """The traced window of one run."""

    def __init__(self, prof, searches: int):
        from torch.autograd import DeviceType
        self.searches = searches
        host, dev = [], []
        window = None
        for ev in prof.events():
            rng = (ev.name, ev.time_range.start, ev.time_range.end)
            if ev.device_type == DeviceType.CPU:
                host.append((ev.thread,) + rng)
                if ev.name == WINDOW:
                    window = (ev.thread, rng[1], rng[2])
        if window is None:
            raise RuntimeError(f"no {WINDOW!r} span in the trace")
        thread, self.t0, self.t1 = window
        for ev in prof.events():
            # the spans opened around the calls show on the device's
            # timeline too, as annotations: they are not operations
            if ev.device_type == DeviceType.CUDA and not (
                    getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(SPAN_PREFIX)):
                s = max(ev.time_range.start, self.t0)
                e = min(ev.time_range.end, self.t1)
                if e > s:
                    dev.append((ev.name, s, e))
        self.ops = dev
        self.host = sorted(((n, s, e) for t, n, s, e in host
                            if t == thread and e > self.t0 and s < self.t1),
                           key=lambda x: (x[1], -x[2]))
        self.busy = _merge([(s, e) for _, s, e in dev])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def seconds(self, pick=None) -> float:
        """Device seconds of the operations whose name ``pick`` accepts
        (all of them without one)."""
        return sum(e - s for n, s, e in self.ops
                   if pick is None or pick(n)) * 1e-6

    def count(self, pick) -> int:
        return sum(1 for n, _, _ in self.ops if pick(n))

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by[n[:NAME_LEN]] += (e - s) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The window's idle time by what the host was doing: each gap
        between busy spans goes to the innermost host span open at its
        middle (``outer > inner`` where the inner one is a runtime call),
        summed by label."""
        edges = [self.t0] + [x for s, e in self.busy for x in (s, e)] \
            + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        by: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[str, float, float]] = []
        i = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(self.host) and self.host[i][1] <= mid:
                while stack and stack[-1][2] <= self.host[i][1]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            by[_label(stack)] += (b - a) * 1e-6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])
                [:top]]


def _label(stack) -> str:
    if not stack:
        return "(no host span)"
    inner = stack[-1][0]
    if len(stack) > 1 and not inner.startswith(("aten::", "bench.")):
        return f"{stack[-2][0]} > {inner}"[:NAME_LEN]
    return inner[:NAME_LEN]
