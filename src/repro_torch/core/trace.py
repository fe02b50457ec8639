"""Spans and counters inside the port's search.

A span marks a stretch of one search on the host: the whole call
(``bfs.search``), the loop's start (``bfs.start``), each pod's step in a
level (``bfs.td`` / ``bfs.bu``), each pod's post-level reduction and its
host read (``bfs.tail``), and the stages of the 2D steps (``bfs.expand``,
``bfs.discover``, ``bfs.fold``, ``bfs.exchange``, ``bfs.update``).

Whether a search is traced is decided once, when ``BFSEngine.search`` or
``search_batch`` opens ``search``: one read of the active ``Recorder``
and one ``torch.autograd._profiler_enabled()`` call.  The decision, a
``Search`` or None, is handed down: the level loop reads it once
(``current``) and passes it to the steps in their level values
(``lv["trace"]``).  Then:

  * traced by nothing: every span site is one Python branch that takes
    ``OFF``, a shared no-op context; no torch call, no allocation, no
    device work, no host read;
  * under ``torch.profiler``: each span opens a record-function range
    named ``name`` (``profiler_range``), so it lands on the profiler's
    clock beside the device operations
    (any ``torch.profiler`` trace of a search shows them); names only,
    no counter, nothing launched on the card;
  * inside a ``Recorder``: each span is kept in memory with its start
    and end (``time.perf_counter_ns``), its parent, its search and its
    attributes, and the counters are kept: the loop's levels, top-down
    and bottom-up levels and host reads a search, the launches of the
    2D level epilogue kernel (``level_epilogues``, counted by its
    wrapper; its plain twin counts nothing), the per-device bytes of
    every collective the search issues (``wire_bytes``, each the
    ``nbytes`` of its ``collectives.Record``; while no
    ``collectives.ScheduleRecorder`` is active a Recorder opens one
    whose records it drops, so that the collectives reach the count),
    and kernel 2's own count of the edges it loads (``device_word``),
    one device word a launch, read once when the Recorder exits.

Recorders nest as ``collectives.ScheduleRecorder`` does: the inner one
records, and the outer one resumes when it exits.

    from repro_torch.core import trace
    with trace.Recorder() as rec:
        engine.search(root)
    rec.spans, rec.counters, rec.calls
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
# the profiler's range of a span: PyTorch's fast record-function context,
# the one ``torch.compile``'s generated code opens; under the profiler it
# costs the host about a seventh of ``torch.autograd.profiler.
# record_function`` (2 against 15 us a span on a CPU), and its ranges are
# the same user annotations in ``prof.events()``
from torch._C._profiler import _RecordFunctionFast as profiler_range

# the span of a site that nothing traces: one shared no-op context
OFF = nullcontext()

# kernel 2's count of the edges it loads, one device word a launch
BOTTOMUP_LOADED = "bottomup_loaded_edges"
# launches of the 2D level epilogue kernel (kernels/epilogue/ops.py)
LEVEL_EPILOGUES = "level_epilogues"
# per-device bytes of the collectives a search issues (core/collectives.py)
WIRE_BYTES = "wire_bytes"


@dataclass
class Span:
    """One recorded span: ``parent`` is the index of the enclosing span
    in ``Recorder.spans`` (None at a search's top), ``search`` the id
    that every span of one ``search`` call shares."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    search: int
    attrs: Dict[str, Any] = field(default_factory=dict)


class Recorder:
    """Keeps the spans and counters of the searches inside its ``with``
    block.

    ``spans`` in the order they opened; ``counters[search][name]`` the
    counts of each search; ``calls[BOTTOMUP_LOADED]`` kernel 2's counts,
    one a launch in launch order, read when the block exits (each also
    added to its search's counters)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[int, Dict[str, int]] = {}
        self.calls: Dict[str, List[int]] = {}
        self._words: List[Tuple[Optional[int], torch.Tensor]] = []
        self._searches = 0
        self._outer: Optional[Recorder] = None
        self._tap = None

    def __enter__(self) -> "Recorder":
        global _ACTIVE
        from repro_torch.core import collectives
        self._outer, _ACTIVE = _ACTIVE, self
        self._tap = collectives.wire_tap()
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        if self._tap is not None:
            self._tap.__exit__(*exc)
            self._tap = None
        _ACTIVE = self._outer
        self._read_words()

    def _read_words(self) -> None:
        """The device counters, one host read for all of them."""
        if not self._words:
            return
        vals = torch.cat([w for _, w in self._words]).tolist()
        for (sid, _), v in zip(self._words, vals):
            self.calls.setdefault(BOTTOMUP_LOADED, []).append(v)
            if sid is not None:
                self.count(sid, BOTTOMUP_LOADED, v)
        self._words = []

    def new_search(self) -> int:
        sid = self._searches
        self._searches += 1
        self.counters[sid] = {}
        return sid

    def count(self, search: int, name: str, n: int = 1) -> None:
        ctr = self.counters.setdefault(search, {})
        ctr[name] = ctr.get(name, 0) + n


_ACTIVE: Optional[Recorder] = None
_CURRENT: Optional["Search"] = None


class _SpanCtx:
    """One span site's context while tracing is on."""
    __slots__ = ("tr", "name", "attrs", "_rf", "_idx")

    def __init__(self, tr: "Search", name: str, attrs: Dict[str, Any]):
        self.tr, self.name, self.attrs = tr, name, attrs
        self._rf = self._idx = None

    def __enter__(self) -> "_SpanCtx":
        tr = self.tr
        if tr.prof:
            self._rf = profiler_range(self.name)
            self._rf.__enter__()
        if tr.rec is not None:
            stack = tr.stack
            self._idx = len(tr.rec.spans)
            tr.rec.spans.append(Span(self.name, time.perf_counter_ns(), 0,
                                     stack[-1] if stack else None, tr.id,
                                     self.attrs))
            stack.append(self._idx)
        return self

    def __exit__(self, *exc) -> None:
        tr = self.tr
        if self._idx is not None:
            tr.rec.spans[self._idx].end_ns = time.perf_counter_ns()
            tr.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)


class Search:
    """The tracing of one search: made by ``search`` only when a
    ``Recorder`` is active or the profiler is on."""
    __slots__ = ("rec", "prof", "id", "stack")

    def __init__(self, rec: Optional[Recorder], prof: bool):
        self.rec, self.prof = rec, prof
        self.id = rec.new_search() if rec is not None else None
        self.stack: List[int] = []

    def span(self, name: str, **attrs) -> _SpanCtx:
        """A span of this search; ``attrs`` reach the Recorder only."""
        return _SpanCtx(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to this search's counter ``name`` (Recorder only)."""
        if self.rec is not None:
            self.rec.count(self.id, name, n)


class _SearchCtx:
    """``bfs.search``: sets the current search for its block."""
    __slots__ = ("tr", "span", "_outer")

    def __init__(self, tr: Search):
        self.tr, self.span = tr, tr.span("bfs.search")

    def __enter__(self) -> _SpanCtx:
        global _CURRENT
        self._outer, _CURRENT = _CURRENT, self.tr
        return self.span.__enter__()

    def __exit__(self, *exc) -> None:
        global _CURRENT
        try:
            self.span.__exit__(*exc)
        finally:
            _CURRENT = self._outer


def search():
    """The ``bfs.search`` span around one ``search`` / ``search_batch``
    call, and the decision for every span and counter inside it: the
    context yields the open span (its attributes go in ``span.attrs``),
    or None when nothing traces the search."""
    rec = _ACTIVE
    prof = torch.autograd._profiler_enabled()
    if rec is None and not prof:
        return OFF
    return _SearchCtx(Search(rec, prof))


def current() -> Optional[Search]:
    """The traced search in progress, or None."""
    return _CURRENT


def device_word(device: torch.device) -> Optional[torch.Tensor]:
    """A fresh zeroed int64 device word for one launch's count of kernel
    2's loaded edges while a Recorder is active (kept by it, read when
    it exits), else None: the kernel then counts nothing."""
    rec = _ACTIVE
    if rec is None:
        return None
    w = torch.zeros(1, dtype=torch.int64, device=device)
    cur = _CURRENT
    sid = cur.id if cur is not None and cur.rec is rec else None
    rec._words.append((sid, w))
    return w
