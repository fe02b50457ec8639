"""grid_exchange_ms: device ms a search of the 2D grid's exchanges in
the top-down levels: in each ``bfs.td`` level of the level partition
(``bench/spans.py``), the busy union of the expand, the device operations
before the level's first kernel-1 ``prep_kernel`` (the word transpose
and the gather along the processor column), and of the stack and fold,
those after its last ``spmsv_walk`` and before its
``level_epilogue_kernel`` (the blocks' candidates stacked, the ring fold
along the processor row), summed over the levels, over the traced
window's searches.

Operations are placed by their order on the card, never by comparing
their times with a host span's.  Reads nothing without the port's spans,
or where a top-down level lacks a kernel that delimits its parts (a
program without the level epilogue)."""
from bench import spans
from bench.devtrace import matcher

PREP, WALK, EPILOGUE = "prep_kernel", "spmsv_walk", "level_epilogue_kernel"


def _busy(ops) -> float:
    """Busy microseconds (the union) of ``ops``, sorted by start."""
    total, reach = 0.0, float("-inf")
    for _, s, e in ops:
        lo = max(s, reach)
        if e > lo:
            total += e - lo
            reach = e
    return total


def level_parts(ops):
    """(expand, stack and fold) of one top-down level's device operations
    in device order, or None where a delimiting kernel is missing."""
    names = [n for n, _, _ in ops]
    prep, walk, epi = (matcher([k]) for k in (PREP, WALK, EPILOGUE))
    first = next((i for i, n in enumerate(names) if prep(n)), None)
    last = max((i for i, n in enumerate(names) if walk(n)), default=None)
    if first is None or last is None:
        return None
    end = next((i for i in range(last + 1, len(names)) if epi(names[i])),
               None)
    if end is None:
        return None
    return ops[:first], ops[last + 1:end]


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    w = spans.Window(t)
    if w.copy is None or not w.levels:
        return None
    total, seen = 0.0, 0
    for dirs, first, last in w.levels:
        if dirs != {"td"} or last is None or first - 1 not in w.copy \
                or last not in w.copy:
            continue
        parts = level_parts(w.ops[w.copy[first - 1] + 1: w.copy[last] + 1])
        if parts is None:
            return None
        total += sum(_busy(p) for p in parts)
        seen += 1
    return total * 1e-3 / t.searches if seen else None
