"""topdown_ms: device ms a search of the top-down levels: the busy union
of each ``bfs.td`` level's device operations, those after the read that
closed the level before it up to the level's own last read
(``bench/spans.py``), over the traced window's searches.  Reads nothing
without the port's spans, or where a level mixes directions."""
from bench import spans


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    busy = spans.Window(t).level_busy()
    return None if busy is None else busy["td"] * 1e-3 / t.searches
