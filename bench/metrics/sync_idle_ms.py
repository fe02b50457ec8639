"""sync_idle_ms: the price of the level loop's host reads, in ms a
search: for each ``bfs.tail`` span (a pod's reduction and its read) that
another span of its search follows, the card's idle time from the end of
the read's device-to-host copy (the read drained the queue) to the start
of the next device operation, summed over the traced window
(``bench/spans.py``).  Reads nothing without the port's spans."""
from bench import spans


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    gaps = spans.Window(t).tail_gaps()
    return sum(gaps) * 1e-3 / t.searches if gaps else None
