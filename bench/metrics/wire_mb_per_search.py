"""wire_mb_per_search: the per-device megabytes (10^6 bytes) of the
collectives a search issues, averaged over the searches of a third cycle
of the same keys.

The bytes are the port's own count: inside a ``repro_torch.core.trace``
Recorder, which this reader's ``wrap`` opens, each collective of a
search adds the per-device bytes of its output (``collectives.Record.
nbytes``) to the search's ``wire_bytes`` counter.  On one card the
collectives are tensor ops with no wire; the count is the volume a
deployment of as many processes would move.  Where the program has no
Recorder or no such counter, the metric reads nothing.  A reader whose
Recorder opens after this one's in the same cycle would take the counts
(Recorders nest, the inner one records)."""
import contextlib
import importlib

NAME = "wire_mb_per_search"
TRACE = "repro_torch.core.trace"
COUNTER = "wire_bytes"


@contextlib.contextmanager
def wrap(run):
    out = run.records.setdefault(NAME, [])
    try:
        trace = importlib.import_module(TRACE)
    except ImportError:
        trace = None
    if not hasattr(trace, "Recorder"):
        yield
        return
    with trace.Recorder() as rec:
        yield
    out.extend(c.get(COUNTER) for c in rec.counters.values())


def read(run):
    counts = run.records.get(NAME)
    if not counts or any(c is None for c in counts):
        return None
    return sum(counts) / len(counts) * 1e-6
