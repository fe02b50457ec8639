"""bottomup_read_ratio: the edges kernel 2 loads over the edges its
inputs need, summed over its calls in a third cycle of the same keys.

The loads are the kernel's own count: inside a ``repro_torch.core.trace``
Recorder, which this reader's ``wrap`` opens, each launch adds the edges
it loads to a device word of its own, read when the Recorder exits.  The
need is the third value of the frozen ``bottomup_bytes`` (each live
row's edges up to its first frontier hit, all of them without one), on
each call's inputs, read by wrapping the entry
``kernels/bottomup/ops.py::bottomup_substep`` from here.  Where the
program has no Recorder or the entry is gone, or the two lists of calls
differ in length, the metric reads nothing."""
import contextlib
import importlib

from bench.costs import bottomup_bytes

NAME = "bottomup_read_ratio"
ENTRY = ("repro_torch.kernels.bottomup.ops", "bottomup_substep")
TRACE = "repro_torch.core.trace"
LOADED = "bottomup_loaded_edges"


@contextlib.contextmanager
def wrap(run):
    need = run.records.setdefault(NAME, [])
    loaded = run.records.setdefault(NAME + ".loaded", [])
    mod = importlib.import_module(ENTRY[0])
    fn = getattr(mod, ENTRY[1], None)
    try:
        trace = importlib.import_module(TRACE)
    except ImportError:
        trace = None
    if fn is None or not hasattr(trace, "Recorder"):
        yield
        return

    def recorded(rp_seg, ue_win, f_words, cvec, *a, **kw):
        need.append(bottomup_bytes(rp_seg, ue_win, f_words, cvec)[2])
        return fn(rp_seg, ue_win, f_words, cvec, *a, **kw)

    setattr(mod, ENTRY[1], recorded)
    try:
        with trace.Recorder() as rec:
            yield
    finally:
        setattr(mod, ENTRY[1], fn)
    loaded.extend(rec.calls.get(LOADED, []))


def read(run):
    need = run.records.get(NAME)
    loaded = run.records.get(NAME + ".loaded")
    if not need or not loaded or len(need) != len(loaded):
        return None
    total = sum(need)
    return sum(loaded) / total if total > 0 else None
