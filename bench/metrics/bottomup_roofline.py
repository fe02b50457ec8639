"""bottomup_roofline: kernel 2's share of its roofline, in %: the
least time the bytes its calls need take at HBM bandwidth (a frozen copy
of ``bottomup_bytes``: the row pointers, the completed flags, each live
row's edges up to its first frontier hit, the frontier words and the
output) over its device time in the traced window.

The bytes come from a third cycle of the same keys, with the entry
``kernels/bottomup/ops.py::bottomup_substep`` wrapped from here (each
call's inputs read before it runs); the searches are deterministic, so
its calls are the traced window's.  Where the entry is gone, or the
calls and the launches disagree in number, the metric reads nothing."""
import contextlib
import importlib

from bench.costs import HBM_BYTES_PER_S, bottomup_bytes
from bench.devtrace import matcher

NAME = "bottomup_roofline"
ENTRY = ("repro_torch.kernels.bottomup.ops", "bottomup_substep")
KERNEL = "bottomup_substep_kernel"


@contextlib.contextmanager
def wrap(run):
    mod = importlib.import_module(ENTRY[0])
    fn = getattr(mod, ENTRY[1], None)
    rec = run.records.setdefault(NAME, [])
    if fn is None:
        yield
        return

    def recorded(rp_seg, ue_win, f_words, cvec, *a, **kw):
        rec.append(bottomup_bytes(rp_seg, ue_win, f_words, cvec)[0])
        return fn(rp_seg, ue_win, f_words, cvec, *a, **kw)

    setattr(mod, ENTRY[1], recorded)
    try:
        yield
    finally:
        setattr(mod, ENTRY[1], fn)


def read(run):
    rec = run.records.get(NAME)
    t = run.trace
    if not rec or t is None or not t.ops:
        return None
    pick = matcher([KERNEL])
    if t.count(pick) != len(rec):
        return None
    dev_s = t.seconds(pick)
    return 100.0 * sum(rec) / HBM_BYTES_PER_S / dev_s if dev_s > 0 else None
