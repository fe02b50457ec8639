"""spmsv_roofline: kernel 1's share of its roofline, in %: the least
time the bytes its calls need take at HBM bandwidth (a frozen copy of
``forward_cost`` on each call's frontier ids, edges, rows and frontier
words) over its device time (the prep and walk kernels) in the traced
window.

The bytes come from a third cycle of the same keys, with the entry
``kernels/spmsv/ops.py::spmsv_min`` wrapped from here; the searches are
deterministic, so its calls are the traced window's.  Where the entry
is gone, or the calls and the walk launches disagree in number, the
metric reads nothing."""
import contextlib
import importlib

import torch

from bench.costs import HBM_BYTES_PER_S, forward_cost
from bench.devtrace import matcher

NAME = "spmsv_roofline"
ENTRY = ("repro_torch.kernels.spmsv.ops", "spmsv_min")
WALK, PREP = "spmsv_walk", "prep_kernel"


def _n_ids(frontier: torch.Tensor) -> torch.Tensor:
    if frontier.dtype == torch.bool:
        return frontier.sum(dtype=torch.int64)
    bits = torch.arange(32, device=frontier.device, dtype=torch.int32)
    return ((frontier.unsqueeze(-1) >> bits) & 1).sum(dtype=torch.int64)


@contextlib.contextmanager
def wrap(run):
    mod = importlib.import_module(ENTRY[0])
    fn = getattr(mod, ENTRY[1], None)
    rec = run.records.setdefault(NAME, [])
    if fn is None:
        yield
        return

    def recorded(seg, frontier, nr, *a, **kw):
        cand, edges = fn(seg, frontier, nr, *a, **kw)
        n_words = frontier.shape[0] if frontier.dtype != torch.bool \
            else frontier.shape[0] // 32
        rec.append((seg.addressing, int(nr), n_words,
                    torch.stack([_n_ids(frontier), edges.to(torch.int64)])))
        return cand, edges

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
    counts = torch.stack([c for *_, c in rec]).tolist()
    nbytes = sum(forward_cost(addr, n_ids, edges, nr, n_words=w)[1]
                 for (addr, nr, w, _), (n_ids, edges) in zip(rec, counts))
    if t.count(matcher([WALK])) != len(rec):
        return None
    dev_s = t.seconds(matcher([WALK, PREP]))
    return 100.0 * nbytes / HBM_BYTES_PER_S / dev_s if dev_s > 0 else None
