"""level_epilogue_roofline: the 2D level epilogue's share of its
roofline, in %: the least time the bytes its launches need take at HBM
bandwidth over its device time in the traced window.

A launch needs (a frozen copy of ``kernels/epilogue/ops.py::
level_bytes``): the parents read once (4 B a vertex) and the frontier
words written (1/8 B a vertex); for each unvisited vertex its degree
and its first candidate (4 B each, no candidate at a search's start,
whose one candidate is the root); for each vertex still unfound after
a slot, the next slot of the bottom-up exchange (4 B); and each newly
found parent written (4 B).

The counts come from a third cycle of the same keys, with the launch
``kernels/epilogue/ops.py::launch`` wrapped from here (each call's
inputs read before it updates the parents); the searches are
deterministic, so its calls are the traced window's.  Where the launch
is gone (a tree without the epilogue), or the calls and the kernel's
launches disagree in number, the metric reads nothing."""
import contextlib
import importlib

import torch

from bench.costs import HBM_BYTES_PER_S
from bench.devtrace import matcher

NAME = "level_epilogue_roofline"
ENTRY = ("repro_torch.kernels.epilogue.ops", "launch")
KERNEL = "level_epilogue_kernel"
INT_INF = 2**31 - 1


def launch_bytes(n: int, unvisited: int, newly: int, slot_reads: int,
                 start: bool) -> int:
    """Bytes one launch needs over ``n`` vertices (see the module)."""
    cand = 0 if start else 4 * unvisited
    return (4 * n + n // 8 + 4 * unvisited + cand + 4 * slot_reads
            + 4 * newly)


def counts(pi, cand=None, recv=None, root: int = -1) -> torch.Tensor:
    """(unvisited, newly, slot reads) of one launch on its inputs, before
    it runs, as a device tensor: slot 0 is ``cand`` (the root at the
    start, with ``cand`` None), slot s > 0 of block (i, q) is ``recv[i,
    q, (q + s) mod pc]``, first find wins."""
    unvisited = pi == -1
    if cand is None:
        still = unvisited.clone()
        if 0 <= root < pi.numel():
            still.view(-1)[root] = False
    else:
        still = unvisited & (cand == INT_INF)
    reads = torch.zeros((), dtype=torch.int64, device=pi.device)
    if recv is not None:
        pc = pi.shape[1]
        jj = torch.arange(pc, device=pi.device)
        for s in range(1, pc):
            reads = reads + still.sum()
            still &= recv[:, jj, (jj + s) % pc] == INT_INF
    n_un = unvisited.sum()
    return torch.stack([n_un, n_un - still.sum(), reads])


@contextlib.contextmanager
def wrap(run):
    rec = run.records.setdefault(NAME, [])
    try:
        mod = importlib.import_module(ENTRY[0])
    except ImportError:
        mod = None
    fn = getattr(mod, ENTRY[1], None)
    if fn is None:
        yield
        return

    def recorded(pi, deg, cand=None, recv=None, root=-1, *a, **kw):
        rec.append((pi.numel(), cand is None,
                    counts(pi, cand, recv, root)))
        return fn(pi, deg, cand, recv, root, *a, **kw)

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
    vals = torch.stack([c for *_, c in rec]).tolist()
    nbytes = sum(launch_bytes(n, un, newly, reads, start)
                 for (n, start, _), (un, newly, reads) in zip(rec, vals))
    dev_s = t.seconds(pick)
    return 100.0 * nbytes / HBM_BYTES_PER_S / dev_s if dev_s > 0 else None
