"""The plain reference: breadth-first search over the raw edge list, in
plain PyTorch, and the comparison that decides ``correct``.

Both configurations state one guarantee of the parents (their
``"guarantees"``): from root r, every vertex reached at depth d > 0 gets
as its parent the least-id neighbour at depth d - 1; r is its own parent
and an unreached vertex has -1.  The system states it too: its top-down
step takes the least frontier source of each row, its bottom-up step the
least frontier neighbour, whatever the direction sequence.  So the
reference's parents are unique, and the comparison is exact.

The reference rebuilds its own graph from the generated pairs (self
loops dropped, both directions kept; duplicates change no level and no
least parent) and runs edge-parallel, in blocks of edges so that its
temporaries stay a few GiB at scale 24.  ``rule="max"`` takes the
greatest-id parent instead: a valid Graph500 tree that breaks the
guarantee, the control.  This module imports nothing of the system under
test.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = 2**31 - 1
BLOCK = 1 << 27          # edges a block


def build(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Both directions of every pair that is not a self loop, int32."""
    keep = src != dst
    s, d = src[keep], dst[keep]
    del keep
    return torch.cat([s, d]), torch.cat([d, s])


def _blocks(m: int):
    return ((lo, min(lo + BLOCK, m)) for lo in range(0, m, BLOCK))


def levels(n: int, src: torch.Tensor, dst: torch.Tensor, root: int
           ) -> torch.Tensor:
    """(n,) int32 depth of every vertex from ``root``, -1 unreached."""
    dev = src.device
    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[root] = 0
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[root] = True
    d = 0
    while True:
        nxt = torch.zeros(n, dtype=torch.bool, device=dev)
        for lo, hi in _blocks(src.shape[0]):
            act = front.index_select(0, src[lo:hi])
            nxt[dst[lo:hi][act]] = True
        nxt &= level < 0
        if not bool(nxt.any()):
            return level
        d += 1
        level[nxt] = d
        front = nxt


def parents(n: int, src: torch.Tensor, dst: torch.Tensor, root: int,
            rule: str = "min") -> torch.Tensor:
    """(n,) int32 parents from ``root`` under the stated guarantee
    (``rule="min"``), or the greatest-id parent one level up
    (``rule="max"``, the control)."""
    level = levels(n, src, dst, root)
    dev = src.device
    fill = INT_MAX if rule == "min" else -1
    reduce = "amin" if rule == "min" else "amax"
    par = torch.full((n,), fill, dtype=torch.int32, device=dev)
    for lo, hi in _blocks(src.shape[0]):
        s, d = src[lo:hi], dst[lo:hi]
        ls = level.index_select(0, s)
        ok = (ls >= 0) & (level.index_select(0, d) == ls + 1)
        del ls
        par.scatter_reduce_(0, d[ok].to(torch.int64), s[ok], reduce=reduce)
    par[level < 0] = -1
    par[root] = root
    return par


def wrong_parents(got: torch.Tensor, want: torch.Tensor) -> int:
    """Vertices whose parent differs (the number compared, limit 0)."""
    return int((got.to(torch.int32) != want).sum())
