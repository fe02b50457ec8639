"""Vertex partitions: the 1D row strips and the paper's 2D (pr x pc)
Eq. (1) checkerboard.

1D (the Buluc & Madduri baseline): processor i owns the vertex chunk
V_i = [i*chunk, (i+1)*chunk) and the row strip T[V_i, :] -- every edge
into its vertices.  There is one vector layout, so the expand is one
allgather of the frontier and there is no fold or transpose.

2D:

Vertex-vector layouts:

  layout A ("row-aligned"): the n-vector is split into p = pr*pc chunks of
    size ``chunk``; device (i,j) owns chunk k = i*pc + j.  Parents and the
    frontier live here; the fold lands here.

  layout B ("col-aligned"): device (i,j) owns chunk k = j*pr + i, so a
    gather along the processor column reconstructs the column strip
    C_j = [j*nc, (j+1)*nc) -- the expand step.  TransposeVector converts
    A -> B with one permute.

The adjacency block at device (i,j) is T[R_i, C_j] where T[v, u] = 1 iff
edge u->v.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Partition1D:
    """1D row decomposition over ``p`` processors (one mesh axis)."""
    n: int        # padded vertex count
    n_orig: int   # original vertex count
    p: int

    @property
    def chunk(self) -> int:      # owned vertices per processor (= nr)
        return self.n // self.p

    @property
    def nr(self) -> int:         # rows per strip
        return self.chunk

    @property
    def nc(self) -> int:         # cols per strip: all of them
        return self.n


@dataclass(frozen=True)
class Partition2D:
    n: int        # padded vertex count
    n_orig: int   # original vertex count
    pr: int
    pc: int

    @property
    def p(self) -> int:
        return self.pr * self.pc

    @property
    def chunk(self) -> int:
        return self.n // self.p

    @property
    def nr(self) -> int:          # rows per block (R_i size)
        return self.n // self.pr

    @property
    def nc(self) -> int:          # cols per block (C_j size)
        return self.n // self.pc

    def transpose_perm(self):
        """Permute pairs (flat device ids k = i*pc + j) for TransposeVector:
        layout-A chunk k goes to its layout-B owner."""
        return [(k, (k % self.pr) * self.pc + (k // self.pr))
                for k in range(self.p)]


def _padded_n(n_orig: int, p: int, align: int) -> int:
    """n padded so chunk = n/p is a multiple of ``align`` (a multiple of
    32, so bitmap words tile chunks exactly)."""
    if align % 32:
        raise ValueError("align must be a multiple of 32 (bitmap words)")
    quantum = p * align
    return ((max(n_orig, 1) + quantum - 1) // quantum) * quantum


def make_partition(n_orig: int, pr: int, pc: int, align: int = 128) -> Partition2D:
    return Partition2D(n=_padded_n(n_orig, pr * pc, align), n_orig=n_orig,
                       pr=pr, pc=pc)


def make_partition_1d(n_orig: int, p: int, align: int = 128) -> Partition1D:
    """The same padding as ``make_partition``, so a p-strip and a
    (pr, pc) partition with pr*pc == p agree on the padded n."""
    return Partition1D(n=_padded_n(n_orig, p, align), n_orig=n_orig, p=p)
