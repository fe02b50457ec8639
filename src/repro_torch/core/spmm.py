"""2D-partitioned SpMM: the BFS machinery generalized to feature
aggregation (sum semiring, d-wide payloads), the JAX package's
``core/spmm.py`` on the simulated mesh (``launch/mesh.py``).

The same schedule as the top-down BFS step:

  expand : TransposeVector (collective permute) + a tiled all-gather
           along the processor column -> the sender features X[C_j]
           (nc, d) of every block
  local  : an edge-parallel gather + segment sum into the row strip
           (nr, d) over each block's ``nnz`` live edges
  fold   : a combining reduce-scatter (``psum_scatter``) along the
           processor row, back to layout A

Every array carries the grid as its two leading dims (``(pr, pc, ...)``)
and each exchange is one recorded collective of ``core/collectives.py``.
The aggregation is plain PyTorch (a gather and ``index_add``), as the
JAX package's is XLA outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import collectives
from repro_torch.core.collectives import COL, GRID_2D
from repro_torch.core.partition import Partition2D
from repro_torch.graph.formats import BlockedGraph


def make_spmm_fn(part: Partition2D, device) -> Callable:
    """fn(graph, x_blocks (pr, pc, chunk, d)) -> y_blocks, both in layout
    A: y[v] = sum over edges u -> v of x[u]."""
    perm = collectives.perm_index(part.transpose_perm(), device)
    pr, pc, nr, nc = part.pr, part.pc, part.nr, part.nc

    def spmm(graph: BlockedGraph, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        # expand: A -> B layout, then the column strip C_j of every block
        xb = collectives.ppermute(x, perm)
        x_cj = collectives.all_gather_rows(xb)        # (pr, pc, nc, d) view
        cols = x_cj[0].reshape(pc * nc, d)            # the same for every i
        # local: edge-parallel segment sum into each block's row strip,
        # over the live edges alone (the padding past nnz adds zeros; on
        # one card all blocks share it, and R-MAT's heaviest block sets a
        # capacity several times the mean)
        cap = graph.edge_src.shape[-1]
        live = torch.arange(cap, device=x.device) < graph.nnz.unsqueeze(-1)
        pos = torch.nonzero(live.reshape(-1)).squeeze(1)
        blk = torch.div(pos, cap, rounding_mode="floor")
        src = graph.edge_src.reshape(-1)[pos].long() + (blk % pc) * nc
        dst = graph.row_idx.reshape(-1)[pos].long() + blk * nr
        del pos, blk
        partial = torch.zeros(pr * pc * nr, d, dtype=x.dtype,
                              device=x.device)
        partial.index_add_(0, dst, cols.index_select(0, src))
        # fold: combining reduce-scatter along the row
        return collectives.psum_scatter_axis(
            partial.reshape(pr, pc, nr, d), GRID_2D, COL)
    return spmm


def spmm_2d(graph: BlockedGraph, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Convenience wrapper: x (n_orig, d) -> the sum-aggregated (n_orig,
    d), on the device of the graph (whose grid ``mesh``, if given, must
    be)."""
    part = graph.part
    if mesh is not None and (mesh.pr, mesh.pc) != (part.pr, part.pc):
        raise ValueError(f"a {part.pr}x{part.pc} graph on a {mesh.pr}x"
                         f"{mesh.pc} mesh")
    dev = graph.edge_src.device
    fn = make_spmm_fn(part, dev)
    xp = torch.zeros(part.n, x.shape[1], dtype=x.dtype, device=dev)
    xp[: part.n_orig] = x
    y = fn(graph, xp.reshape(part.pr, part.pc, part.chunk, x.shape[1]))
    return y.reshape(part.n, x.shape[1])[: part.n_orig]
