"""Plain oracles for the top-down local discovery (Alg. 3, lines 8-10):
SpMSV in the (select-source, min) semiring over one 2D block.

``spmsv_dense`` is edge-parallel over the whole block (work O(nnz)
whatever the frontier) and is what the ``local_mode="dense"`` sessions
run; ``scatter_min`` is the sparse accumulator that reduces gathered
(cap_f, maxdeg) destination rows, -1 padded, to candidates.  Twins of the
JAX package's ``kernels/spmsv/ref.py::spmsv_dense`` and
``kernels/spmsv/ops.py::_scatter_min``.
"""
from __future__ import annotations

import torch

from repro_torch.core.frontier import INT_INF


def spmsv_dense(edge_src: torch.Tensor,   # (cap,) i32 local source col, CSC order
                row_idx: torch.Tensor,    # (cap,) i32 local dest row
                nnz: torch.Tensor,        # 0-d i32 true block nnz
                f_cj: torch.Tensor,       # (nc,) bool frontier slice
                nr: int,
                col_offset: int,          # j*nc
                ) -> torch.Tensor:
    dev = edge_src.device
    e_mask = torch.arange(edge_src.shape[0], device=dev) < nnz
    active = e_mask & f_cj[edge_src.to(torch.int64)]
    vals = torch.where(active, edge_src + col_offset, INT_INF)
    out = torch.full((nr,), INT_INF, dtype=torch.int32, device=dev)
    return out.scatter_reduce_(0, row_idx.to(torch.int64), vals.to(torch.int32),
                               reduce="amin")


def scatter_min(dst: torch.Tensor, ids: torch.Tensor, col_offset: int,
                nr: int) -> torch.Tensor:
    """(cap_f, maxdeg) gathered dest rows (-1 = none) + the frontier ids
    they came from -> (nr,) candidate parents."""
    parent = (col_offset + ids).to(torch.int32)[:, None]
    valid = dst >= 0
    vals = torch.where(valid, parent.expand(dst.shape), INT_INF)
    flat_dst = torch.where(valid, dst, 0).reshape(-1).to(torch.int64)
    out = torch.full((nr,), INT_INF, dtype=torch.int32, device=dst.device)
    return out.scatter_reduce_(0, flat_dst, vals.reshape(-1).to(torch.int32),
                               reduce="amin")
