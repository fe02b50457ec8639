"""Plain oracle for the bottom-up sub-step (Alg. 4, lines 10-16), the twin
of the JAX package's ``kernels/bottomup/ref.py::bottomup_substep``.

Given one rotating segment of ``chunk`` rows (window-rebased CSR pointers
``rp_seg`` and the source-column window ``ue_win``), a packed frontier
bitmap over the block's column range, and the completed mask, produce the
segment's newly discovered parents (global source ids; INT_INF = none).
"""
from __future__ import annotations

import torch

from repro_torch.core.frontier import INT_INF, test_bits


def bottomup_substep(rp_seg: torch.Tensor,   # (chunk+1,) i32, rebased to window
                     ue_win: torch.Tensor,   # (cap_seg,) i32 local source cols
                     f_words: torch.Tensor,  # (nc//32,) i32 frontier bitmap
                     cvec: torch.Tensor,     # (chunk,) i32 completed
                     col_offset: int,        # j*nc
                     n_edges: int,           # window edge count
                     ve_win=None,            # (cap_seg,) i32 per-edge row
                     ) -> torch.Tensor:
    """``ve_win`` (the per-edge local rows, the CSR edge_dst window)
    replaces the searchsorted with a direct read."""
    dev = ue_win.device
    chunk = rp_seg.shape[0] - 1
    cap = ue_win.shape[0]
    eidx = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = eidx < n_edges
    if ve_win is None:
        # row of each window edge (CSR order => rows nondecreasing)
        erow = torch.searchsorted(rp_seg, eidx, right=True) - 1
    else:
        erow = ve_win.to(torch.int64)
    erow = erow.clamp_(0, chunk - 1)
    notdone = (cvec == 0)[erow]
    hit = valid & notdone & test_bits(f_words, ue_win)
    vals = torch.where(hit, ue_win + col_offset, INT_INF).to(torch.int32)
    out = torch.full((chunk,), INT_INF, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, erow, vals, reduce="amin")
    # completed rows can't be rediscovered
    return torch.where(cvec != 0, INT_INF, out)
