"""The yardstick's arithmetic: the card's peaks, the bytes a kernel call
needs on its inputs, and TEPS.

Frozen copies, so that a change to the system cannot move the
yardstick: ``forward_cost`` of kernel 1 (``kernels/spmsv/ops.py``),
``bottomup_bytes`` of kernel 2 (``chip_smoke.py``), and ``teps``
(``core/metrics.py``).  The tests hold each copy to
its original at small sizes.  This module imports nothing of the system
under test.
"""
from __future__ import annotations

from typing import Tuple

import torch

# NVIDIA H100 SXM (data sheet): HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def forward_cost(addressing: str, n_ids: int, edges: int, nr: int,
                 p: int = 1, n_words: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-1 call with ``n_ids`` frontier ids and
    ``edges`` frontier edges: the ids and their int64 offsets, each id's
    pointer pair (csr; the strips' one pointer word a (strip, id)) or its
    slot and ``cp`` word (dcsc), one row id an edge, the (p, nr)
    candidates written once, and ``n_words`` frontier words read by the
    prep; no flops (compares and mins)."""
    if addressing == "csr":
        ptrs = 8 * n_ids + 8 * (n_ids + 1) + 4 * n_ids
    elif addressing == "dcsc":
        ptrs = 4 * n_ids + 8 * (n_ids + 1) + 4 * n_ids + 4 * n_ids
    else:
        ptrs = 8 * (p * n_ids + 1) + 4 * p * n_ids + 4 * n_ids
    return 0, ptrs + 4 * edges + 4 * p * nr + 4 * n_words


def bottomup_bytes(rp, uew, fw, cv):
    """Bytes one bottom-up sub-step must move on these inputs: the row
    pointers, the completed flags, each live row's edges up to its first
    frontier hit (all of them without one), the frontier words and the
    output.  Returns (bytes, live rows, edges read)."""
    dev = rp.device
    rl = (rp[1:] - rp[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(cv.shape[0], device=dev), rl)
    e_idx = torch.arange(rows.numel(), device=dev)
    uu = uew[int(rp[0]): int(rp[0]) + rows.numel()].to(torch.int64)
    hit = ((fw[uu >> 5] >> (uu & 31)) & 1).to(torch.bool)
    first = torch.full((cv.shape[0],), 2**62, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, rows[hit], e_idx[hit],
                                                   "amin")
    lo = rp[:-1].to(torch.int64) - int(rp[0])
    need = torch.where(first < 2**62, first - lo + 1, rl)
    live = cv == 0
    read, n_live = torch.stack([need[live].sum(), live.sum()]).tolist()
    nbytes = 4 * (cv.numel() + 1) + 4 * cv.numel() + 4 * fw.numel() \
        + 4 * read + 4 * cv.numel()
    return nbytes, n_live, read


def teps(m_input_edges: int, seconds: float) -> float:
    return m_input_edges / max(seconds, 1e-12)
