"""Top-down SpMSV over the CSC column segments of the frontier columns,
fused with the min: the wrapper of the CUDA kernel
``csrc/spmsv_csr_min.cu`` and its plain PyTorch version.

The wrapper takes the frontier as a mask over the block's columns; both
versions read the compacted column ids and the segments through the
uncompressed ``col_ptr``.  The shared launch prep (``prepare``) is plain
torch, so the CPU tests cover it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.frontier import INT_INF
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("spmsv_csr_min", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])

_BLOCK = 256
_MAX_GRID = 132 * 16       # grid-stride beyond this many blocks


def segment_offsets(ids: torch.Tensor, col_ptr: torch.Tensor
                    ) -> Tuple[torch.Tensor, int]:
    """Exclusive prefix sum (int64, length n_ids+1) of the segment lengths
    of the columns ``ids``, and its total, read to the host.  The ids must
    lie in [0, n_cols): ``prepare`` takes them from a mask, so they do."""
    offs = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=ids.device)
    if ids.shape[0] == 0:
        return offs, 0
    torch.cumsum(col_ptr[ids + 1] - col_ptr[ids], 0, out=offs[1:])
    return offs, int(offs[-1])


def prepare(f_mask: torch.Tensor, col_ptr: torch.Tensor, cap_f: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The launch prep shared by the kernel and its plain version: the
    frontier's column ids (int32, ascending), their ``segment_offsets``
    and the edge total.  ``cap_f > 0`` bounds the frontier: a larger one
    raises (the JAX package's kernel truncated it silently)."""
    ids = torch.nonzero(f_mask).reshape(-1).to(torch.int32)
    if cap_f and ids.shape[0] > cap_f:
        raise ValueError(f"frontier of {ids.shape[0]} columns exceeds "
                         f"cap_f={cap_f}")
    offs, total = segment_offsets(ids, col_ptr)
    return ids, offs, total


def _check(f_mask, col_ptr, row_idx, nr):
    for name, t in (("col_ptr", col_ptr), ("row_idx", row_idx)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if f_mask.dtype != torch.bool or f_mask.shape != (col_ptr.shape[0] - 1,):
        raise ValueError(f"f_mask must be a bool mask over the block's "
                         f"{col_ptr.shape[0] - 1} columns, got {f_mask.dtype} "
                         f"{tuple(f_mask.shape)}")
    if nr <= 0:
        raise ValueError(f"nr={nr} must be positive")


def spmsv_csr_min_plain(ids, offs, total, col_ptr, row_idx, nr: int,
                        col_offset: int) -> torch.Tensor:
    """Expand every frontier column into its edges, then scatter-min the
    global source ids into the (nr,) candidates."""
    dev = ids.device
    out = torch.full((nr,), INT_INF, dtype=torch.int32, device=dev)
    if total == 0:
        return out
    lens = offs[1:] - offs[:-1]
    col = torch.repeat_interleave(ids.to(torch.int64), lens)
    k = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), lens)
    pos = col_ptr[col].to(torch.int64) + (torch.arange(total, device=dev)
                                          - offs[k])
    v = row_idx[pos].to(torch.int64)
    return out.scatter_reduce_(0, v, (col + col_offset).to(torch.int32),
                               reduce="amin")


def launch(ids, offs, total, col_ptr, row_idx, nr: int,
           col_offset: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors from ``prepare``: the (nr,)
    candidates, with a grid sized from the frontier's edge total."""
    cand = torch.full((nr,), INT_INF, dtype=torch.int32, device=ids.device)
    if total:
        grid = min(_MAX_GRID, (total + _BLOCK - 1) // _BLOCK)
        KERNEL.launch(ids.data_ptr(), offs.data_ptr(), col_ptr.data_ptr(),
                      row_idx.data_ptr(), cand.data_ptr(), ids.shape[0],
                      total, col_offset, grid, stream_handle(ids.device))
    return cand


def spmsv_csr_min(f_mask: torch.Tensor, col_ptr: torch.Tensor,
                  row_idx: torch.Tensor, nr: int, col_offset: int,
                  cap_f: int = 0) -> torch.Tensor:
    """(nr,) int32 candidates: for each local dest row, the smallest
    global source id ``col_offset + u`` over the frontier columns u of
    ``f_mask`` with an edge u -> row, else INT_INF.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(f_mask, col_ptr, row_idx, nr)
    tensors = (f_mask, col_ptr, row_idx)
    if all(t.device.type == "cpu" for t in tensors):
        return spmsv_csr_min_plain(*prepare(f_mask, col_ptr, cap_f), col_ptr,
                                   row_idx, nr, col_offset)
    KERNEL.load()
    require_cuda(*tensors)
    return launch(*prepare(f_mask, col_ptr, cap_f), col_ptr, row_idx, nr,
                  col_offset)
