"""Top-down SpMSV over the CSC column segments of the frontier columns,
fused with the min: the wrappers of the three C entries of the CUDA
kernel ``csrc/spmsv_csr_min.cu`` and their plain PyTorch versions.

  spmsv_csr_min         a 2D block, segments through the uncompressed
                        ``col_ptr``
  spmsv_dcsc_min        a 2D block, segments through the DCSC ``(jc,
                        cp)``: each frontier id is binary-searched in
                        ``jc`` (the paper's hypersparse indirection, §5.1)
  spmsv_strips_csr_min  all p 1D strips at once, segments through the
                        ``(p, n+1)`` strip ``col_ptr``

Each launch prep (``prepare``, ``prepare_dcsc``, ``prepare_strips``) is
plain torch shared by the kernel and its plain version, so the CPU tests
cover it; each reads two values to the host, the frontier's id count and
its edge total, which sizes the grid.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.frontier import INT_INF, unpack_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("spmsv_csr_min", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])
KERNEL_DCSC = CudaKernel("spmsv_dcsc_min", [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p], stem="spmsv_csr_min")
KERNEL_STRIPS = CudaKernel("spmsv_strips_csr_min", [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    stem="spmsv_csr_min")

_BLOCK = 256
_MAX_GRID = 132 * 16       # grid-stride beyond this many blocks


def _offsets(lens: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Exclusive prefix sum (int64, length n+1) of the segment lengths
    ``lens``, and its total, read to the host."""
    offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                       device=lens.device)
    if lens.shape[0] == 0:
        return offs, 0
    torch.cumsum(lens, 0, out=offs[1:])
    return offs, int(offs[-1])


def segment_offsets(ids: torch.Tensor, col_ptr: torch.Tensor
                    ) -> Tuple[torch.Tensor, int]:
    """Exclusive prefix sum (int64, length n_ids+1) of the segment lengths
    of the columns ``ids``, and its total, read to the host.  The ids must
    lie in [0, n_cols): ``prepare`` takes them from a mask, so they do."""
    return _offsets(col_ptr[ids + 1] - col_ptr[ids])


def _frontier_ids(f_mask: torch.Tensor, cap_f: int) -> torch.Tensor:
    """The frontier's column ids, int32 ascending; ``cap_f > 0`` bounds
    them: a larger frontier raises (the JAX package's kernel truncated it
    silently)."""
    ids = torch.nonzero(f_mask).reshape(-1).to(torch.int32)
    if cap_f and ids.shape[0] > cap_f:
        raise ValueError(f"frontier of {ids.shape[0]} columns exceeds "
                         f"cap_f={cap_f}")
    return ids


def prepare(f_mask: torch.Tensor, col_ptr: torch.Tensor, cap_f: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The launch prep shared by the kernel and its plain version: the
    frontier's column ids (int32, ascending), their ``segment_offsets``
    and the edge total."""
    ids = _frontier_ids(f_mask, cap_f)
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


def frontier_edges(starts, offs, total: int, row_idx, vals, base
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every frontier edge as a (candidate position, value) pair: item
    k's segment is ``row_idx[starts[k] : starts[k] + len_k]`` (flat int64
    positions, lengths from ``offs``), and each of its rows r gives
    ``(base[k] + r, vals[k])``.  The plain versions scatter-min these;
    ``chip_smoke.py`` times one ``scatter_reduce_`` of them as the
    library yardstick."""
    dev = offs.device
    k = torch.repeat_interleave(torch.arange(offs.shape[0] - 1, device=dev),
                                offs[1:] - offs[:-1])
    pos = starts[k] + (torch.arange(total, device=dev) - offs[k])
    return row_idx[pos].to(torch.int64) + base[k], vals[k]


def _segments_min(starts, offs, total: int, row_idx, vals, base,
                  size: int) -> torch.Tensor:
    """The plain gather-min: ``frontier_edges`` scatter-min'd into the
    (size,) int32 candidates."""
    out = torch.full((size,), INT_INF, dtype=torch.int32, device=offs.device)
    if total == 0:
        return out
    dst, v = frontier_edges(starts, offs, total, row_idx, vals, base)
    return out.scatter_reduce_(0, dst, v, reduce="amin")


def spmsv_csr_min_plain(ids, offs, total, col_ptr, row_idx, nr: int,
                        col_offset: int) -> torch.Tensor:
    """Expand every frontier column into its edges, then scatter-min the
    global source ids into the (nr,) candidates."""
    return _segments_min(col_ptr[ids].to(torch.int64), offs, total, row_idx,
                         ids + col_offset, torch.zeros_like(offs), nr)


def _grid(total: int) -> int:
    return min(_MAX_GRID, (total + _BLOCK - 1) // _BLOCK)


def launch(ids, offs, total, col_ptr, row_idx, nr: int,
           col_offset: int) -> torch.Tensor:
    """The kernel's launch on CUDA tensors from ``prepare``: the (nr,)
    candidates, with a grid sized from the frontier's edge total."""
    cand = torch.full((nr,), INT_INF, dtype=torch.int32, device=ids.device)
    if total:
        KERNEL.launch(ids.data_ptr(), offs.data_ptr(), col_ptr.data_ptr(),
                      row_idx.data_ptr(), cand.data_ptr(), ids.shape[0],
                      total, col_offset, _grid(total),
                      stream_handle(ids.device))
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


# ---------------------------------------------------------------------------
# A 2D block through the DCSC (jc, cp)
# ---------------------------------------------------------------------------


def prepare_dcsc(f_mask: torch.Tensor, jc: torch.Tensor, cp: torch.Tensor,
                 nzc: torch.Tensor, cap_f: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The DCSC launch prep: the frontier's column ids (int32,
    ascending), each one's slot in ``jc`` by binary search (int32), the
    int64 exclusive offsets of the FOUND columns' segment lengths (0 for
    an id ``jc`` does not hold) and the edge total.  The JAX package's
    rule: the search runs over the whole sentinel-padded ``jc``, the slot
    is clamped to ``cap_nzc - 1``, and an id is found when ``slot < nzc``
    and ``jc[slot]`` is the id."""
    ids = _frontier_ids(f_mask, cap_f)
    slot = torch.searchsorted(jc, ids, out_int32=True).clamp_(
        max=jc.shape[0] - 1)
    found = (jc[slot] == ids) & (slot < nzc)
    lens = torch.where(found, cp[slot + 1] - cp[slot], 0)
    offs, total = _offsets(lens)
    return ids, slot, offs, total


def _check_dcsc(f_mask, jc, cp, nzc, row_idx, nr):
    for name, t in (("jc", jc), ("cp", cp), ("row_idx", row_idx)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if cp.shape[0] != jc.shape[0] + 1 or nzc.dim() != 0:
        raise ValueError(f"cp must hold cap_nzc+1 = {jc.shape[0] + 1} "
                         f"pointers and nzc be 0-d, got {tuple(cp.shape)}, "
                         f"{tuple(nzc.shape)}")
    if f_mask.dtype != torch.bool or f_mask.dim() != 1:
        raise ValueError(f"f_mask must be a 1-D bool mask, got "
                         f"{f_mask.dtype} {tuple(f_mask.shape)}")
    if nr <= 0:
        raise ValueError(f"nr={nr} must be positive")


def spmsv_dcsc_min_plain(ids, slot, offs, total, cp, row_idx, nr: int,
                         col_offset: int) -> torch.Tensor:
    """The plain version on ``prepare_dcsc``'s output: every found
    column's segment from ``cp[slot]``, scatter-min of its global id."""
    return _segments_min(cp[slot].to(torch.int64), offs, total, row_idx,
                         ids + col_offset, torch.zeros_like(offs), nr)


def launch_dcsc(ids, slot, offs, total, cp, row_idx, nr: int,
                col_offset: int) -> torch.Tensor:
    """The DCSC kernel's launch on CUDA tensors from ``prepare_dcsc``."""
    cand = torch.full((nr,), INT_INF, dtype=torch.int32, device=ids.device)
    if total:
        KERNEL_DCSC.launch(ids.data_ptr(), slot.data_ptr(), offs.data_ptr(),
                           cp.data_ptr(), row_idx.data_ptr(),
                           cand.data_ptr(), ids.shape[0], total, col_offset,
                           _grid(total), stream_handle(ids.device))
    return cand


def spmsv_dcsc_min(f_mask: torch.Tensor, jc: torch.Tensor, cp: torch.Tensor,
                   nzc: torch.Tensor, row_idx: torch.Tensor, nr: int,
                   col_offset: int, cap_f: int = 0) -> torch.Tensor:
    """``spmsv_csr_min`` through the block's DCSC: (nr,) int32
    candidates, each frontier id found by binary search in ``jc``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check_dcsc(f_mask, jc, cp, nzc, row_idx, nr)
    tensors = (f_mask, jc, cp, nzc, row_idx)
    if all(t.device.type == "cpu" for t in tensors):
        return spmsv_dcsc_min_plain(*prepare_dcsc(f_mask, jc, cp, nzc, cap_f),
                                    cp, row_idx, nr, col_offset)
    KERNEL_DCSC.load()
    require_cuda(*tensors)
    return launch_dcsc(*prepare_dcsc(f_mask, jc, cp, nzc, cap_f), cp,
                       row_idx, nr, col_offset)


# ---------------------------------------------------------------------------
# All p 1D strips through the (p, n+1) strip col_ptr
# ---------------------------------------------------------------------------


def prepare_strips(f_words: torch.Tensor, col_ptr: torch.Tensor,
                   cap_f: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The strip launch prep: the frontier's global ids (int32,
    ascending) from the allgathered bitmap, taken once for all strips
    and bounded by ``cap_f`` as in ``prepare``; the int64 exclusive
    offsets of the (strip, id) segment lengths, strip-major (p * n_ids
    + 1 of them; their total can pass 2^31 at scale 24); and that
    total."""
    ids = _frontier_ids(unpack_bits(f_words), cap_f)
    idx = ids.to(torch.int64)
    offs, total = _offsets((col_ptr[:, idx + 1] - col_ptr[:, idx]).reshape(-1))
    return ids, offs, total


def _check_strips(f_words, col_ptr, row_idx, nr):
    for name, t in (("f_words", f_words), ("col_ptr", col_ptr),
                    ("row_idx", row_idx)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = col_ptr.shape[-1] - 1
    if col_ptr.dim() != 2 or row_idx.dim() != 2 \
            or row_idx.shape[0] != col_ptr.shape[0] \
            or f_words.shape != (n // 32,):
        raise ValueError(f"need col_ptr (p, n+1), row_idx (p, cap) and the "
                         f"(n/32,) words, got {tuple(col_ptr.shape)}, "
                         f"{tuple(row_idx.shape)}, {tuple(f_words.shape)}")
    if col_ptr.shape[0] * n >= 2**31 or nr <= 0:
        raise ValueError(f"p * n = {col_ptr.shape[0] * n} must stay under "
                         f"2^31 and nr={nr} be positive")


def spmsv_strips_csr_min_plain(ids, offs, total, col_ptr, row_idx,
                               nr: int) -> torch.Tensor:
    """The plain version on ``prepare_strips``'s output: (p, nr)."""
    p, n_ids = col_ptr.shape[0], ids.shape[0]
    item = torch.arange(p * n_ids, device=ids.device)
    s = torch.div(item, max(n_ids, 1), rounding_mode="floor")
    u = ids.repeat(p)
    starts = col_ptr[s, u.to(torch.int64)].to(torch.int64) \
        + s * row_idx.shape[1]
    return _segments_min(starts, offs, total, row_idx.reshape(-1), u,
                         s * nr, p * nr).reshape(p, nr)


def launch_strips(ids, offs, total, col_ptr, row_idx, nr: int
                  ) -> torch.Tensor:
    """The strip kernel's launch on CUDA tensors from ``prepare_strips``:
    one launch for all p strips."""
    p = col_ptr.shape[0]
    cand = torch.full((p, nr), INT_INF, dtype=torch.int32, device=ids.device)
    if total:
        KERNEL_STRIPS.launch(ids.data_ptr(), offs.data_ptr(),
                             col_ptr.data_ptr(), row_idx.data_ptr(),
                             cand.data_ptr(), ids.shape[0], p, total,
                             col_ptr.stride(0), row_idx.stride(0), nr,
                             _grid(total), stream_handle(ids.device))
    return cand


def spmsv_strips_csr_min(f_words: torch.Tensor, col_ptr: torch.Tensor,
                         row_idx: torch.Tensor, nr: int, cap_f: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1D strips' top-down SpMSV through the strip ``col_ptr``, all p
    strips at once against the allgathered ``(n/32,)`` frontier words:
    the (p, nr) int32 candidates (for each local row the smallest global
    frontier id with an edge into it, else INT_INF) and the edges
    examined, a 0-d int64 tensor (the frontier's segments in every
    strip).  ``cap_f > 0`` bounds the frontier's ids: a larger frontier
    raises.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check_strips(f_words, col_ptr, row_idx, nr)
    tensors = (f_words, col_ptr, row_idx)
    on_cpu = all(t.device.type == "cpu" for t in tensors)
    if not on_cpu:
        KERNEL_STRIPS.load()
        require_cuda(*tensors)
    prep = prepare_strips(f_words, col_ptr, cap_f)
    run = spmsv_strips_csr_min_plain if on_cpu else launch_strips
    return run(*prep, col_ptr, row_idx, nr), prep[1][-1]
