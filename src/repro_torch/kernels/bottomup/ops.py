"""The bottom-up sub-step: the wrappers of the CUDA kernel
``csrc/bottomup_substep.cu`` (one rotated row segment of a 2D block, or
all p row strips of a 1D level in one launch) and their plain PyTorch
versions.

While a ``core/trace.py`` Recorder is active, each launch hands the
kernel a fresh zeroed device word (``trace.device_word``) that it adds
the edges it loads to; otherwise the pointer is null and the kernel
counts nothing.  ``loaded_edges_plain`` re-counts the kernel's rule."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import trace
from repro_torch.core.frontier import INT_INF, test_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("bottomup_substep", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p])

# the kernel's walk: a lane's head edges, then the warp's step
LANE_EDGES, WARP_EDGES = 4, 32


def _int32_tensor(name, t, dim):
    if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check(rp_seg, ue_win, f_words, cvec, n_edges):
    for name, t in (("rp_seg", rp_seg), ("ue_win", ue_win),
                    ("f_words", f_words), ("cvec", cvec)):
        _int32_tensor(name, t, 1)
    if cvec.shape[0] != rp_seg.shape[0] - 1:
        raise ValueError(f"cvec has {cvec.shape[0]} rows, rp_seg "
                         f"{rp_seg.shape[0] - 1}")
    if not 0 <= n_edges <= ue_win.shape[0]:
        raise ValueError(f"n_edges={n_edges} outside the {ue_win.shape[0]}"
                         f"-edge window")


def _check_strips(row_ptr, col_idx, f_words, cvec, n_edges):
    for name, t, dim in (("row_ptr", row_ptr, 2), ("col_idx", col_idx, 2),
                         ("f_words", f_words, 1), ("cvec", cvec, 2),
                         ("n_edges", n_edges, 1)):
        _int32_tensor(name, t, dim)
    p, chunk = cvec.shape
    if (row_ptr.shape != (p, chunk + 1) or col_idx.shape[0] != p
            or n_edges.shape != (p,)):
        raise ValueError(f"strip shapes disagree: row_ptr "
                         f"{tuple(row_ptr.shape)}, col_idx "
                         f"{tuple(col_idx.shape)}, cvec {tuple(cvec.shape)}, "
                         f"n_edges {tuple(n_edges.shape)}")


def bottomup_substep_plain(rp_seg, ue_win, f_words, cvec, col_offset: int,
                           n_edges: int) -> torch.Tensor:
    """Per-edge rows from the row lengths, frontier hits of live rows,
    then the min global source per row."""
    dev = ue_win.device
    chunk = rp_seg.shape[0] - 1
    lens = (rp_seg[1:] - rp_seg[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(chunk, device=dev), lens)
    e0 = int(rp_seg[0])
    ue = ue_win[e0:e0 + rows.shape[0]]
    keep = torch.arange(e0, e0 + rows.shape[0], device=dev) < n_edges
    hit = keep & (cvec[rows] == 0) & test_bits(f_words, ue)
    out = torch.full((chunk,), INT_INF, dtype=torch.int32, device=dev)
    return out.scatter_reduce_(0, rows[hit], (ue[hit] + col_offset)
                               .to(torch.int32), reduce="amin")


def bottomup_substep_strips_plain(row_ptr, col_idx, f_words, cvec,
                                  n_edges) -> torch.Tensor:
    """The per-strip stack of ``bottomup_substep_plain`` (col_offset 0:
    strip source ids are global)."""
    return torch.stack([
        bottomup_substep_plain(row_ptr[i], col_idx[i], f_words, cvec[i], 0,
                               int(ne))
        for i, ne in enumerate(n_edges.tolist())])


def loaded_edges_plain(rp_seg, ue_win, f_words, cvec,
                       n_edges: int) -> int:
    """The edges the kernel loads on one row segment, by its rule: a live
    row (``cvec == 0``, edges left below ``n_edges``) loads its first
    ``LANE_EDGES`` edges; if none of them hits the frontier and it has
    more, the warp walks the rest ``WARP_EDGES`` at a time, loading every
    edge of each step up to and including the first step with a hit."""
    dev = ue_win.device
    lo = rp_seg[:-1].to(torch.int64)
    hi = rp_seg[1:].to(torch.int64).clamp(max=n_edges)
    lens = (hi - lo).clamp(min=0)
    live = (cvec == 0) & (lens > 0)
    rows = torch.repeat_interleave(torch.arange(cvec.shape[0], device=dev),
                                   lens)
    pos = torch.arange(rows.shape[0], device=dev) \
        - (torch.cumsum(lens, 0) - lens)[rows]          # edge's place in row
    e = lo[rows] + pos
    hit = test_bits(f_words, ue_win[e])
    first = torch.full(lens.shape, 1 << 62, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, rows[hit], pos[hit], reduce="amin")
    walk_end = LANE_EDGES + WARP_EDGES * (
        (first - LANE_EDGES).clamp(min=0) // WARP_EDGES + 1)
    loads = torch.where(first < LANE_EDGES, lens.clamp(max=LANE_EDGES),
                        torch.minimum(lens, walk_end))
    return int(torch.where(live, loads, 0).sum())


def new_output(cvec: torch.Tensor) -> torch.Tensor:
    """The kernel's output, shaped as the completed flags; the kernel
    writes every row, so it starts uninitialised."""
    return torch.empty(cvec.shape, dtype=torch.int32, device=cvec.device)


def launch(rp_seg, ue_win, f_words, cvec, col_offset: int,
           n_edges: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors, one row segment: the
    (chunk,) result."""
    out = new_output(cvec)
    word = trace.device_word(cvec.device)
    KERNEL.launch(rp_seg.data_ptr(), ue_win.data_ptr(), f_words.data_ptr(),
                  cvec.data_ptr(), out.data_ptr(), None, 1, cvec.shape[0],
                  ue_win.shape[0], col_offset, n_edges,
                  None if word is None else word.data_ptr(),
                  stream_handle(cvec.device))
    return out


def launch_strips(row_ptr, col_idx, f_words, cvec, n_edges) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors, all p strips at once:
    the (p, chunk) result.  ``n_edges`` is the (p,) int32 edge counts on
    the card."""
    out = new_output(cvec)
    p, chunk = cvec.shape
    word = trace.device_word(cvec.device)
    KERNEL.launch(row_ptr.data_ptr(), col_idx.data_ptr(), f_words.data_ptr(),
                  cvec.data_ptr(), out.data_ptr(), n_edges.data_ptr(), p,
                  chunk, col_idx.shape[1], 0, 0,
                  None if word is None else word.data_ptr(),
                  stream_handle(cvec.device))
    return out


def bottomup_substep(rp_seg: torch.Tensor, ue_win: torch.Tensor,
                     f_words: torch.Tensor, cvec: torch.Tensor,
                     col_offset: int, n_edges: int) -> torch.Tensor:
    """(chunk,) int32: for every row with ``cvec == 0``, the smallest
    ``col_offset + u`` over its window edges u in the frontier bitmap,
    else INT_INF.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(rp_seg, ue_win, f_words, cvec, n_edges)
    tensors = (rp_seg, ue_win, f_words, cvec)
    if all(t.device.type == "cpu" for t in tensors):
        return bottomup_substep_plain(rp_seg, ue_win, f_words, cvec,
                                      col_offset, n_edges)
    KERNEL.load()
    require_cuda(*tensors)
    return launch(rp_seg, ue_win, f_words, cvec, col_offset, n_edges)


def bottomup_substep_strips(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                            f_words: torch.Tensor, cvec: torch.Tensor,
                            n_edges: torch.Tensor) -> torch.Tensor:
    """(p, chunk) int32: one bottom-up sub-step over every strip of a 1D
    level (``row_ptr (p, chunk+1)``, ``col_idx (p, cap)``, ``cvec (p,
    chunk)``, the strips' edge counts ``n_edges (p,)``, one frontier
    bitmap for all).  CPU tensors take the plain version; CUDA tensors
    launch the kernel once."""
    _check_strips(row_ptr, col_idx, f_words, cvec, n_edges)
    tensors = (row_ptr, col_idx, f_words, cvec, n_edges)
    if all(t.device.type == "cpu" for t in tensors):
        return bottomup_substep_strips_plain(row_ptr, col_idx, f_words, cvec,
                                             n_edges)
    KERNEL.load()
    require_cuda(*tensors)
    return launch_strips(row_ptr, col_idx, f_words, cvec, n_edges)
