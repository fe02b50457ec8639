"""One bottom-up sub-step over a rotated row segment: the wrapper of the
CUDA kernel ``csrc/bottomup_substep.cu`` and its plain PyTorch version."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.frontier import INT_INF, test_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("bottomup_substep", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


def _check(rp_seg, ue_win, f_words, cvec, n_edges):
    for name, t in (("rp_seg", rp_seg), ("ue_win", ue_win),
                    ("f_words", f_words), ("cvec", cvec)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if cvec.shape[0] != rp_seg.shape[0] - 1:
        raise ValueError(f"cvec has {cvec.shape[0]} rows, rp_seg "
                         f"{rp_seg.shape[0] - 1}")
    if not 0 <= n_edges <= ue_win.shape[0]:
        raise ValueError(f"n_edges={n_edges} outside the {ue_win.shape[0]}"
                         f"-edge window")


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


def launch(rp_seg, ue_win, f_words, cvec, col_offset: int,
           n_edges: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors: the (chunk,) result."""
    chunk = cvec.shape[0]
    out = torch.empty(chunk, dtype=torch.int32, device=cvec.device)
    if chunk:
        KERNEL.launch(rp_seg.data_ptr(), ue_win.data_ptr(),
                      f_words.data_ptr(), cvec.data_ptr(), out.data_ptr(),
                      chunk, col_offset, n_edges, stream_handle(cvec.device))
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
