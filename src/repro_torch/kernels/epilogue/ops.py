"""The end of one 2D level: the wrapper of the CUDA kernel
``csrc/level_epilogue.cu`` and its plain PyTorch twin.

``level_epilogue(pi, deg, cand, recv, root)`` applies a level's
candidate slots to the parents ``pi`` in place, in slot order, first find
wins: slot 0 is ``cand`` (the folded top-down candidates, or a bottom-up
level's own sub-step 0), slot s > 0 of block (i, q) is ``recv[i, q, (q +
s) mod pc]`` (what the bottom-up exchange delivered from sub-step s).
With ``cand`` None the one candidate is ``root`` at its own id (the
start of a search).  It returns the next frontier as a ``Front``: its
packed words, exactly ``pack_bits`` of the newly found mask, and its
three masses (n_f, m_f, m_u) summed exactly in int64 on the device, the
values ``core/decomp.py::_masses`` reduces, for the level loop's one
host read.

CPU and meta tensors take the plain twin (the sequence the 2D steps ran
before the kernel: the ``where`` update, ``pack_bits``, the masses);
CUDA tensors launch the kernel once and read nothing back.  While a
``core/trace.py`` Recorder traces the search, each launch adds one to its
counter ``level_epilogues``; the twin counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import trace
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("level_epilogue", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


class Front(NamedTuple):
    """A 2D level's next frontier as the epilogue leaves it."""
    words: torch.Tensor     # (pr, pc, chunk // 32) int32: pack_bits' words
    masses: torch.Tensor    # (3,) int64 on the device: n_f, m_f, m_u


def _check(pi, deg, cand, recv) -> None:
    named = [("pi", pi), ("deg", deg)] + \
        [(k, t) for k, t in (("cand", cand), ("recv", recv)) if t is not None]
    for name, t in named:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if pi.dim() != 3 or pi.shape[-1] % 32:
        raise ValueError(f"pi must be (pr, pc, chunk) with chunk a multiple "
                         f"of 32, got {tuple(pi.shape)}")
    if deg.shape != pi.shape or (cand is not None and cand.shape != pi.shape):
        raise ValueError(f"deg and cand must be shaped as pi "
                         f"{tuple(pi.shape)}, got {tuple(deg.shape)}, "
                         f"{None if cand is None else tuple(cand.shape)}")
    pr, pc, chunk = pi.shape
    if recv is not None and (cand is None or recv.shape != (pr, pc, pc, chunk)):
        raise ValueError(f"recv must be (pr, pc, pc, chunk) = "
                         f"{(pr, pc, pc, chunk)} beside cand, got "
                         f"{tuple(recv.shape)}")


def level_epilogue_plain(pi, deg, cand=None, recv=None, root: int = -1
                         ) -> Front:
    """The twin: each slot's ``where`` update in order, the newly found
    mask packed by ``pack_bits``, and the masses of ``_masses``."""
    if cand is None:
        cand = torch.full_like(pi, INT_INF)
        if 0 <= root < pi.numel():
            cand.view(-1)[root] = root
    pc = pi.shape[1]
    jj = torch.arange(pc, device=pi.device)
    front = torch.zeros(pi.shape, dtype=torch.bool, device=pi.device)
    for s in range(pc if recv is not None else 1):
        upd = cand if s == 0 else recv[:, jj, (jj + s) % pc]
        newly = (pi == -1) & (upd != INT_INF)
        pi.copy_(torch.where(newly, upd, pi))
        front |= newly
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    masses = torch.stack([front.sum(), torch.where(front, deg, zero).sum(),
                          torch.where(pi == -1, deg, zero).sum()])
    return Front(pack_bits(front), masses)


# the scratch of each (device, stream): three sums and a block count,
# which the kernel leaves at 0; made once, reused by every launch on that
# stream, whose launches run in order (two streams sharing one would race
# on the sums and the count)
_SCRATCH: Dict[Tuple[str, int], torch.Tensor] = {}


def launch(pi, deg, cand=None, recv=None, root: int = -1) -> Front:
    """The kernel's one launch on checked CUDA tensors, on the current
    stream, reading nothing back.  Its lanes read ``pi``, ``deg`` and
    ``cand`` as int4: each must start on 16 bytes, as every fresh
    allocation does."""
    for name, t in (("pi", pi), ("deg", deg), ("cand", cand)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes for the "
                             f"kernel's int4 reads")
    dev = pi.device
    pr, pc, chunk = pi.shape
    stream = stream_handle(dev)
    key = (str(dev), stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(4, dtype=torch.int64, device=dev)
    words = torch.empty((pr, pc, chunk // 32), dtype=torch.int32, device=dev)
    masses = torch.empty(3, dtype=torch.int64, device=dev)
    try:
        KERNEL.launch(None if cand is None else cand.data_ptr(),
                      None if recv is None else recv.data_ptr(), root,
                      pi.data_ptr(), deg.data_ptr(), words.data_ptr(),
                      _SCRATCH[key].data_ptr(), masses.data_ptr(), pr * pc,
                      pc, chunk, stream)
    except RuntimeError:
        # a launch that failed may leave the sums off 0
        del _SCRATCH[key]
        raise
    tr = trace.current()
    if tr is not None:
        tr.count(trace.LEVEL_EPILOGUES)
    return Front(words, masses)


def level_epilogue(pi: torch.Tensor, deg: torch.Tensor,
                   cand: Optional[torch.Tensor] = None,
                   recv: Optional[torch.Tensor] = None,
                   root: int = -1) -> Front:
    """Apply the level's candidate slots to ``pi`` ((pr, pc, chunk) int32,
    updated in place) and return the next frontier's words and masses
    (``deg`` the (pr, pc, chunk) int32 degrees).  CPU and meta tensors
    take the plain twin; CUDA tensors launch the kernel."""
    _check(pi, deg, cand, recv)
    tensors = [t for t in (pi, deg, cand, recv) if t is not None]
    if not any(t.is_cuda for t in tensors):
        return level_epilogue_plain(pi, deg, cand, recv, root)
    KERNEL.load()
    require_cuda(*tensors)
    return launch(pi, deg, cand, recv, root)


def level_bytes(n: int, unvisited: int, newly: int, slot_reads: int = 0,
                start: bool = False) -> Tuple[int, int]:
    """(flops, bytes) one launch needs over ``n`` vertices: pi read once,
    the n / 32 words written, each of the ``unvisited`` vertices' degree
    and slot-0 candidate read (none at the ``start``, whose candidate is
    the root's id), the further ``slot_reads`` in all, and each ``newly``
    found parent written; no flops but the integer sums."""
    cand = 0 if start else 4 * unvisited
    return 0, (4 * n + n // 8 + 4 * unvisited + cand + 4 * slot_reads
               + 4 * newly)
