"""Top-down SpMSV over the CSC column segments of the frontier columns,
fused with the min: the wrappers of the three C entries of the CUDA
kernel ``csrc/spmsv_csr_min.cu`` and their plain PyTorch versions.  One
body, ``spmsv_min``, over an addressing (``Segments``):

  csr     a 2D block, segments through the uncompressed ``col_ptr``
          (``spmsv_csr_min``)
  dcsc    a 2D block, segments through the DCSC ``(jc, cp)``: each
          frontier id is binary-searched in ``jc`` (the paper's
          hypersparse indirection, §5.1; ``spmsv_dcsc_min``)
  strips  all p 1D strips at once, segments through the ``(p, n+1)``
          strip ``col_ptr`` (``spmsv_strips_csr_min``)

On the card a call is two launches and reads nothing back: the prep
kernel compacts the frontier words into a device id list with the count
on the device, and a persistent walk gathers the segments (the frontier
or the column walk, chosen on the card against ``list_capacity``).  A
``cap_f`` bound is checked where the count reaches the host: inside a
level loop (``deferred_cap_checks``) it rides the loop's own read,
elsewhere it costs one read.  On the CPU the plain versions run on the
plain preps (``prepare``, ``prepare_dcsc``, ``prepare_strips``), which
read the id count and the edge total, and raise on ``cap_f`` at the call;
``prep_plain`` is the twin of the device prep that the tests hold.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.frontier import INT_INF, pack_bits, unpack_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.spmsv import strip
from repro_torch.kernels.spmsv.strip import WALK_COLUMNS, WALK_FRONTIER

# one argument list for the three entries (csrc/spmsv_csr_min.cu): ptr,
# jc, nzc, row_idx, words, cand, scratch, ids, out; p, n_ptr, ptr_stride,
# ridx_stride, n_words, nr, col_offset, list_cap; the stream
_ARGS = [ctypes.c_void_p] * 9 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
KERNEL = CudaKernel("spmsv_csr_min", _ARGS)
KERNEL_DCSC = CudaKernel("spmsv_dcsc_min", _ARGS, stem="spmsv_csr_min")
KERNEL_STRIPS = CudaKernel("spmsv_strips_csr_min", _ARGS,
                           stem="spmsv_csr_min")

CSR, DCSC, STRIPS = "csr", "dcsc", "strips"
_KERNELS = {CSR: KERNEL, DCSC: KERNEL_DCSC, STRIPS: KERNEL_STRIPS}

# a frontier id of the csr and strip frontier walks reads its pointer
# pair at random, one 32-byte sector, where the column walk reads a
# column's 4-byte pointer in order
PTR_ID_COST = 8


class Segments(NamedTuple):
    """Where kernel 1 finds a frontier column's segment of ``row_idx``:
    ``ptr`` is the block's ``col_ptr`` (nc+1,) for csr, its ``cp``
    (cap_nzc+1,) for dcsc (with ``jc`` (cap_nzc,) and the 0-d ``nzc``),
    and the strips' ``col_ptr`` (p, n+1) for strips, whose ``row_idx`` is
    (p, cap)."""
    addressing: str
    ptr: torch.Tensor
    row_idx: torch.Tensor
    jc: Optional[torch.Tensor] = None
    nzc: Optional[torch.Tensor] = None


def csr(col_ptr, row_idx) -> Segments:
    return Segments(CSR, col_ptr, row_idx)


def dcsc(jc, cp, nzc, row_idx) -> Segments:
    return Segments(DCSC, cp, row_idx, jc, nzc)


def strips(col_ptr, row_idx) -> Segments:
    return Segments(STRIPS, col_ptr, row_idx)


def list_capacity(seg: Segments) -> int:
    """The walk threshold, and the length of the device id list: the
    frontier walk while the frontier holds at most this many ids.  csr and
    strips: a column's pointer a ``PTR_ID_COST``-th of an id's; dcsc: the
    strip kernels' rule at one step, an id's binary search in ``jc``
    against the slots (``strip.list_capacity``)."""
    if seg.addressing == DCSC:
        return strip.list_capacity(seg.jc.shape[0], 1)
    return max(1, (seg.ptr.shape[-1] - 1) // PTR_ID_COST)


def prep_plain(f_words: torch.Tensor, list_cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The plain twin of the device prep and its walk choice: the
    frontier's ids (int32, ascending; the kernel's list holds the same
    set unordered, and only up to ``list_cap`` of them), their count (a
    0-d int64 tensor) and the walk the kernel takes (``WALK_FRONTIER``
    while the count is at most ``list_cap``, else ``WALK_COLUMNS``)."""
    ids = torch.nonzero(unpack_bits(f_words)).reshape(-1).to(torch.int32)
    walk = WALK_FRONTIER if ids.shape[0] <= list_cap else WALK_COLUMNS
    return ids, torch.tensor(ids.shape[0], device=f_words.device), walk


# ---------------------------------------------------------------------------
# The plain preps and versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------


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


def check_cap(n: int, cap_f: int) -> None:
    """``cap_f > 0`` bounds the frontier's column count: a larger
    frontier raises (the JAX package's kernel truncated it silently)."""
    if cap_f and n > cap_f:
        raise ValueError(f"frontier of {n} columns exceeds cap_f={cap_f}")


def _frontier_ids(f_mask: torch.Tensor, cap_f: int) -> torch.Tensor:
    """The frontier's column ids, int32 ascending, bounded by ``cap_f``."""
    ids = torch.nonzero(f_mask).reshape(-1).to(torch.int32)
    check_cap(ids.shape[0], cap_f)
    return ids


def prepare(f_mask: torch.Tensor, col_ptr: torch.Tensor, cap_f: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The csr plain prep: the frontier's column ids (int32, ascending),
    their ``segment_offsets`` and the edge total."""
    ids = _frontier_ids(f_mask, cap_f)
    offs, total = segment_offsets(ids, col_ptr)
    return ids, offs, total


def prepare_dcsc(f_mask: torch.Tensor, jc: torch.Tensor, cp: torch.Tensor,
                 nzc: torch.Tensor, cap_f: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The DCSC plain prep: the frontier's column ids (int32, ascending),
    each one's slot in ``jc`` by binary search (int32), the int64
    exclusive offsets of the FOUND columns' segment lengths (0 for an id
    ``jc`` does not hold) and the edge total.  The JAX package's rule:
    the search runs over the whole sentinel-padded ``jc``, the slot is
    clamped to ``cap_nzc - 1``, and an id is found when ``slot < nzc``
    and ``jc[slot]`` is the id (the kernel searches ``jc[0, nzc)``: the
    sentinel lies above every id, so the two find the same)."""
    ids = _frontier_ids(f_mask, cap_f)
    slot = torch.searchsorted(jc, ids, out_int32=True).clamp_(
        max=jc.shape[0] - 1)
    found = (jc[slot] == ids) & (slot < nzc)
    lens = torch.where(found, cp[slot + 1] - cp[slot], 0)
    offs, total = _offsets(lens)
    return ids, slot, offs, total


def prepare_strips(f_words: torch.Tensor, col_ptr: torch.Tensor,
                   cap_f: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The strip plain prep: the frontier's global ids (int32,
    ascending) from the allgathered bitmap, taken once for all strips
    and bounded by ``cap_f`` as in ``prepare``; the int64 exclusive
    offsets of the (strip, id) segment lengths, strip-major (p * n_ids
    + 1 of them; their total can pass 2^31 at scale 24); and that
    total."""
    ids = _frontier_ids(unpack_bits(f_words), cap_f)
    idx = ids.to(torch.int64)
    offs, total = _offsets((col_ptr[:, idx + 1] - col_ptr[:, idx]).reshape(-1))
    return ids, offs, total


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


def spmsv_dcsc_min_plain(ids, slot, offs, total, cp, row_idx, nr: int,
                         col_offset: int) -> torch.Tensor:
    """The plain version on ``prepare_dcsc``'s output: every found
    column's segment from ``cp[slot]``, scatter-min of its global id."""
    return _segments_min(cp[slot].to(torch.int64), offs, total, row_idx,
                         ids + col_offset, torch.zeros_like(offs), nr)


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


def spmsv_min_plain(seg: Segments, frontier, nr: int, col_offset: int = 0,
                    cap_f: int = 0):
    """The plain version of ``spmsv_min``, on any device: the plain prep
    (two host reads) and the plain version of ``seg``'s addressing."""
    if seg.addressing == STRIPS:
        ids, offs, total = prepare_strips(frontier, seg.ptr, cap_f)
        cand = spmsv_strips_csr_min_plain(ids, offs, total, seg.ptr,
                                          seg.row_idx, nr)
        return cand, offs[-1]
    mask = frontier if frontier.dtype == torch.bool else unpack_bits(frontier)
    if seg.addressing == CSR:
        ids, offs, total = prepare(mask, seg.ptr, cap_f)
        cand = spmsv_csr_min_plain(ids, offs, total, seg.ptr, seg.row_idx,
                                   nr, col_offset)
    else:
        ids, slot, offs, total = prepare_dcsc(mask, seg.jc, seg.ptr,
                                              seg.nzc, cap_f)
        cand = spmsv_dcsc_min_plain(ids, slot, offs, total, seg.ptr,
                                    seg.row_idx, nr, col_offset)
    return cand, offs[-1]


def forward_cost(addressing: str, n_ids: int, edges: int, nr: int,
                 p: int = 1, n_words: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-1 call with ``n_ids`` frontier ids
    and ``edges`` frontier edges: the ids and their int64 offsets, each
    id's pointer pair (csr; the strips' one pointer word a (strip, id))
    or its slot and ``cp`` word (dcsc), one row id an edge, the (p, nr)
    candidates written once; no flops (compares and mins).  These are
    the bytes the kernel table has carried since the prep moved to the
    card; ``n_words`` adds the frontier words the device prep reads, 4
    bytes each, where the caller states them."""
    if addressing == CSR:
        ptrs = 8 * n_ids + 8 * (n_ids + 1) + 4 * n_ids
    elif addressing == DCSC:
        ptrs = 4 * n_ids + 8 * (n_ids + 1) + 4 * n_ids + 4 * n_ids
    else:
        ptrs = 8 * (p * n_ids + 1) + 4 * p * n_ids + 4 * n_ids
    return 0, ptrs + 4 * edges + 4 * p * nr + 4 * n_words


# ---------------------------------------------------------------------------
# The kernel's launch
# ---------------------------------------------------------------------------


def _check(seg: Segments, frontier: torch.Tensor, nr: int) -> None:
    ptr_name = "cp" if seg.addressing == DCSC else "col_ptr"
    named = [(ptr_name, seg.ptr), ("row_idx", seg.row_idx)]
    if seg.addressing == DCSC:
        named += [("jc", seg.jc), ("nzc", seg.nzc)]
    for name, t in named:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if nr <= 0:
        raise ValueError(f"nr={nr} must be positive")
    on_strips = seg.addressing == STRIPS
    if on_strips:
        n = seg.ptr.shape[-1] - 1
        if seg.ptr.dim() != 2 or seg.row_idx.dim() != 2 \
                or seg.row_idx.shape[0] != seg.ptr.shape[0] \
                or frontier.dtype != torch.int32 \
                or frontier.shape != (n // 32,) \
                or not frontier.is_contiguous():
            raise ValueError(
                f"need col_ptr (p, n+1), row_idx (p, cap) and the (n/32,) "
                f"int32 words, got {tuple(seg.ptr.shape)}, "
                f"{tuple(seg.row_idx.shape)}, {frontier.dtype} "
                f"{tuple(frontier.shape)}")
        return
    if seg.ptr.dim() != 1 or seg.row_idx.dim() != 1:
        raise ValueError(f"{ptr_name} and row_idx must be 1-D, got "
                         f"{tuple(seg.ptr.shape)}, {tuple(seg.row_idx.shape)}")
    if seg.addressing == DCSC and (seg.ptr.shape[0] != seg.jc.shape[0] + 1
                                   or seg.jc.dim() != 1
                                   or seg.nzc.dim() != 0):
        raise ValueError(f"cp must hold cap_nzc+1 = {seg.jc.shape[0] + 1} "
                         f"pointers and nzc be 0-d, got "
                         f"{tuple(seg.ptr.shape)}, {tuple(seg.nzc.shape)}")
    nc = seg.ptr.shape[0] - 1 if seg.addressing == CSR else None
    if frontier.dtype == torch.bool:
        if frontier.dim() != 1 or nc not in (None, frontier.shape[0]):
            raise ValueError(f"f_mask must be a bool mask over the block's "
                             f"{nc} columns, got {frontier.dtype} "
                             f"{tuple(frontier.shape)}")
    elif frontier.dtype != torch.int32 or frontier.dim() != 1 \
            or not frontier.is_contiguous() \
            or nc not in (None, 32 * frontier.shape[0]):
        raise ValueError(f"the frontier must be a bool mask or its int32 "
                         f"words over the block's columns, got "
                         f"{frontier.dtype} {tuple(frontier.shape)}")


# the scratch of each (device, list length): the walk's counters, which
# it leaves at 0, and the id list; made once, reused by every call
_SCRATCH: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, list_cap: int):
    key = (str(dev), list_cap)
    if key not in _SCRATCH:
        _SCRATCH[key] = (torch.zeros(4, dtype=torch.int64, device=dev),
                         torch.empty(list_cap, dtype=torch.int32, device=dev))
    return _SCRATCH[key]


def launch(seg: Segments, f_words: torch.Tensor, nr: int,
           col_offset: int = 0, list_cap: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two launches on checked CUDA tensors, reading nothing
    back: the candidates ((nr,) in 2D, (p, nr) on the strips) and a (3,)
    int64 tensor on the card: the edges examined, the frontier's id
    count and the walk taken.  ``list_cap`` overrides the walk threshold
    (``list_capacity``)."""
    dev = f_words.device
    on_strips = seg.addressing == STRIPS
    p = seg.ptr.shape[0] if on_strips else 1
    cap = list_capacity(seg) if list_cap is None else list_cap
    scratch, ids = _scratch(dev, cap)
    cand = torch.empty((p, nr) if on_strips else (nr,), dtype=torch.int32,
                       device=dev)
    out = torch.empty(3, dtype=torch.int64, device=dev)
    n_ptr = seg.jc.shape[0] if seg.addressing == DCSC \
        else seg.ptr.shape[-1] - 1
    try:
        _KERNELS[seg.addressing].launch(
            seg.ptr.data_ptr(),
            seg.jc.data_ptr() if seg.jc is not None else 0,
            seg.nzc.data_ptr() if seg.nzc is not None else 0,
            seg.row_idx.data_ptr(), f_words.data_ptr(), cand.data_ptr(),
            scratch.data_ptr(), ids.data_ptr(), out.data_ptr(), p, n_ptr,
            seg.ptr.stride(0) if on_strips else 0,
            seg.row_idx.stride(0) if on_strips else 0, f_words.shape[0], nr,
            col_offset, cap, stream_handle(dev))
    except RuntimeError:
        # a launch that failed may leave the counters off 0
        del _SCRATCH[(str(dev), cap)]
        raise
    return cand, out


# ---------------------------------------------------------------------------
# cap_f on the card: checked where the count reaches the host
# ---------------------------------------------------------------------------

_OPEN_LOOPS: List[list] = []


@contextlib.contextmanager
def deferred_cap_checks():
    """While the block runs (a level loop), a CUDA call's ``cap_f`` check
    waits in the yielded list as ``(count, cap_f)``, the count a 0-d
    tensor on the card, until the loop's own host read carries
    ``overflow(pending)`` and hands the values to ``raise_overflow``."""
    pending: list = []
    _OPEN_LOOPS.append(pending)
    try:
        yield pending
    finally:
        _OPEN_LOOPS.remove(pending)


def _bound(count: torch.Tensor, cap_f: int) -> None:
    if not cap_f:
        return
    if _OPEN_LOOPS:
        _OPEN_LOOPS[-1].append((count, cap_f))
        return
    check_cap(int(count), cap_f)      # one host read: no level loop is open


def overflow(pending: list) -> torch.Tensor:
    """(2,) int64 on the device of the pending counts: the count of the
    first pending call past its ``cap_f`` and that call's index, or two
    zeros."""
    counts = torch.stack([c for c, _ in pending])
    over = torch.stack([c > cap for c, cap in pending]).to(torch.int32)
    first = over.argmax()
    return torch.stack([torch.where(over[first] > 0, counts[first], 0),
                        first])


def raise_overflow(pending: list, values) -> None:
    """Empty ``pending``; raise what the first call past its ``cap_f``
    would have raised at once, from ``overflow``'s values read to the
    host."""
    n, first = (int(v) for v in values)
    caps = [cap for _, cap in pending]
    pending.clear()
    if n:
        check_cap(n, caps[first])


# ---------------------------------------------------------------------------
# The public body and the three entries
# ---------------------------------------------------------------------------


def spmsv_min(seg: Segments, frontier: torch.Tensor, nr: int,
              col_offset: int = 0, cap_f: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1 through the addressing ``seg``: the int32 candidates
    ((nr,) for a 2D block, (p, nr) on the strips: for each local row the
    smallest global source id ``col_offset + u`` over the frontier
    columns u with an edge into it, else INT_INF) and the edges examined,
    a 0-d int64 tensor (the frontier columns' segment lengths).
    ``frontier`` is the packed int32 words (2D blocks: or a bool mask)
    over the block's columns, the (n/32,) allgathered words on the
    strips.  ``cap_f > 0`` bounds the frontier's id count: a larger
    frontier raises.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, which reads nothing to the host."""
    _check(seg, frontier, nr)
    tensors = [t for t in seg[1:] if t is not None] + [frontier]
    if all(t.device.type == "cpu" for t in tensors):
        return spmsv_min_plain(seg, frontier, nr, col_offset, cap_f)
    _KERNELS[seg.addressing].load()
    require_cuda(*tensors)
    if frontier.dtype == torch.bool:
        if frontier.shape[0] % 32:
            raise ValueError(f"the kernel reads the mask's words: "
                             f"{frontier.shape[0]} columns is not a "
                             f"multiple of 32")
        frontier = pack_bits(frontier)
    cand, out = launch(seg, frontier, nr, col_offset)
    _bound(out[1], cap_f)
    return cand, out[0]


def spmsv_csr_min(frontier: torch.Tensor, col_ptr: torch.Tensor,
                  row_idx: torch.Tensor, nr: int, col_offset: int,
                  cap_f: int = 0) -> torch.Tensor:
    """(nr,) int32 candidates of a 2D block through its ``col_ptr``:
    ``spmsv_min`` on the csr addressing.  ``frontier`` is a bool mask
    over the block's columns or its packed words."""
    return spmsv_min(csr(col_ptr, row_idx), frontier, nr, col_offset,
                     cap_f)[0]


def spmsv_dcsc_min(frontier: torch.Tensor, jc: torch.Tensor,
                   cp: torch.Tensor, nzc: torch.Tensor,
                   row_idx: torch.Tensor, nr: int, col_offset: int,
                   cap_f: int = 0) -> torch.Tensor:
    """(nr,) int32 candidates of a 2D block through its DCSC, each
    frontier id found by binary search in ``jc``: ``spmsv_min`` on the
    dcsc addressing."""
    return spmsv_min(dcsc(jc, cp, nzc, row_idx), frontier, nr, col_offset,
                     cap_f)[0]


def spmsv_strips_csr_min(f_words: torch.Tensor, col_ptr: torch.Tensor,
                         row_idx: torch.Tensor, nr: int, cap_f: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1D strips' top-down SpMSV through the strip ``col_ptr``, all p
    strips at once against the allgathered ``(n/32,)`` frontier words:
    the (p, nr) int32 candidates and the edges examined, a 0-d int64
    tensor (the frontier's segments in every strip)."""
    return spmsv_min(strips(col_ptr, row_idx), f_words, nr, 0, cap_f)
