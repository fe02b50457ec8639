"""The 1D strip SpMSV over the strip DCSC: wrappers of the CUDA kernels
``csrc/spmsv_strip_min.cu`` (the whole allgathered frontier bitmap) and
``csrc/spmsv_strip_chunk_min.cu`` (one sub-chunk of the pipelined
expand), which both walk the frontier's ids or the columns, whichever is
cheaper, chosen on the card (``csrc/strip_walk.cuh``); their plain
PyTorch versions; and the port's copies of the JAX package's
``_dcsc_edges_examined`` and ``_dcsc_edges_examined_chunk``.

Every function takes all p strips at once: ``jc (p, cap_nzc)``, ``cp (p,
cap_nzc+1)``, ``nzc (p,)``, ``row_idx (p, cap)``, and returns the ``(p,
nr)`` int32 candidates (for each local row the smallest global frontier
column with an edge into it, else INT_INF) and the edges examined, a 0-d
int64 tensor: the frontier columns' segment lengths.  A slot is live when
``slot < nzc``, ``jc < n`` (the sentinel) and its column is in the
frontier.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.frontier import INT_INF, test_bits, unpack_bits
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle

KERNEL = CudaKernel("spmsv_strip_min", [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
KERNEL_CHUNK = CudaKernel("spmsv_strip_chunk_min", [ctypes.c_void_p] * 8 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])

# the walks of both kernels, as their stats[2] reports them
WALK_FRONTIER, WALK_COLUMNS = 1, 2
MAX_CHUNK_STRIPS = 32          # the chunk kernel's tile prefix, p*p slots


def _slots_alive(jc: torch.Tensor, nzc: torch.Tensor, n: int) -> torch.Tensor:
    slot = torch.arange(jc.shape[1], device=jc.device)
    return (slot < nzc.reshape(-1, 1)) & (jc < n)


def live_slots(jc, nzc, f_words) -> torch.Tensor:
    """(p, cap_nzc) bool: the slots whose column is in the bitmap."""
    n = f_words.shape[0] * 32
    return _slots_alive(jc, nzc, n) & test_bits(f_words, jc.clamp(max=n - 1))


def live_slots_chunk(jc, nzc, f_sub, k: int, n_chunks: int, chunk: int,
                     n: int) -> torch.Tensor:
    """(p, cap_nzc) bool: the slots whose column lies in sub-chunk k and
    is set in the owner-major sub-chunk words ``f_sub``."""
    wpc = chunk // 32
    w_sub = wpc // n_chunks
    uc = jc.clamp(max=n - 1).to(torch.int64)
    wi = uc >> 5
    owner = torch.div(wi, wpc, rounding_mode="floor")
    lw = wi - owner * wpc
    in_rng = (lw >= k * w_sub) & (lw < (k + 1) * w_sub)
    pos = torch.where(in_rng, owner * w_sub + (lw - k * w_sub), 0)
    bit = ((f_sub[pos] >> (uc & 31)) & 1).to(torch.bool)
    return _slots_alive(jc, nzc, n) & in_rng & bit


def _examined(cp, live) -> torch.Tensor:
    return torch.where(live, cp[:, 1:] - cp[:, :-1], 0).sum(dtype=torch.int64)


def dcsc_edges_examined(jc, cp, nzc, f_words) -> torch.Tensor:
    """Sum of the frontier columns' segment lengths, straight off the
    compressed pointers (padded slots have empty segments)."""
    return _examined(cp, live_slots(jc, nzc, f_words))


def dcsc_edges_examined_chunk(jc, cp, nzc, f_sub, k: int, n_chunks: int,
                              chunk: int, n: int) -> torch.Tensor:
    """The same for one pipelined sub-chunk; the sums of the n_chunks
    steps add up to ``dcsc_edges_examined``."""
    return _examined(cp, live_slots_chunk(jc, nzc, f_sub, k, n_chunks,
                                          chunk, n))


def gather_segments_plain(jc, cp, row_idx, live, nr: int):
    """Every edge of the live slots: (rows, cols, edge count) with
    ``rows`` the flat int64 index of its candidate in (p*nr) and
    ``cols`` its int32 global source column."""
    p, cap_nzc = jc.shape
    dev = jc.device
    lens = torch.where(live, cp[:, 1:] - cp[:, :-1], 0).reshape(-1).to(
        torch.int64)
    total = int(lens.sum())
    sl = torch.repeat_interleave(torch.arange(p * cap_nzc, device=dev), lens)
    offs = torch.cumsum(lens, 0) - lens
    strip = torch.div(sl, cap_nzc, rounding_mode="floor")
    pos = (strip * row_idx.shape[1] + cp[:, :-1].reshape(-1)[sl]
           + torch.arange(total, device=dev) - offs[sl])
    return strip * nr + row_idx.reshape(-1)[pos], jc.reshape(-1)[sl], total


def gather_min_plain(jc, cp, row_idx, live, nr: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand every live slot into its edges, then scatter-min the
    column ids into the strips' (p, nr) candidates."""
    rows, cols, total = gather_segments_plain(jc, cp, row_idx, live, nr)
    out = torch.full((jc.shape[0] * nr,), INT_INF, dtype=torch.int32,
                     device=jc.device)
    out.scatter_reduce_(0, rows, cols, reduce="amin")
    return out.reshape(jc.shape[0], nr), torch.tensor(total,
                                                      device=jc.device)


def _check(jc, cp, nzc, row_idx, words, nr):
    for name, t in (("jc", jc), ("cp", cp), ("nzc", nzc),
                    ("row_idx", row_idx), ("frontier words", words)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    p = jc.shape[0]
    if (jc.dim() != 2 or cp.shape != (p, jc.shape[1] + 1)
            or nzc.shape != (p,) or row_idx.dim() != 2
            or row_idx.shape[0] != p or words.dim() != 1 or nr <= 0):
        raise ValueError(f"strip shapes disagree: jc {tuple(jc.shape)}, cp "
                         f"{tuple(cp.shape)}, nzc {tuple(nzc.shape)}, "
                         f"row_idx {tuple(row_idx.shape)}, words "
                         f"{tuple(words.shape)}, nr {nr}")


def launch(jc, cp, nzc, row_idx, f_words, nr: int, list_cap: int = None):
    """The kernel's launch on checked CUDA tensors: (cand, edges examined,
    walk taken), the last two 0-d int64 tensors on the card.
    ``list_cap`` overrides the walk threshold (``list_capacity`` at one
    step); any number of strips."""
    p, cap_nzc = jc.shape
    if list_cap is None:
        list_cap = list_capacity(cap_nzc, 1)
    cand, stats, ids = walk_scratch(p, nr, list_cap, jc.device)
    KERNEL.launch(jc.data_ptr(), cp.data_ptr(), nzc.data_ptr(),
                  row_idx.data_ptr(), f_words.data_ptr(), cand.data_ptr(),
                  stats.data_ptr(), ids.data_ptr(), p, cap_nzc,
                  row_idx.shape[1], nr, f_words.shape[0] * 32, list_cap,
                  stream_handle(jc.device))
    return cand, stats[0], stats[2]


def spmsv_strip_dcsc_plain(jc, cp, nzc, row_idx, f_words, nr: int):
    return gather_min_plain(jc, cp, row_idx, live_slots(jc, nzc, f_words),
                            nr)


def spmsv_strip_dcsc(jc: torch.Tensor, cp: torch.Tensor, nzc: torch.Tensor,
                     row_idx: torch.Tensor, f_words: torch.Tensor, nr: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strip SpMSV against the whole ``(n/32,)`` frontier bitmap:
    ``(cand (p, nr) int32, edges examined)``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(jc, cp, nzc, row_idx, f_words, nr)
    tensors = (jc, cp, nzc, row_idx, f_words)
    if all(t.device.type == "cpu" for t in tensors):
        return spmsv_strip_dcsc_plain(jc, cp, nzc, row_idx, f_words, nr)
    KERNEL.load()
    require_cuda(*tensors)
    return launch(jc, cp, nzc, row_idx, f_words, nr)[:2]


def _sub_dims(f_sub, n: int, p: int, n_chunks: int):
    wpc = (n // p) // 32
    w_sub = wpc // n_chunks
    if n_chunks < 1 or wpc % n_chunks or f_sub.shape[0] != p * w_sub:
        raise ValueError(
            f"sub-chunk buffer has {f_sub.shape[0]} words, expected "
            f"p*w_sub = {p}*{w_sub} for n={n}, n_chunks={n_chunks}")
    return wpc, w_sub


# a binary-search probe of the frontier walk against a slot of the
# column walk: a probe costs about a fifth of a slot (the searches' first
# steps hit the cache), from the crossover of the two walks forced on
# the calls of the scale-24 1ds searches on an H100 at 4 steps (kernel
# 4), and checked at one step (kernel 3: the frontier walk ahead at
# 369,777-824,653 ids, the column walk from 3,046,908; threshold
# 1,442,928) (chip_smoke.py phase 8, PERF.md)
PROBE_COST = (1, 5)


def list_capacity(cap_nzc: int, n_chunks: int) -> int:
    """The walk threshold of both kernels (kernel 3 at n_chunks = 1), and
    the length of their frontier id list: the frontier walk
    binary-searches each id in every strip's jc, about L =
    bit_length(cap_nzc) probes a strip, where the column walk tests about
    cap_nzc / n_chunks slots a strip; so a step walks the frontier while
    count * L * PROBE_COST <= cap_nzc / n_chunks."""
    num, den = PROBE_COST
    return max(1, cap_nzc * den // (n_chunks * num
                                     * max(1, cap_nzc.bit_length())))


def walk_scratch(p: int, nr: int, list_cap: int, dev, n_ranges: int = 0):
    """The outputs and scratch of either kernel: the (p, nr) candidates
    at INT_INF, the (4,) int64 stats at 0 (edges examined, frontier
    count, walk taken, the walk's work counter), and the int32 scratch
    of list_cap frontier ids and 2 slot bounds for each of ``n_ranges``
    ranges (the kernel writes all it reads)."""
    cand = torch.full((p, nr), INT_INF, dtype=torch.int32, device=dev)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    scratch = torch.empty(list_cap + 2 * n_ranges, dtype=torch.int32,
                          device=dev)
    return cand, stats, scratch


def chunk_scratch(p: int, nr: int, list_cap: int, dev):
    """The chunk kernel's: ``walk_scratch`` with the slot ranges of the
    p*p (strip, owner) pairs."""
    return walk_scratch(p, nr, list_cap, dev, n_ranges=p * p)


def frontier_ids_chunk(f_sub, p: int, chunk: int, k: int) -> torch.Tensor:
    """The global ids of the set bits of step k's owner-major sub-chunk
    words, ascending: owner o's bit j is o*chunk + k*sub + j (sub the
    sub-chunk's width).  The kernel builds the same set, unordered."""
    sub = f_sub.shape[0] // p * 32
    j = torch.nonzero(unpack_bits(f_sub)).reshape(-1)
    owner = torch.div(j, sub, rounding_mode="floor")
    return (owner * chunk + k * sub + (j - owner * sub)).to(torch.int32)


def chunk_walk(f_words, list_cap: int) -> int:
    """The walk either kernel takes on these frontier words (a step's
    sub-chunk words or the whole bitmap): the frontier walk while they
    hold at most list_cap ids."""
    return WALK_FRONTIER if popcount(f_words) <= list_cap else WALK_COLUMNS


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words."""
    return int(unpack_bits(words).sum())


def launch_chunk(jc, cp, nzc, row_idx, f_sub, nr: int, n: int, k: int,
                 n_chunks: int, list_cap: int = None):
    """The chunk kernel's launch on checked CUDA tensors: (cand, edges
    examined, walk taken), the last two 0-d int64 tensors on the card.
    ``list_cap`` overrides the walk threshold (``list_capacity``)."""
    p, cap_nzc = jc.shape
    _, w_sub = _sub_dims(f_sub, n, p, n_chunks)
    if p > MAX_CHUNK_STRIPS:
        raise ValueError(f"the chunk kernel takes at most "
                         f"{MAX_CHUNK_STRIPS} strips, got {p}")
    if list_cap is None:
        list_cap = list_capacity(cap_nzc, n_chunks)
    cand, stats, scratch = chunk_scratch(p, nr, list_cap, jc.device)
    KERNEL_CHUNK.launch(jc.data_ptr(), cp.data_ptr(), nzc.data_ptr(),
                        row_idx.data_ptr(), f_sub.data_ptr(),
                        cand.data_ptr(), stats.data_ptr(),
                        scratch.data_ptr(), p, cap_nzc, row_idx.shape[1], nr,
                        n // p, w_sub, k, list_cap, stream_handle(jc.device))
    return cand, stats[0], stats[2]


def spmsv_strip_dcsc_chunk_plain(jc, cp, nzc, row_idx, f_sub, nr: int,
                                 n: int, k: int, n_chunks: int):
    live = live_slots_chunk(jc, nzc, f_sub, k, n_chunks, n // jc.shape[0],
                            n)
    return gather_min_plain(jc, cp, row_idx, live, nr)


def spmsv_strip_dcsc_chunk(jc: torch.Tensor, cp: torch.Tensor,
                           nzc: torch.Tensor, row_idx: torch.Tensor,
                           f_sub: torch.Tensor, nr: int, *, n: int, k: int,
                           n_chunks: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strip SpMSV of pipelined step ``k`` of ``n_chunks``, against
    the raw owner-major ``(p * w_sub,)`` sub-chunk words (w_sub =
    (n/p/32)/n_chunks): ``(cand (p, nr) int32, edges examined)``.  The
    caller min-combines the steps.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check(jc, cp, nzc, row_idx, f_sub, nr)
    _sub_dims(f_sub, n, jc.shape[0], n_chunks)
    if not 0 <= k < n_chunks:
        raise ValueError(f"step k={k} outside [0, {n_chunks})")
    tensors = (jc, cp, nzc, row_idx, f_sub)
    if all(t.device.type == "cpu" for t in tensors):
        return spmsv_strip_dcsc_chunk_plain(jc, cp, nzc, row_idx, f_sub, nr,
                                            n, k, n_chunks)
    KERNEL_CHUNK.load()
    require_cuda(*tensors)
    return launch_chunk(jc, cp, nzc, row_idx, f_sub, nr, n, k, n_chunks)[:2]
