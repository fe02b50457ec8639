"""Per-level BFS steps of the 1D row strips (the paper's Alg. 1/2
baseline, Buluc & Madduri) over the simulated p-strip mesh.

Every per-processor array carries the strip as its leading dim ``(p,
...)``; the allgather of the packed frontier is a reshape of the ``(p,
chunk/32)`` words to ``(n/32,)``, which every strip receives whole.

  expand : pack the owned frontier chunks, allgather -> the n-bit
           frontier.  It replaces the 2D transpose and fold, so the
           allgather is a 1D level's whole wire volume.
  local  : top-down, the strip SpMSV of the LocalOps entry over all
           strips at once; bottom-up, the scan of each strip's unvisited
           rows, all strips in one launch on a kernel entry, strip by
           strip on a dense one.  Children are always locally owned (a
           strip holds every edge into its vertices), so the update is
           local and fold-free.

Counters share ``steps.COUNTER_KEYS`` with 2D; 1D leaves the transpose,
fold, rotate and update wires at zero.  ``wire_expand`` per level is the
closed form ``comm_model.expand_1d_level_words``, in float32.  With
``LevelArgs1D.instrument`` False a step computes no counter and returns
``{}``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, comm_model
from repro_torch.core.collectives import STRIPS
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.core.steps import zero_counters

_F32 = np.float32


class LevelArgs1D(NamedTuple):
    """Static per-plan context threaded into the 1D (and 1ds) steps."""
    part: "object"            # Partition1D
    ops: "object"             # LocalOps entry
    nnz: np.ndarray           # (p,) host copy of graph.nnz (dense entries)
    expand_chunks: int = 1    # pipelined expand: top-down sub-chunk steps
    cap_x: int = 0            # 1ds: ids per send bucket
    cap_f: int = 0            # kernel csr: frontier bound (0 = none)
    codec: str = "none"       # 1ds: bucket encoding, "none" | "packed"
    instrument: bool = True   # False: no counters (the fast loop)
    use_edge_dst: bool = False  # bottom-up: rows from edge_dst (dense entries)


def expand_frontier_1d(front: torch.Tensor) -> Tuple[torch.Tensor, np.float32]:
    """Allgather the packed ``(p, chunk)`` frontier: ``(f_words (n/32,)
    int32, wire)`` with the float32 global wire words of the level."""
    p = front.shape[0]
    words = pack_bits(front)
    wire = _F32(comm_model.expand_1d_level_words(words.numel() * 32, p))
    return collectives.all_gather_tiled(words, STRIPS), wire


# ---------------------------------------------------------------------------
# Software-pipelined (chunked) expand
# ---------------------------------------------------------------------------
#
# With ``expand_chunks = C > 1`` the top-down expand splits each owner's
# packed words into C contiguous sub-chunks and exchanges them one at a
# time, each consumed by a partial SpMSV.  Every top-down closure takes a
# min over global source ids, so the partial candidates min-combine
# exactly.  Bottom-up keeps the one dense allgather: its scan takes the
# first frontier in-neighbour, which partial bitmaps would not give.
# On one card the steps run one after the other: the JAX package issues
# step k+1's collective before consuming step k to overlap the two, and
# the simulated mesh has no collective to overlap.
#
# Gathered sub-chunk layout (the dense gather and the 1ds sub-bucket
# decode both give it): ``(p * w_sub,)`` words, owner-major -- owner i's
# words of its LOCAL word range [k*w_sub, (k+1)*w_sub) sit at
# [i*w_sub, (i+1)*w_sub).


def _consume_subchunk(g, g_k: torch.Tensor, k: int, n_chunks: int,
                      args: LevelArgs1D):
    """Local discovery over one gathered sub-chunk -> (cand, ex).  An
    entry with a ``topdown_chunk`` closure reads the raw sub-chunk
    words; any other gets them scattered into a full-size partial
    bitmap and runs its ``topdown`` closure."""
    ops = args.ops
    if ops.topdown_chunk is not None:
        return ops.topdown_chunk(g, g_k, k, n_chunks, args)
    p = args.part.p
    w_sub = g_k.numel() // p
    fw_k = torch.zeros((p, n_chunks, w_sub), dtype=torch.int32,
                       device=g_k.device)
    fw_k[:, k] = g_k.reshape(p, w_sub)
    return ops.topdown(g, fw_k.reshape(-1), args)


def pipelined_expand_consume(g, sub_gather: Callable, n_chunks: int,
                             args: LevelArgs1D):
    """The C-step expand/discover pipeline: ``sub_gather(k)`` gives the
    owner-major words of sub-chunk k; the candidates min-combine across
    steps and the edges examined add up (instrumented only)."""
    cand, ex = None, 0
    for k in range(n_chunks):
        c_k, e_k = _consume_subchunk(g, sub_gather(k), k, n_chunks, args)
        cand = c_k if cand is None else torch.minimum(cand, c_k)
        if args.instrument:
            ex = ex + e_k
    return cand, ex


def _pipelined_topdown_expand_1d(g, front: torch.Tensor, args: LevelArgs1D):
    """Chunked dense expand: C sub-chunk gathers, each consumed by a
    partial SpMSV.  Returns (cand, ex, wire)."""
    part = args.part
    c = args.expand_chunks
    words = pack_bits(front).reshape(part.p, c, -1)
    cand, ex = pipelined_expand_consume(
        g, lambda k: collectives.all_gather_tiled(words[:, k], STRIPS), c,
        args)
    wire = _F32(comm_model.chunked_expand_1d_level_words(part.n, part.p, c))
    return cand, ex, wire


def update(pi, cand):
    """The local update (children are owned, so there is no fold):
    (pi with the new parents, the newly discovered mask)."""
    newly = (pi == -1) & (cand != INT_INF)
    return torch.where(newly, cand, pi), newly


def topdown_counters(lv, wire, ex) -> Dict:
    """Counters of a top-down level shared by "1d" and "1ds"; ``lv``
    carries the loop's float32 frontier size and edge mass.  The JAX
    package takes n_f, the edges examined and m_f with three psums over
    the strips; the port's values are already global (the loop's read,
    and the discovery closures' sums over all strips), so they are
    recorded only."""
    for _ in range(3):
        collectives.noted("psum", STRIPS, "counter")
    ctr = zero_counters()
    ctr["wire_expand"] = wire
    ctr["edges_examined"] = torch.as_tensor(ex).to(torch.float32)
    ctr["edges_useful"] = _F32(lv["m_f"])
    return ctr


def topdown_level_1d(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                     front: torch.Tensor, args: LevelArgs1D, lv: Dict
                     ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One 1D top-down level: allgather the bitmap (in C steps when
    pipelined), the strip SpMSV, the local update."""
    if args.expand_chunks > 1:
        cand, ex, wire = _pipelined_topdown_expand_1d(g, front, args)
    else:
        f_words, wire = expand_frontier_1d(front)
        cand, ex = args.ops.topdown(g, f_words, args)
    ctr = {}
    if args.instrument:
        ctr = topdown_counters(lv, wire, ex)
        ctr["use_expand"] = _F32(lv["n_f"]) * _F32(args.part.p - 1)
    pi, newly = update(pi, cand)
    return pi, newly, ctr


def bottomup_level_1d(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                      front: torch.Tensor, args: LevelArgs1D, lv: Dict
                      ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One 1D bottom-up level: the same bitmap allgather, then each
    strip scans its unvisited rows for an in-neighbour in the frontier
    -- one sub-step over the whole strip, no rotation (the strip holds
    every potential parent edge).  An entry with a ``bottomup_strips``
    closure scans all p strips in one launch; any other runs its
    ``bottomup`` closure strip by strip, handing it the strip's
    ``edge_dst`` rows with ``use_edge_dst`` where the entry ships them
    (as the JAX package does; the kernel entries ship none)."""
    part = args.part
    f_words, wire = expand_frontier_1d(front)
    cvec = (pi != -1).to(torch.int32)
    use_ve = args.use_edge_dst and "edge_dst" in g
    if args.ops.bottomup_strips is not None:
        seg_par = args.ops.bottomup_strips(g, f_words, cvec, args)
    else:
        seg_par = torch.stack([
            args.ops.bottomup(g["row_ptr"][i], g["col_idx"][i], f_words,
                              cvec[i], 0, int(args.nnz[i]),
                              g["edge_dst"][i] if use_ve else None)
            for i in range(part.p)])
    pi, newly = update(pi, seg_par)
    if not args.instrument:
        return pi, newly, {}

    ctr = zero_counters()
    ctr["wire_expand"] = wire
    ctr["use_expand"] = _F32(comm_model.expand_1d_level_words(part.n, part.p))
    row_lens = g["row_ptr"][:, 1:] - g["row_ptr"][:, :-1]
    edges_use = collectives.psum(torch.where(cvec == 0, row_lens, 0),
                                 STRIPS, "counter").to(torch.float32)
    ctr["edges_examined"] = edges_use
    ctr["edges_useful"] = edges_use
    # updates are local in 1D: use_updates counts discoveries, the
    # update wire stays 0
    ctr["use_updates"] = 2.0 * collectives.psum(
        newly, STRIPS, "counter").to(torch.float32)
    return pi, newly, ctr
