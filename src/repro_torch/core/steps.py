"""Per-level BFS steps of the 2D checkerboard over the simulated mesh:
top-down (Alg. 3) and bottom-up (Alg. 4).

Every per-processor array carries the (pr, pc) grid as its two leading
dims (see ``core/collectives.py``).  Local discovery runs block by block
through the plan's LocalOps entry; the collectives are tensor ops over
the grid dims.

Counters (dict of float32 scalars, *global* paper units: 1 id = 1 word,
1 bitmap bit = 1/64 word):
  wire_*   what the static-shape implementation moves
  use_*    the paper's sparse-equivalent volume (Eq. 2 validation)
A counter is a numpy float32 where the host knows it (shapes) and a 0-d
float32 tensor where the device computed it, so a level adds no host
read.  Both add in float32 in the JAX package's order; device sums are
taken exactly in int64 and then cast to float32.  With
``LevelArgs.instrument`` False (``cfg.instrument``) a step computes no
counter, on the host or the device, and returns ``{}``.

The frontier crosses levels packed: a step takes the ``Front`` of the
level before it (its words) and ends in the LocalOps entry's level
epilogue (``kernels/epilogue/ops.py``: one kernel launch, or the dense
oracle's plain twin), which updates ``pi`` in place and returns the next
``Front``: the words and the three masses the loop's tail reads.

When the search is traced (``core/trace.py``; the loop hands the
decision down as ``lv["trace"]``), each step's stages are spans:
top-down ``bfs.expand``, ``bfs.discover`` (kernel 1's calls),
``bfs.fold``, ``bfs.update``; bottom-up ``bfs.expand``,
``bfs.discover`` (the sub-steps and kernel 2's calls), ``bfs.exchange``,
``bfs.update``.  Untraced, each site is one branch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, comm_model, trace
from repro_torch.core.frontier import (INT_INF, expand_bitmap, pack_bits,
                                       pack_ids, unpack_bits)
from repro_torch.kernels.epilogue import ops as epilogue

COUNTER_KEYS = ("wire_transpose", "wire_expand", "wire_fold", "wire_rotate",
                "wire_updates", "use_expand", "use_fold", "use_rotate",
                "use_updates", "edges_examined", "edges_useful")

_F32 = np.float32


def zero_counters() -> Dict[str, np.float32]:
    return {k: _F32(0) for k in COUNTER_KEYS}


class LevelArgs(NamedTuple):
    """Static per-plan context threaded into the level steps."""
    part: "object"            # Partition2D
    fold_mode: str            # "alltoall" | "reduce" | "bitmap" | "bitmap_pure"
    perm: Tuple[torch.Tensor, torch.Tensor]  # transpose A->B (src, dst ids)
    seg_ptr: np.ndarray       # (pr, pc, pc+1) host copy of graph.seg_ptr
    ops: "object"             # LocalOps entry
    cap_seg: int = 0          # bottom-up sub-step edge window
    cap_f: int = 0            # kernel mode: frontier bound (0 = nc)
    instrument: bool = True   # False: no counters (the fast loop)
    use_edge_dst: bool = False  # bottom-up: rows from the edge_dst window
    compact_updates: bool = False  # bottom-up: compact (child, parent) sends
    expand_chunks: int = 1    # > 1: the bottom-up R/G split ring


def _blocks(pr: int, pc: int):
    return [(i, j) for i in range(pr) for j in range(pc)]


# ---------------------------------------------------------------------------
# Top-down (Algorithm 3)
# ---------------------------------------------------------------------------


def _fold_alltoall(cand: torch.Tensor, pc: int, chunk: int,
                   tag: str = "") -> torch.Tensor:
    """Paper-faithful fold: all_to_all along the processor row + local min."""
    pr = cand.shape[0]
    r = collectives.all_to_all_cols(cand.reshape(pr, pc, pc, chunk), tag)
    return r.amin(dim=2)


def _fold_ring_reduce(cand: torch.Tensor, pc: int, chunk: int) -> torch.Tensor:
    """Ring reduce-scatter in the (min) semiring: pc-1 neighbour permutes
    along the processor row instead of a full all_to_all."""
    pr = cand.shape[0]
    acc = cand.reshape(pr, pc, pc, chunk)
    if pc == 1:
        return acc[:, :, 0]
    acc = acc.clone()
    j = torch.arange(pc, device=cand.device)
    for t in range(pc - 1):
        piece = acc[:, j, (j - t - 1) % pc]
        recv = collectives.ppermute_col_ring(piece)
        idx_r = (j - t - 2) % pc
        acc[:, j, idx_r] = torch.minimum(acc[:, j, idx_r], recv)
    return acc[:, j, j]


def _fold_bitmap(cand: torch.Tensor, pc: int, chunk: int, cap_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bitmap fold (beyond the paper): presence bitmaps instead of
    dense candidate arrays, then only the winners' parent ids.

    Round 1: each destination chunk's owner receives every source's
             presence bits (an all_to_all of nr/64 words).
    Round 2: the owner picks the lowest source column with a bit (whose
             ids are the smallest) and returns per-source winner bits.
    Round 3: each source compacts the ids it won, ascending, at most
             ``cap_w`` a destination chunk and ``pc*cap_w`` in all
             (the JAX package's ``jnp.where(..., size=pc*cap_w)`` then
             ``rank < cap_w``), and two all_to_alls deliver values and
             local offsets; the owner min-scatters them.

    The bitmaps on the wire are bool tensors here: packing them would
    change no bit.  Returns ``(t (pr, pc, chunk), counts (pr, pc, pc))``,
    the folded candidates and each source's wins a destination chunk;
    wins past the capacities are dropped.  Without a drop the lowest
    source column's candidate is the row's minimum, so ``t`` is then
    ``_fold_alltoall``'s result; the exact "bitmap" mode falls back to
    that fold on a drop (``_fold_bitmap_exact``)."""
    pr = cand.shape[0]
    nr = pc * chunk
    dev = cand.device
    # positions and ranks in int32 while they fit
    ix = torch.int32 if pr * pc * (pc * cap_w + nr) < 2**31 else torch.int64
    present = (cand != INT_INF).reshape(pr, pc, pc, chunk)
    bits = collectives.all_to_all_cols(present)      # [i, j, q]: from q
    j_idx = torch.arange(pc, dtype=ix, device=dev).reshape(1, 1, pc, 1)
    winner = torch.where(bits, j_idx, pc).amin(dim=2)          # (pr, pc, chunk)
    my_wins = collectives.all_to_all_cols(winner.unsqueeze(2) == j_idx)
    counts = my_wins.sum(dim=3)                      # (pr, pc, pc)
    # a win's rank in its destination chunk: one device-wide scan over
    # the flattened rows less each row's count before it (a scan a row
    # over few long rows leaves the card idle); its rank among all wins
    # adds the chunks before it
    m = my_wins.reshape(-1, chunk)
    cum = torch.cumsum(m.reshape(-1), 0, dtype=ix).reshape(m.shape)
    rank = (cum - (cum[:, :1] - m[:, :1].to(ix)) - 1).reshape(
        pr, pc, pc, chunk)
    order = rank + (torch.cumsum(counts, dim=2) - counts).to(ix).unsqueeze(3)
    ok = my_wins & (order < pc * cap_w) & (rank < cap_w)
    # a win that fits lands in its chunk's slot; every other entry gets
    # a slot of its own past them (stores to one spare slot serialise)
    pos = torch.arange(nr, dtype=ix, device=dev).reshape(pc, chunk)
    q = torch.arange(pc, dtype=ix, device=dev).reshape(pc, 1)
    slot = torch.where(ok, q * cap_w + rank, pc * cap_w + pos).reshape(
        pr, pc, nr).to(torch.int64)
    width = pc * cap_w + nr
    send_v = torch.full((pr, pc, width), INT_INF, dtype=torch.int32,
                        device=dev).scatter_(2, slot, cand)
    send_o = torch.full((pr, pc, width), chunk, dtype=torch.int32,
                        device=dev).scatter_(
        2, slot, (pos - q * chunk).to(torch.int32).reshape(nr).expand(
            pr, pc, nr))
    rv = collectives.all_to_all_cols(
        send_v[..., :pc * cap_w].reshape(pr, pc, pc, cap_w))
    ro = collectives.all_to_all_cols(
        send_o[..., :pc * cap_w].reshape(pr, pc, pc, cap_w))
    t = _min_scatter(ro.reshape(pr, pc, -1), rv.reshape(pr, pc, -1), chunk)
    return t, counts


def _min_scatter(idx: torch.Tensor, val: torch.Tensor, chunk: int
                 ) -> torch.Tensor:
    """The receiver's min-scatter of (offset, value) pairs into
    ``chunk``-long rows over the last dim, INT_INF where nothing lands;
    the sentinel offset ``chunk`` drops (each to a slot of its own past
    the row, as one shared spare slot would serialise the updates)."""
    k = idx.shape[-1]
    spare = chunk + torch.arange(k, device=idx.device)
    idx = torch.where(idx < chunk, idx.to(torch.int64), spare)
    out = torch.full((*idx.shape[:-1], chunk + k), INT_INF,
                     dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(-1, idx, val, reduce="amin")[..., :chunk]


def _fold_bitmap_exact(cand: torch.Tensor, pc: int, chunk: int, cap_w: int
                       ) -> torch.Tensor:
    """The exact "bitmap" fold with its runtime fallback: the bitmap
    fold, the overflow pmax (any source chunk past ``cap_w`` wins) and
    the dense fold, the JAX package's ``lax.cond`` over the two.  Both
    branches run on the device and ``torch.where`` takes the dense one
    on an overflow, so the level reads nothing to the host; both are
    recorded, as the JAX program holds both."""
    t, counts = _fold_bitmap(cand, pc, chunk, cap_w)
    over = collectives.pmax(counts) > cap_w
    return torch.where(over, _fold_alltoall(cand, pc, chunk, "fallback"), t)


def topdown_level(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                  front: epilogue.Front, args: LevelArgs, lv: Dict
                  ) -> Tuple[torch.Tensor, epilogue.Front, Dict]:
    """One top-down level.  ``lv`` carries the search loop's host values
    of this level's frontier size ``n_f`` and edge mass ``m_f`` (the fast
    loop's ``over``, which 2D does not read, uninstrumented).  Kernel 1's
    output is the candidates as it is on one block; more blocks stack
    theirs."""
    part = args.part
    pr, pc, chunk, nc, nr = part.pr, part.pc, part.chunk, part.nc, part.nr
    p = _F32(part.p)
    instr = args.instrument
    ctr = zero_counters() if instr else {}
    tr = lv.get("trace")

    # --- Expand: transpose + gather along the processor column ----------
    with trace.OFF if tr is None else tr.span("bfs.expand"):
        f_words, wire = expand_bitmap(front.words, args.perm)
        if instr:
            # the JAX package's psum of n_f: the loop's read holds it
            collectives.noted("psum", collectives.GRID_2D, "counter")
            ctr["wire_transpose"] = _F32(chunk / 64.0) * p
            ctr["wire_expand"] = wire * p - ctr["wire_transpose"]
            ctr["use_expand"] = _F32(lv["n_f"]) * _F32(pr - 1)

    # --- Local discovery: SpMSV in the (select-source, min) semiring -----
    with trace.OFF if tr is None else tr.span("bfs.discover"):
        outs, ex = [], []
        for i, j in _blocks(pr, pc):
            gij = {k: v[i, j] for k, v in g.items()}
            c_ij, ex_ij = args.ops.topdown(gij, f_words[i, j], nr, j * nc,
                                           args)
            outs.append(c_ij)
            ex.append(ex_ij)
        cand = outs[0].reshape(1, 1, nr) if len(outs) == 1 \
            else torch.stack(outs).view(pr, pc, nr)
        if instr:
            ctr["edges_examined"] = collectives.psum(
                torch.stack(ex), tag="counter").to(torch.float32)
            collectives.noted("psum", collectives.GRID_2D, "counter")  # m_f
            ctr["edges_useful"] = _F32(lv["m_f"])

    # --- Fold: exchange candidates along the processor row ---------------
    with trace.OFF if tr is None else tr.span("bfs.fold"):
        wire_fold = _F32((pc - 1) * chunk) * p
        cap_w = max(chunk // 16, 32)
        if args.fold_mode == "alltoall":
            t = _fold_alltoall(cand, pc, chunk)
        elif args.fold_mode == "reduce":
            t = _fold_ring_reduce(cand, pc, chunk)
        elif args.fold_mode == "bitmap":
            t = _fold_bitmap_exact(cand, pc, chunk, cap_w)
        elif args.fold_mode == "bitmap_pure":
            # drops the wins past cap_w by design
            t, _ = _fold_bitmap(cand, pc, chunk, cap_w)
        else:
            raise ValueError(f"fold_mode={args.fold_mode!r} is not a fold")
        if args.fold_mode.startswith("bitmap"):
            wire_fold = _F32(comm_model.fold_bitmap_level_words(
                pc * chunk, pc, cap_w)) * p
        if instr:
            ctr["wire_fold"] = wire_fold
            n_cand = collectives.psum(cand != INT_INF,
                                      tag="counter").to(torch.float32)
            ctr["use_fold"] = 2.0 * n_cand           # (child, parent) pairs

    # --- Local update: the level epilogue --------------------------------
    with trace.OFF if tr is None else tr.span("bfs.update"):
        front = args.ops.epilogue(pi, g["deg_A"], t.contiguous())
    return pi, front, ctr


# ---------------------------------------------------------------------------
# Bottom-up (Algorithm 4)
# ---------------------------------------------------------------------------


def _scatter_compact(pairs: torch.Tensor, cap_u: int, chunk: int
                     ) -> torch.Tensor:
    """The compact update exchange: ``pairs`` ``(pr, pc, pc, 2*cap_u)``
    holds, for each destination, ``cap_u`` children then their parents,
    and one all_to_all delivers them; the receiver min-scatters each
    source's pairs into a dense ``(pr, pc, pc, chunk)`` segment (the
    sentinel child ``chunk`` drops)."""
    r = collectives.all_to_all_cols(pairs)
    return _min_scatter(r[..., :cap_u], r[..., cap_u:].contiguous(),
                        chunk).contiguous()


def bottomup_level(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                   front: epilogue.Front, args: LevelArgs, lv: Dict
                   ) -> Tuple[torch.Tensor, epilogue.Front, Dict]:
    """One bottom-up level: pc sub-steps with the completed bitmap rotating
    along the processor row (Fig. 1).

    Sub-step s of processor (i, j) scans the segment owned by (i, j-s mod
    pc), so the segments are destination-disjoint: they collect in a
    per-destination buffer and one all_to_all delivers them at level end.
    Updates are applied in sub-step order, and the rotating bitmap marks
    each vertex at its first discovery, so parents are those of a
    per-sub-step exchange.  The level epilogue applies them where they
    lie: sub-step 0 from ``self_par``, sub-step s > 0 from the exchange's
    slot of the sender s columns on.

    ``compact_updates`` ships, for each sub-step s > 0, the first
    ``cap_u`` finds (ascending) as (child, parent) pairs in one
    all_to_all.  With a "*_pure" fold mode the finds past ``cap_u`` drop
    by design.  Otherwise the JAX package's runtime fallback applies: the
    overflow pmax (any sub-step past ``cap_u`` finds) re-ships the level's
    dense segments.  Both exchanges run on the device and ``torch.where``
    takes the dense one on an overflow, so the level reads nothing to the
    host; both are recorded, as the JAX program holds both branches.

    ``expand_chunks > 1`` runs the JAX package's R/G split ring: the R
    chain rotates the pre-level completed bitmap (its permute waits on no
    scan), the G chain this level's finds, 2(pc-1) permutes a level.  The
    scan runs against R alone and its re-finds of rows that G marks are
    masked out after it; a row's scan reads only its own completed bit,
    so parents and counters equal the one ring's.  ``use_edge_dst`` hands
    the scan the ``edge_dst`` window (a kernel entry ships none and
    ignores it)."""
    part = args.part
    pr, pc, chunk, nc = part.pr, part.pc, part.chunk, part.nc
    p = _F32(part.p)
    instr = args.instrument
    ctr = zero_counters() if instr else {}
    dev = pi.device
    tr = lv.get("trace")

    # --- Gather the frontier (dense bitmap) -------------------------------
    with trace.OFF if tr is None else tr.span("bfs.expand"):
        f_words, wire = expand_bitmap(front.words, args.perm)
        if instr:
            ctr["wire_transpose"] = _F32(chunk / 64.0) * p
            ctr["wire_expand"] = wire * p - ctr["wire_transpose"]
            ctr["use_expand"] = _F32(chunk / 64.0 * (1 + (pr - 1))) * p

    cap_u = max(chunk // 8, 32)           # finds a compact sub-step
    compact = args.compact_updates
    pure = args.fold_mode.endswith("_pure")
    pipelined = args.expand_chunks > 1
    rings = 2 if pipelined else 1
    use_ve = args.use_edge_dst and "edge_dst" in g
    cseg = pi != -1                       # completed = has parent (own chunk)
    edges_use = _F32(0)
    if compact:
        send_p = torch.full((pr, pc, pc, 2 * cap_u), INT_INF,
                            dtype=torch.int32, device=dev)
        send_p[..., :cap_u] = chunk
        max_found = torch.zeros((), dtype=torch.int64, device=dev)
    if not (compact and pure):
        # at pc = 1 the one slot is the self slot, which is never sent: the
        # buffer the recorded exchange moves is then never read
        send_d = torch.full((pr, pc, pc, chunk), INT_INF, dtype=torch.int32,
                            device=dev) if pc > 1 else \
            torch.empty((pr, pc, pc, chunk), dtype=torch.int32, device=dev)
    self_outs = []                        # sub-step 0's, a block each
    # the R chain rides ``carry`` from the start; the G chain (``g_acc``)
    # is empty at sub-step 0, so its masks start at sub-step 1
    carry = pack_bits(cseg) if pipelined and pc > 1 else None
    g_seen = None

    # --- Sub-steps: kernel 2 on the rotating segments -------------------
    with trace.OFF if tr is None else tr.span("bfs.discover"):
        for s in range(pc):
            if s > 0:
                carry = collectives.ppermute_col_ring(carry)
                if pipelined:
                    g_seen = unpack_bits(collectives.ppermute_col_ring(g_acc))
                cseg = unpack_bits(carry)
                if instr:
                    ctr["wire_rotate"] += _F32(rings * chunk / 64.0) * p
                    ctr["use_rotate"] += _F32(chunk / 64.0) * p
            # this level's finds so far, for the next sub-step's G
            g_next = None
            if pipelined and s < pc - 1:
                g_next = torch.zeros_like(cseg) if g_seen is None \
                    else g_seen.clone()
            use_loc, n_upd = [], []
            for i, j in _blocks(pr, pc):
                seg_id = (j - s) % pc
                e0 = int(args.seg_ptr[i, j, seg_id])
                e1 = int(args.seg_ptr[i, j, seg_id + 1])
                rp_seg = g["row_ptr"][i, j, seg_id * chunk:
                                      (seg_id + 1) * chunk + 1]
                if e0:                    # the segment's own edge offsets
                    rp_seg = rp_seg - e0
                ue = g["col_idx"][i, j, e0:e0 + args.cap_seg]
                ve = g["edge_dst"][i, j, e0:e0 + args.cap_seg] \
                    - seg_id * chunk if use_ve else None
                cvec = cseg[i, j].to(torch.int32)
                seg_par = args.ops.bottomup(rp_seg, ue, f_words[i, j], cvec,
                                            j * nc, e1 - e0, ve)
                # at pc = 1 only the counters read the finds
                found = seg_par != INT_INF if instr or pc > 1 else None
                if g_seen is not None:
                    # the exactness post-filter: rows G marks were found on an
                    # earlier sub-step of this level
                    found &= ~g_seen[i, j]
                    seg_par = torch.where(found, seg_par, INT_INF)
                if g_next is not None:
                    g_next[i, j] |= found
                if instr:
                    row_lens = rp_seg[1:] - rp_seg[:-1]
                    unknown = ~(cseg[i, j] | g_seen[i, j]) \
                        if g_seen is not None else cvec == 0
                    use_loc.append(torch.where(unknown, row_lens, 0)
                                   .sum(dtype=torch.int64))
                    n_upd.append(found.sum())
                # the s = 0 self segment pays no wire, is never capacity-
                # truncated and is the epilogue's slot 0
                if s == 0:
                    self_outs.append(seg_par)
                else:
                    if compact:
                        # the first cap_u finds as (child, parent) pairs
                        cidx = pack_ids(found, cap_u, 0, chunk)
                        send_p[i, j, seg_id, :cap_u] = cidx
                        send_p[i, j, seg_id, cap_u:] = seg_par[
                            cidx.clamp(max=chunk - 1).to(torch.int64)]
                        if not pure:
                            max_found = torch.maximum(max_found, found.sum())
                    if not (compact and pure):
                        send_d[i, j, seg_id] = seg_par
                if not pipelined and s != pc - 1:
                    cseg[i, j] |= found
            if instr:
                edges_use = edges_use + collectives.psum(
                    torch.stack(use_loc), tag="counter").to(torch.float32)
                if s > 0:
                    ctr["wire_updates"] += _F32(
                        2 * cap_u if compact else chunk) * p
                ctr["use_updates"] = ctr["use_updates"] + 2.0 * (
                    collectives.psum(torch.stack(n_upd),
                                     tag="counter").to(torch.float32))
            if g_next is not None:
                g_acc = pack_bits(g_next)     # R rides ``carry`` unchanged
            elif not pipelined and s != pc - 1:
                carry = pack_bits(cseg)

    # --- Batched update exchange (one all_to_all) -------------------------
    with trace.OFF if tr is None else tr.span("bfs.exchange"):
        if compact and pure:
            recv = _scatter_compact(send_p, cap_u, chunk)
        elif compact:
            over = collectives.pmax(max_found) > cap_u
            dense = collectives.all_to_all_cols(send_d, "fallback")
            recv = torch.where(over, dense,
                               _scatter_compact(send_p, cap_u, chunk))
        else:
            recv = collectives.all_to_all_cols(send_d)

    # --- Apply updates in sub-step order: the level epilogue -------------
    with trace.OFF if tr is None else tr.span("bfs.update"):
        self_par = self_outs[0].reshape(1, 1, chunk) if len(self_outs) == 1 \
            else torch.stack(self_outs).view(pr, pc, chunk)
        front = args.ops.epilogue(pi, g["deg_A"], self_par,
                                  recv if pc > 1 else None)

    if instr:
        ctr["edges_useful"] = edges_use
        ctr["edges_examined"] = edges_use
    return pi, front, ctr
