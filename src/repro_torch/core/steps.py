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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.frontier import (INT_INF, expand_bitmap, pack_bits,
                                       unpack_bits)

COUNTER_KEYS = ("wire_transpose", "wire_expand", "wire_fold", "wire_rotate",
                "wire_updates", "use_expand", "use_fold", "use_rotate",
                "use_updates", "edges_examined", "edges_useful")

_F32 = np.float32


def zero_counters() -> Dict[str, np.float32]:
    return {k: _F32(0) for k in COUNTER_KEYS}


class LevelArgs(NamedTuple):
    """Static per-plan context threaded into the level steps."""
    part: "object"            # Partition2D
    fold_mode: str            # "alltoall" | "reduce"
    perm: Tuple[torch.Tensor, torch.Tensor]  # transpose A->B (src, dst ids)
    seg_ptr: np.ndarray       # (pr, pc, pc+1) host copy of graph.seg_ptr
    ops: "object"             # LocalOps entry
    cap_seg: int = 0          # bottom-up sub-step edge window
    cap_f: int = 0            # kernel mode: frontier bound (0 = nc)
    instrument: bool = True   # False: no counters (the fast loop)


def _blocks(pr: int, pc: int):
    return [(i, j) for i in range(pr) for j in range(pc)]


# ---------------------------------------------------------------------------
# Top-down (Algorithm 3)
# ---------------------------------------------------------------------------


def _fold_alltoall(cand: torch.Tensor, pc: int, chunk: int) -> torch.Tensor:
    """Paper-faithful fold: all_to_all along the processor row + local min."""
    pr = cand.shape[0]
    r = collectives.all_to_all_cols(cand.reshape(pr, pc, pc, chunk))
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


def topdown_level(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                  front: torch.Tensor, args: LevelArgs, lv: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One top-down level.  ``lv`` carries the search loop's host values
    of this level's frontier size ``n_f`` and edge mass ``m_f`` (the fast
    loop's ``over``, which 2D does not read, uninstrumented)."""
    part = args.part
    pr, pc, chunk, nc, nr = part.pr, part.pc, part.chunk, part.nc, part.nr
    p = _F32(part.p)
    instr = args.instrument
    ctr = zero_counters() if instr else {}

    # --- Expand: transpose + gather along the processor column ----------
    f_words, wire = expand_bitmap(front, args.perm)
    f_cj = unpack_bits(f_words)                      # (pr, pc, nc) bool
    if instr:
        ctr["wire_transpose"] = _F32(chunk / 64.0) * p
        ctr["wire_expand"] = wire * p - ctr["wire_transpose"]
        ctr["use_expand"] = _F32(lv["n_f"]) * _F32(pr - 1)

    # --- Local discovery: SpMSV in the (select-source, min) semiring -----
    cand = torch.empty((pr, pc, nr), dtype=torch.int32, device=pi.device)
    ex = []
    for i, j in _blocks(pr, pc):
        gij = {k: v[i, j] for k, v in g.items()}
        cand[i, j], ex_ij = args.ops.topdown(gij, f_words[i, j], f_cj[i, j],
                                             nr, j * nc, args)
        ex.append(ex_ij)
    if instr:
        ctr["edges_examined"] = collectives.psum(
            torch.stack(ex)).to(torch.float32)
        ctr["edges_useful"] = _F32(lv["m_f"])

    # --- Fold: exchange candidates along the processor row ---------------
    if args.fold_mode == "alltoall":
        t = _fold_alltoall(cand, pc, chunk)
    elif args.fold_mode == "reduce":
        t = _fold_ring_reduce(cand, pc, chunk)
    else:
        raise ValueError(f"fold_mode={args.fold_mode!r} is not ported")
    if instr:
        ctr["wire_fold"] = _F32((pc - 1) * chunk) * p
        n_cand = collectives.psum(cand != INT_INF).to(torch.float32)
        ctr["use_fold"] = 2.0 * n_cand               # (child, parent) pairs

    # --- Local update -----------------------------------------------------
    newly = (pi == -1) & (t != INT_INF)
    pi = torch.where(newly, t, pi)
    return pi, newly, ctr


# ---------------------------------------------------------------------------
# Bottom-up (Algorithm 4)
# ---------------------------------------------------------------------------


def bottomup_level(g: Dict[str, torch.Tensor], pi: torch.Tensor,
                   front: torch.Tensor, args: LevelArgs, lv: Dict
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One bottom-up level: pc sub-steps with the completed bitmap rotating
    along the processor row (Fig. 1).

    Sub-step s of processor (i, j) scans the segment owned by (i, j-s mod
    pc), so the segments are destination-disjoint: they collect in a
    per-destination buffer and one all_to_all delivers them at level end.
    Updates are applied in sub-step order, and the rotating bitmap marks
    each vertex at its first discovery, so parents are those of a
    per-sub-step exchange."""
    part = args.part
    pr, pc, chunk, nc = part.pr, part.pc, part.chunk, part.nc
    p = _F32(part.p)
    instr = args.instrument
    ctr = zero_counters() if instr else {}
    dev = pi.device

    # --- Gather the frontier (dense bitmap) -------------------------------
    f_words, wire = expand_bitmap(front, args.perm)
    if instr:
        ctr["wire_transpose"] = _F32(chunk / 64.0) * p
        ctr["wire_expand"] = wire * p - ctr["wire_transpose"]
        ctr["use_expand"] = _F32(chunk / 64.0 * (1 + (pr - 1))) * p

    cseg = pi != -1                       # completed = has parent (own chunk)
    edges_use = _F32(0)
    send_d = torch.full((pr, pc, pc, chunk), INT_INF, dtype=torch.int32,
                        device=dev)
    self_par = torch.empty((pr, pc, chunk), dtype=torch.int32, device=dev)
    carry = None

    for s in range(pc):
        if s > 0:
            cseg = unpack_bits(collectives.ppermute_col_ring(carry))
            if instr:
                ctr["wire_rotate"] += _F32(chunk / 64.0) * p
                ctr["use_rotate"] += _F32(chunk / 64.0) * p
        use_loc, n_upd = [], []
        for i, j in _blocks(pr, pc):
            seg_id = (j - s) % pc
            e0 = int(args.seg_ptr[i, j, seg_id])
            e1 = int(args.seg_ptr[i, j, seg_id + 1])
            rp_seg = g["row_ptr"][i, j, seg_id * chunk:
                                  (seg_id + 1) * chunk + 1] - e0
            ue = g["col_idx"][i, j, e0:e0 + args.cap_seg]
            cvec = cseg[i, j].to(torch.int32)
            seg_par = args.ops.bottomup(rp_seg, ue, f_words[i, j], cvec,
                                        j * nc, e1 - e0, None)
            found = seg_par != INT_INF
            if instr:
                row_lens = rp_seg[1:] - rp_seg[:-1]
                use_loc.append(torch.where(cvec == 0, row_lens, 0)
                               .sum(dtype=torch.int64))
                n_upd.append(found.sum())
            # the s = 0 self segment pays no wire and lands in the self
            # slot after the exchange
            if s == 0:
                self_par[i, j] = seg_par
            else:
                send_d[i, j, seg_id] = seg_par
            cseg[i, j] |= found
        if instr:
            edges_use = edges_use + collectives.psum(
                torch.stack(use_loc)).to(torch.float32)
            if s > 0:
                ctr["wire_updates"] += _F32(chunk) * p
            ctr["use_updates"] = ctr["use_updates"] + 2.0 * (
                collectives.psum(torch.stack(n_upd)).to(torch.float32))
        if s != pc - 1:
            carry = pack_bits(cseg)

    # --- Batched update exchange (one all_to_all) -------------------------
    recv = collectives.all_to_all_cols(send_d)
    jj = torch.arange(pc, device=dev)
    recv[:, jj, jj] = self_par            # the self slot: sub-step 0

    # --- Apply updates in sub-step order ---------------------------------
    new_front = torch.zeros_like(front)
    new_pi = pi
    for s in range(pc):
        upd = recv[:, jj, (jj + s) % pc]
        newly = (upd != INT_INF) & (new_pi == -1)
        new_pi = torch.where(newly, upd, new_pi)
        new_front |= newly

    if instr:
        ctr["edges_useful"] = edges_use
        ctr["edges_examined"] = edges_use
    return new_pi, new_front, ctr
