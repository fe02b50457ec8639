"""Blocked graph storage, built on the device of the edge list: the 2D
checkerboard (CSR/CSC per block + DCSC/DCSR compressions) and the 1D
row strips (``Blocked1DGraph``, below ``build_blocked``).

The adjacency block of processor (i,j) is T[R_i, C_j], T[v,u]=1 iff edge
u->v.  Two orientations are stored, as the paper stores each undirected
adjacency twice (§5.1):

  * CSC by source column -> top-down SpMSV  (frontier u -> children v)
  * CSR by dest row      -> bottom-up scan  (unvisited v -> parents u)

Every array is padded to the per-block capacity ``cap`` and carries the
grid as its two leading dims ``(pr, pc, ...)``; ``nnz`` masks the tail.
The arrays are those of the JAX package's ``build_blocked``, element for
element; the edges of a block are sorted by (block, primary, secondary),
so CSR rows list their sources in ascending order -- the bottom-up
kernel's first hit is the row's minimum because of it.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict

import torch

from repro_torch.core.partition import (Partition1D, Partition2D,
                                        make_partition, make_partition_1d)
from repro_torch.graph.rmat import EdgeList


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


@dataclass
class BlockedGraph:
    part: Partition2D
    m_input: int
    m: int
    # --- top-down orientation (CSC by source column u) ---
    col_ptr: torch.Tensor   # (pr, pc, nc+1) i32
    row_idx: torch.Tensor   # (pr, pc, cap)  i32  local dest v, CSC order
    edge_src: torch.Tensor  # (pr, pc, cap)  i32  local src u, CSC order
    # --- bottom-up orientation (CSR by dest row v) ---
    row_ptr: torch.Tensor   # (pr, pc, nr+1) i32
    col_idx: torch.Tensor   # (pr, pc, cap+cap_seg) i32 local src u, CSR order
    edge_dst: torch.Tensor  # (pr, pc, cap+cap_seg) i32 local dest v, CSR order
    seg_ptr: torch.Tensor   # (pr, pc, pc+1) i32 CSR ptr at chunk-segment bounds
    # --- hypersparse pointer compressions ---
    jc: torch.Tensor        # (pr, pc, cap_nzc)   i32 non-empty source cols
    cp: torch.Tensor        # (pr, pc, cap_nzc+1) i32 ptrs into row_idx
    jr: torch.Tensor        # (pr, pc, cap_nzr)   i32 non-empty dest rows
    rp: torch.Tensor        # (pr, pc, cap_nzr+1) i32 ptrs into col_idx
    # --- per-block / per-vertex metadata ---
    nnz: torch.Tensor       # (pr, pc) i32
    nzc: torch.Tensor       # (pr, pc) i32
    nzr: torch.Tensor       # (pr, pc) i32
    deg_A: torch.Tensor     # (pr, pc, chunk) i32 out-degree, layout-A chunks
    cap: int
    cap_seg: int
    maxdeg_col: int         # max CSC column-segment length over all blocks

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """Every tensor field by name."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def storage_words(self, mode: str) -> Dict[str, int]:
        """The §5.1 storage accounting in int32 words, the JAX package's:
        the index arrays (``row_idx`` and ``col_idx``, ``cap`` a block)
        whatever the mode, and the pointers: ``nc+1`` and ``nr+1`` a
        block for "csr", ``2 (nzc + nzr) + 2`` for "dcsc"."""
        p = self.part.p
        idx = 2 * self.cap * p
        if mode == "csr":
            ptr = (self.part.nc + 1 + self.part.nr + 1) * p
        elif mode == "dcsc":
            ptr = 2 * (int(self.nzc.sum()) + int(self.nzr.sum())) + 2 * p
        else:
            raise ValueError(mode)
        return {"index_i32": idx, "pointer_i32": ptr, "total_i32": idx + ptr}


def _sort_key(src, dst, pc: int, nr: int, nc: int, by_row: bool):
    """The int64 key ordering edges by (block, primary, secondary): CSC
    (primary = local source col) or, with ``by_row``, CSR (primary = local
    dest row).  Built in place from the int32 ids, so only the key and
    one int32 temporary exist at a time (scale 24 has 0.5G edges)."""
    key = dst.to(torch.int64).div_(nr, rounding_mode="floor")      # bi
    key.mul_(pc).add_(torch.div(src, nc, rounding_mode="floor"))   # blk
    if by_row:
        key.mul_(nr).add_(dst.remainder(nr)).mul_(nc).add_(src.remainder(nc))
    else:
        key.mul_(nc).add_(src.remainder(nc)).mul_(nr).add_(dst.remainder(nr))
    return key


def _orient(key, n_primary: int, n_secondary: int, p: int, cap: int, nnz):
    """Sort the keys and lay the edges out per block: (ptr (p,
    n_primary+1), secondary (p, cap), primary (p, cap), counts (p,
    n_primary)).  The keys are unique because the edges are."""
    dev = key.device
    key = torch.sort(key).values
    flat = torch.div(key, n_secondary, rounding_mode="floor")   # blk*np+pri
    key.sub_(flat * n_secondary)
    sec_sorted = key.to(torch.int32)
    del key
    cnt = torch.bincount(flat, minlength=p * n_primary).reshape(p, n_primary)
    pri_sorted = flat.remainder_(n_primary).to(torch.int32)
    del flat
    ptr = torch.zeros((p, n_primary + 1), dtype=torch.int64, device=dev)
    ptr[:, 1:] = torch.cumsum(cnt, dim=1)
    sec = torch.zeros((p, cap), dtype=torch.int32, device=dev)
    pri = torch.zeros((p, cap), dtype=torch.int32, device=dev)
    start = 0
    for b, k in enumerate(nnz):      # blocks are contiguous in key order
        sec[b, :k] = sec_sorted[start:start + k]
        pri[b, :k] = pri_sorted[start:start + k]
        start += k
    return ptr, sec, pri, cnt


def _compress(ptr, cnt, n_primary: int, p: int):
    """DCSC/DCSR: the pointer array restricted to non-empty primaries."""
    dev = ptr.device
    nz_counts = (cnt > 0).sum(dim=1)
    cap_nz = _round_up(max(int(nz_counts.max()), 1), 8)
    jx = torch.full((p, cap_nz), n_primary, dtype=torch.int64, device=dev)
    px = torch.zeros((p, cap_nz + 1), dtype=torch.int64, device=dev)
    for b in range(p):
        nz = torch.nonzero(cnt[b]).reshape(-1)
        k = nz.shape[0]
        jx[b, :k] = nz
        px[b, :k] = ptr[b, nz]
        px[b, k:] = ptr[b, n_primary]
    return jx, px, nz_counts


def build_blocked(edges: EdgeList, pr: int, pc: int, align: int = 128,
                  cap_pad: int = 128) -> BlockedGraph:
    """The 2D blocked graph of ``edges`` on the edges' device."""
    part = make_partition(edges.n, pr, pc, align)
    nr, nc, chunk, p = part.nr, part.nc, part.chunk, part.p
    dev = edges.src.device
    src, dst = edges.src, edges.dst                    # int32
    blk = torch.div(dst, nr, rounding_mode="floor") * pc \
        + torch.div(src, nc, rounding_mode="floor")
    nnz_t = torch.bincount(blk, minlength=p)
    del blk
    deg = torch.bincount(src, minlength=part.n)
    nnz = [int(x) for x in nnz_t.tolist()]
    cap = _round_up(max(max(nnz), 1), cap_pad)

    # CSC: primary = source col u, secondary = dest row v
    col_ptr, row_idx, edge_src, col_cnt = _orient(
        _sort_key(src, dst, pc, nr, nc, by_row=False), nc, nr, p, cap,
        nnz)
    # CSR: primary = dest row v, secondary = source col u
    row_ptr, col_idx, edge_dst, row_cnt = _orient(
        _sort_key(src, dst, pc, nr, nc, by_row=True), nr, nc, p, cap, nnz)

    jc, cp, nzc = _compress(col_ptr, col_cnt, nc, p)
    jr, rp, nzr = _compress(row_ptr, row_cnt, nr, p)
    maxdeg_col = int(col_cnt.max())
    del col_cnt, row_cnt

    # CSR ptr at chunk-segment boundaries (bottom-up sub-step windows)
    seg_bounds = torch.arange(pc + 1, device=dev) * chunk
    seg_ptr = row_ptr[:, seg_bounds]
    cap_seg = _round_up(max(int((seg_ptr[:, 1:] - seg_ptr[:, :-1]).max()), 1),
                        cap_pad)
    # pad the CSR-orientation index arrays so a cap_seg-wide window
    # starting at any segment boundary stays in bounds
    tail = torch.zeros((p, cap_seg), dtype=torch.int32, device=dev)
    col_idx = torch.cat([col_idx, tail], dim=1)
    edge_dst = torch.cat([edge_dst, tail], dim=1)
    del tail

    def _blk(x):  # (p, ...) -> (pr, pc, ...) int32
        return x.reshape(pr, pc, *x.shape[1:]).to(torch.int32).contiguous()

    return BlockedGraph(
        part=part, m_input=edges.m_input, m=edges.m,
        col_ptr=_blk(col_ptr), row_idx=_blk(row_idx), edge_src=_blk(edge_src),
        row_ptr=_blk(row_ptr), col_idx=_blk(col_idx), edge_dst=_blk(edge_dst),
        seg_ptr=_blk(seg_ptr),
        jc=_blk(jc), cp=_blk(cp), jr=_blk(jr), rp=_blk(rp),
        nnz=_blk(nnz_t), nzc=_blk(nzc), nzr=_blk(nzr),
        deg_A=_blk(deg.reshape(p, chunk)),
        cap=cap, cap_seg=cap_seg, maxdeg_col=maxdeg_col,
    )


# ---------------------------------------------------------------------------
# 1D row strips
# ---------------------------------------------------------------------------


@dataclass
class Blocked1DGraph:
    """1D row-strip storage: strip i holds T[V_i, :] (every edge into its
    owned vertices) in both orientations, each array padded to the
    common capacity ``cap`` (strip 0's nnz on R-MAT, where the low ids
    are the heavy ones) with the strips stacked on the leading dim.

    Source ids are GLOBAL (a strip spans every column), so top-down and
    bottom-up run with ``col_offset = 0`` against the whole allgathered
    frontier.  The top-down pointers are the strip DCSC ``(jc, cp)``
    over the strip's non-empty global source columns and, on request,
    the uncompressed ``(p, n+1)`` strip ``col_ptr`` (the §5.1 blow-up
    the paper charges against 1D, which the ("1d", "kernel", "csr")
    entry reads); ``edge_src`` and ``edge_dst`` (what the dense oracle
    path reads) are built only on request.  The arrays are those of the
    JAX package's ``build_blocked_1d`` element for element."""
    part: Partition1D
    m_input: int
    m: int
    # --- top-down orientation (by strip, global source u, local dest) ---
    row_idx: torch.Tensor   # (p, cap) i32 local dest v
    # --- bottom-up orientation (CSR by local dest row v) ---
    row_ptr: torch.Tensor   # (p, chunk+1) i32
    col_idx: torch.Tensor   # (p, cap) i32 GLOBAL source u, CSR order
    # --- strip DCSC ---
    jc: torch.Tensor        # (p, cap_nzc)   i32 non-empty GLOBAL source cols
    cp: torch.Tensor        # (p, cap_nzc+1) i32 ptrs into row_idx
    # --- per-strip / per-vertex metadata ---
    nnz: torch.Tensor       # (p,) i32
    nzc: torch.Tensor       # (p,) i32
    deg_A: torch.Tensor     # (p, chunk) i32 out-degree of owned vertices
    cap: int
    cap_nzc: int
    maxdeg_col: int         # max column-segment length over all strips
    edge_src: "torch.Tensor | None" = None  # (p, cap) i32 GLOBAL source u
    edge_dst: "torch.Tensor | None" = None  # (p, cap) i32 local dest v, CSR
    col_ptr: "torch.Tensor | None" = None   # (p, n+1) i32 strip CSC ptr

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """Every tensor field by name (the optional ones only when
        built)."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def storage_words(self, mode: str) -> Dict[str, int]:
        """The JAX package's int32 accounting for the strips: the index
        arrays whatever the mode; "csr" charges the ``n+1`` strip
        ``col_ptr`` a strip, "dcsc" ``2 nzc + 2``; both the ``chunk+1``
        bottom-up ``row_ptr`` a strip.  Counted from the shapes, so
        whether ``col_ptr`` was built does not change it."""
        p = self.part.p
        idx = 2 * self.cap * p
        bu_ptr = (self.part.chunk + 1) * p
        if mode == "csr":
            ptr = (self.part.n + 1) * p + bu_ptr
        elif mode == "dcsc":
            ptr = 2 * int(self.nzc.sum()) + 2 * p + bu_ptr
        else:
            raise ValueError(mode)
        return {"index_i32": idx, "pointer_i32": ptr, "total_i32": idx + ptr}


def _strips(flat: torch.Tensor, nnz, cap: int) -> torch.Tensor:
    """Edges in strip order, flat -> (p, cap) int32, zero padded."""
    out = torch.zeros((len(nnz), cap), dtype=torch.int32, device=flat.device)
    start = 0
    for b, k in enumerate(nnz):
        out[b, :k] = flat[start:start + k]
        start += k
    return out


def build_blocked_1d(edges: EdgeList, p: int, align: int = 128,
                     cap_pad: int = 128, with_edge_lists: bool = True,
                     with_col_ptr: bool = False) -> Blocked1DGraph:
    """Partition the edges u->v by the owner of the destination v into p
    row strips, on the edges' device.  ``with_edge_lists=False`` skips
    ``edge_src``/``edge_dst`` (two more capacity-wide arrays that only
    the dense oracle path reads), which a kernel session at scale 24
    leaves out to fit the card.  ``with_col_ptr=True`` adds the ``(p,
    n+1)`` int32 strip CSC pointer (``col_ptr[i, u]`` = strip i's edges
    with a source below u), which only the ("1d"|"1ds", "kernel", "csr")
    entry reads: 1.07 GB at scale 24 on 16 strips."""
    part = make_partition_1d(edges.n, p, align)
    n, chunk = part.n, part.chunk
    dev = edges.src.device
    src, dst = edges.src, edges.dst                    # int32
    nnz_t = torch.bincount(torch.div(dst, chunk, rounding_mode="floor"),
                           minlength=p)
    nnz = [int(x) for x in nnz_t.tolist()]
    cap = _round_up(max(max(nnz), 1), cap_pad)
    deg = torch.bincount(src, minlength=n)

    # top-down orientation: sorted by (strip, u, v_loc).  The key is
    # (strip*n + u)*chunk + v_loc; built in place, so one int64 key and
    # one int32 temporary exist at a time
    key = torch.div(dst, chunk, rounding_mode="floor").to(torch.int64)
    key.mul_(n).add_(src).mul_(chunk).add_(dst.remainder(chunk))
    key = torch.sort(key).values
    row_idx = _strips(key.remainder(chunk).to(torch.int32), nnz, cap)
    su = key.div_(chunk, rounding_mode="floor")        # strip*n + u
    del key
    # strip DCSC: the (strip, u) runs of the sorted edges are the
    # non-empty columns; edges of one strip are contiguous, so a run's
    # start minus its strip's start is its pointer into row_idx
    cols, counts = torch.unique_consecutive(su, return_counts=True)
    if with_edge_lists:
        edge_src = _strips(su.remainder_(n).to(torch.int32), nnz, cap)
    del su
    col_strip = torch.div(cols, n, rounding_mode="floor")
    nzc_t = torch.bincount(col_strip, minlength=p)
    nzc = [int(x) for x in nzc_t.tolist()]
    cap_nzc = _round_up(max(max(nzc), 1), 8)
    maxdeg_col = int(counts.max()) if counts.numel() else 0
    starts = torch.cumsum(counts, 0) - counts          # global run starts
    strip_base = torch.cumsum(nnz_t, 0) - nnz_t
    starts -= strip_base[col_strip]
    jc = torch.full((p, cap_nzc), n, dtype=torch.int32, device=dev)
    cp = torch.zeros((p, cap_nzc + 1), dtype=torch.int32, device=dev)
    start = 0
    for b, k in enumerate(nzc):
        jc[b, :k] = cols[start:start + k] - b * n
        cp[b, :k] = starts[start:start + k]
        cp[b, k:] = nnz[b]
        start += k
    col_ptr = None
    if with_col_ptr:
        # the run lengths land at (strip, u + 1); a running sum a strip
        # (in int32: a strip holds under 2^31 edges) gives the pointer
        col_ptr = torch.zeros((p, n + 1), dtype=torch.int32, device=dev)
        col_ptr.view(-1)[cols + col_strip + 1] = counts.to(torch.int32)
        for b in range(p):
            col_ptr[b] = torch.cumsum(col_ptr[b], 0, dtype=torch.int32)
    del cols, counts, col_strip, starts

    # bottom-up orientation: CSR by (strip, v_loc, u), i.e. sorted by
    # the key dst*n + u, so every row lists its sources ascending (the
    # bottom-up first hit is the row's minimum because of it)
    key = dst.to(torch.int64).mul_(n).add_(src)
    key = torch.sort(key).values
    col_idx = _strips(key.remainder(n).to(torch.int32), nnz, cap)
    dsts = key.div_(n, rounding_mode="floor")
    del key
    if with_edge_lists:
        edge_dst = _strips(dsts.remainder_(chunk).to(torch.int32), nnz, cap)
    del dsts
    row_ptr = torch.zeros((p, chunk + 1), dtype=torch.int32, device=dev)
    row_ptr[:, 1:] = torch.cumsum(
        torch.bincount(dst, minlength=n).reshape(p, chunk), dim=1)

    return Blocked1DGraph(
        part=part, m_input=edges.m_input, m=edges.m,
        row_idx=row_idx, row_ptr=row_ptr, col_idx=col_idx, jc=jc, cp=cp,
        nnz=nnz_t.to(torch.int32), nzc=nzc_t.to(torch.int32),
        deg_A=deg.reshape(p, chunk).to(torch.int32).contiguous(),
        cap=cap, cap_nzc=cap_nzc, maxdeg_col=maxdeg_col,
        edge_src=edge_src if with_edge_lists else None,
        edge_dst=edge_dst if with_edge_lists else None, col_ptr=col_ptr)
