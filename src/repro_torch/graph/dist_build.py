"""Born-sharded graphs: the distributed build of the JAX package's
``graph/dist_build.py`` on the simulated mesh (``launch/mesh.py``).

The Graph500 discipline is that generation and CSR/DCSC construction are
themselves distributed: the host never holds the edge list.  The build
makes ``Blocked1DGraph`` / ``BlockedGraph`` shards on the mesh's device:

  1. **generate**: shard k draws its slice [k*m_per, (k+1)*m_per) of the
     counter R-MAT stream (``graph/rmat.py::rmat_edges_counter``, the
     kernel ``csrc/rmat_counter.cu`` on a card, one launch a slice).
     The stream is a pure function of (seed, edge index), so the union
     of the slices is the same stream for every shard count.  The last
     slices stop at m_input (the JAX package draws m_per edges on every
     shard and masks the ones past it; the records that survive are
     the same).
  2. **owner-route**: every edge is emitted in both directions and sent
     to the owner of its destination, in one round for the strips and
     in two for the checkerboard (to the block column owner along
     "model", then to the block row owner along "data").  The JAX
     package ships padded (p_dest, cap_route) buckets through one
     all_to_all; on one card all senders' buckets would be resident at
     once (34 GB sent at scale 24 on 16 strips), so the port ships the
     records unpadded: each sender groups its records by destination,
     in its own order, and a receiver concatenates its groups in sender
     order.  Each (sender, destination) count, the records past
     ``cap_route`` in a bucket (which the padded exchange drops), the
     overflow and the wire count are the JAX package's, from the same
     counts; an overflow raises ``CapacityOverflow``.
  3. **dedup shard-locally**: a shard's received records are sorted by
     (source, local dest) through one int64 key and deduplicated.
     Dedup commutes with owner routing, so the shards' edge sets are
     those of ``preprocess`` + ``build_blocked*``.
  4. **build formats in place**: CSR/CSC/DCSC/strip-DCSC arrays a shard,
     padded to the global capacities, which take the host builders'
     rounding rules.

Only per-shard scalars cross to the host between the phases, and an
overflow raises as soon as the routing counts show it, before the dedup.  The
arrays are the JAX package's element for element.  A corrupted store
shard is rebuilt from the same stream by ``regen_shard`` (below).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import comm_model
from repro_torch.core.engine import sync_device
from repro_torch.core.partition import make_partition, make_partition_1d
from repro_torch.graph.formats import Blocked1DGraph, BlockedGraph, _round_up
from repro_torch.graph.rmat import rmat_edges_counter
from repro_torch.launch.mesh import resolve_device
from repro_torch.runtime.retry import CapacityOverflow, RetryAttempt

ROW_AXIS, COL_AXIS = "data", "model"
_I32 = torch.int32


@dataclass(frozen=True)
class BuildSpec:
    """Everything that determines the generated graph, hashable into the
    store's config hash (``ckpt/checkpoint.py::config_hash`` tags it
    with the class name, so the name, field order and defaults are the
    JAX package's and a store written by either package loads in the
    other).  The edge stream is ``rmat_edges_counter``'s; graphs are
    always symmetrized (Graph500's undirected discipline)."""
    scale: int
    edge_factor: int = 16
    seed: int = 1
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19

    @property
    def n(self) -> int:
        return 1 << self.scale

    @property
    def m_input(self) -> int:
        return self.edge_factor << self.scale

    def validate(self):
        if self.scale > 30:
            raise ValueError(f"scale={self.scale} > 30 overflows int32 "
                             f"vertex ids on x64-disabled devices")
        if self.m_input >= 1 << 32:
            raise ValueError(f"m_input={self.m_input} exhausts the uint32 "
                             f"counter space")


def _check_mesh(mesh, sizes: Dict[str, int]) -> torch.device:
    """The mesh's axis sizes against the grid the build shards over;
    returns the mesh's device."""
    for ax, want in sizes.items():
        have = mesh.shape.get(ax)
        if have != want:
            raise ValueError(f"the build shards over {ax}={want} but the "
                             f"mesh has {ax}={have} (mesh axes "
                             f"{mesh.shape})")
    return resolve_device(mesh.device)


def _slice(spec: BuildSpec, k: int, m_per: int, dev):
    """Shard k's slice of the stream, cut at m_input: the records the
    JAX package's ``in_stream`` mask keeps."""
    start = min(k * m_per, spec.m_input)
    return rmat_edges_counter(spec.scale, spec.edge_factor, spec.a, spec.b,
                              spec.c, spec.seed, start=start,
                              count=min(m_per, spec.m_input - start),
                              device=dev)


def _route(ru, rv, ok, dest, p_dest: int, cap_route: int, k: int):
    """One capped routing round from one sender, without the padded
    buckets: the sender's records grouped by destination (each group in
    the sender's order and cut at ``cap_route``, as the padded
    all_to_all drops a full bucket's tail), its wire count (the records
    destined off-device, ``k`` being its own index on the round's axis)
    and its overflow (its fullest bucket past ``cap_route``).  Records
    with ok=False are dropped.  The receiver of destination d
    concatenates the senders' groups d in sender order: the JAX
    package's received records, sentinels aside."""
    dest = torch.where(ok, dest, p_dest)
    counts = torch.bincount(dest, minlength=p_dest + 1)[:p_dest].tolist()
    groups = []
    for d in range(p_dest):
        sel = dest == d
        groups.append((ru[sel][:cap_route], rv[sel][:cap_route]))
    sent = sum(counts) - counts[k]
    over = max(max(counts) - cap_route, 0)
    return groups, sent, over


def _receive(groups: List[Tuple[torch.Tensor, torch.Tensor]]):
    """The concatenation of a receiver's groups, in sender order."""
    if len(groups) == 1:
        return groups[0]
    return (torch.cat([g[0] for g in groups]),
            torch.cat([g[1] for g in groups]))


def _dedup_sorted(groups, du: int, dv: int, n_secondary: int):
    """A receiver's records, shifted to local ids (u - du, v - dv), sorted
    by (u, v) with duplicates dropped, as int32 (u, v): the JAX package's
    lexsort and front compaction, whose sentinel tail the unpadded
    records do not need.  ``groups`` is the receiver's list of (u, v)
    groups in sender order; it is emptied as the key is built, so a
    group's records are freed once keyed.  Local v < ``n_secondary``."""
    keys = []
    while groups:
        u, v = groups.pop(0)
        keys.append(u.to(torch.int64).sub_(du).mul_(n_secondary).add_(v)
                    .sub_(dv))
        del u, v
    key = keys[0] if len(keys) == 1 else torch.cat(keys)
    del keys
    key = torch.unique(key, sorted=True)
    cu = torch.div(key, n_secondary, rounding_mode="floor")
    cv = key.sub_(cu * n_secondary)
    return cu.to(_I32), cv.to(_I32)


def _runs(cu):
    """The runs of a sorted primary array: (primaries, first indices,
    lengths)."""
    vals, counts = torch.unique_consecutive(cu, return_counts=True)
    return vals, torch.cumsum(counts, 0) - counts, counts


def _first_occurrence(cu, n_sentinel: int, cap_nz: int):
    """(jc, cp)-style doubly-compressed pointers over a primary-sorted
    array: its unique primaries padded with ``n_sentinel`` to ``cap_nz``
    and their first indices padded with nnz to ``cap_nz + 1`` (the host
    builders' ``np.unique(..., return_index=True)`` layout), with the
    JAX package's mode="drop" scatter: past the capacity, jc keeps
    ``cap_nz`` primaries and cp one more first index."""
    vals, starts, _ = _runs(cu)
    jc = torch.full((cap_nz,), n_sentinel, dtype=_I32, device=cu.device)
    cp = torch.full((cap_nz + 1,), cu.numel(), dtype=_I32, device=cu.device)
    jc[: min(vals.numel(), cap_nz)] = vals[:cap_nz]
    cp[: min(vals.numel(), cap_nz + 1)] = starts[: cap_nz + 1].to(_I32)
    return jc, cp


def _scatter_front(row, vals):
    """The first entries of a shard's row (a view into the stacked,
    fill-padded field) take ``vals``; entries past the row drop, as the
    JAX package's mode="drop" scatter drops them."""
    k = min(vals.numel(), row.numel())
    row[:k] = vals[:k]


def _ptr(cnt):
    """[0, cumsum(cnt)] as int32: a CSR/CSC pointer from counts."""
    return torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).to(_I32)


def _by_row(cu, cv, n_primary: int):
    """The CSR orientation of the unique pairs (cu, cv): sorted by (cv,
    cu).  The keys are unique, so ``unique`` sorts them, without the index
    array a ``sort`` would also allocate."""
    key = torch.unique(cv.to(torch.int64).mul_(n_primary).add_(cu),
                       sorted=True)
    bv = torch.div(key, n_primary, rounding_mode="floor")
    return key.sub_(bv * n_primary).to(_I32), bv.to(_I32)


def _stack(p_shape: Tuple[int, ...], n: int, dev, fill: int = 0):
    return torch.full((*p_shape, n), fill, dtype=_I32, device=dev)


# ---------------------------------------------------------------------------
# 1D strip build
# ---------------------------------------------------------------------------


def dist_build_1d(spec: BuildSpec, p: int, mesh, *, align: int = 128,
                  cap_pad: int = 128, route_slack: float = 1.5,
                  row_axis: str = ROW_AXIS,
                  ) -> Tuple[Blocked1DGraph, Dict[str, Any]]:
    """The distributed build of the 1D row-strip format on ``mesh``'s p
    strips.  The arrays are ``build_blocked_1d(rmat_graph(...,
    generator="counter"), p, align, cap_pad)``'s, edge lists included
    and no ``col_ptr``, and the JAX package's ``dist_build_1d``'s; no
    edge list exists on the host, only per-shard scalars cross to it."""
    spec.validate()
    dev = _check_mesh(mesh, {row_axis: p})
    part = make_partition_1d(spec.n, p, align)
    chunk, n_pad = part.chunk, part.n
    m_input = spec.m_input
    m_per = -(-m_input // p)                     # the per-shard slice
    cap_route = comm_model.plan_cap_route(2 * m_per, p, spec.a, spec.b,
                                          slack=route_slack)

    t0 = time.perf_counter()
    inbox = [[] for _ in range(p)]
    stats = np.zeros((p, 5), np.int64)          # nnz nzc maxdeg over sent
    for k in range(p):
        u, v = _slice(spec, k, m_per, dev)
        # symmetrize before routing: both directions of every edge
        ru, rv = torch.cat([u, v]), torch.cat([v, u])
        del u, v
        groups, stats[k, 4], stats[k, 3] = _route(
            ru, rv, ru != rv, torch.div(rv, chunk, rounding_mode="floor"),
            p, cap_route, k)
        del ru, rv
        for d in range(p):
            inbox[d].append(groups[d])
        del groups           # the inbox holds the only reference
    if stats[:, 3].max() > 0:
        raise CapacityOverflow(
            f"1D routing bucket overflow by {int(stats[:, 3].max())} "
            f"records (cap_route={cap_route}); rebuild with a larger "
            f"route_slack (> {route_slack})",
            cap_name="route_slack", cap_value=route_slack)
    shards, deg = [], _stack((p,), chunk, dev)
    for k in range(p):
        cu, cv = _dedup_sorted(inbox[k], 0, k * chunk, chunk)
        _, _, runs = _runs(cu)
        deg[k] = torch.bincount(cv, minlength=chunk).to(_I32)
        stats[k, :3] = (cu.numel(), runs.numel(),
                        int(runs.max()) if runs.numel() else 0)
        shards.append((cu, cv))
    t1 = time.perf_counter()
    nnz = stats[:, 0]
    cap = _round_up(max(int(nnz.max()), 1), cap_pad)
    cap_nzc = _round_up(max(int(stats[:, 1].max()), 1), 8)
    maxdeg_col = int(stats[:, 2].max())
    m = int(nnz.sum())

    edge_src, row_idx, col_idx, edge_dst = (_stack((p,), cap, dev)
                                            for _ in range(4))
    row_ptr = _stack((p,), chunk + 1, dev)
    jc = _stack((p,), cap_nzc, dev)
    cp = _stack((p,), cap_nzc + 1, dev)
    for k, (cu, cv) in enumerate(shards):
        shards[k] = None
        _scatter_front(edge_src[k], cu)
        _scatter_front(row_idx[k], cv)
        jc[k], cp[k] = _first_occurrence(cu, n_pad, cap_nzc)
        row_ptr[k] = _ptr(torch.bincount(cv, minlength=chunk))
        # bottom-up orientation: CSR by local dest row
        bu, bv = _by_row(cu, cv, n_pad)
        del cu, cv
        _scatter_front(col_idx[k], bu)
        _scatter_front(edge_dst[k], bv)
        del bu, bv
    sync_device(dev)
    t2 = time.perf_counter()

    as_t = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)
    graph = Blocked1DGraph(
        part=part, m_input=m_input, m=m,
        row_idx=row_idx, row_ptr=row_ptr, col_idx=col_idx, jc=jc, cp=cp,
        nnz=as_t(nnz), nzc=as_t(stats[:, 1]), deg_A=deg,
        cap=cap, cap_nzc=cap_nzc, maxdeg_col=maxdeg_col,
        edge_src=edge_src, edge_dst=edge_dst, col_ptr=None)
    info = {
        "build_s": t2 - t0, "gen_route_s": t1 - t0, "format_s": t2 - t1,
        "cap_route": cap_route, "m": m, "m_input": m_input,
        "build_teps": m_input / max(t2 - t0, 1e-12),
        "route_words_measured": float(stats[:, 4].sum()),
        "route_words_expected": comm_model.build_route_1d_words(m_input, p),
        "route_words_padded": comm_model.build_route_padded_words(
            p, cap_route),
    }
    return graph, info


# ---------------------------------------------------------------------------
# 2D checkerboard build
# ---------------------------------------------------------------------------


def dist_build_2d(spec: BuildSpec, pr: int, pc: int, mesh, *,
                  align: int = 128, cap_pad: int = 128,
                  route_slack: float = 1.5, row_axis: str = ROW_AXIS,
                  col_axis: str = COL_AXIS,
                  ) -> Tuple[BlockedGraph, Dict[str, Any]]:
    """The distributed build of the 2D (pr x pc) checkerboard, the arrays
    ``build_blocked``'s on the counter stream and the JAX package's
    ``dist_build_2d``'s.

    Owner routing takes two single-axis hops (the block column owner
    along "model", then the block row owner along "data"), each the 1D
    build's capped round; the closed form is
    ``comm_model.build_route_2d_words``."""
    spec.validate()
    dev = _check_mesh(mesh, {row_axis: pr, col_axis: pc})
    part = make_partition(spec.n, pr, pc, align)
    nr, nc, chunk, p = part.nr, part.nc, part.chunk, part.p
    m_input = spec.m_input
    m_per = -(-m_input // p)
    nrec = 2 * m_per
    cap_r1 = comm_model.plan_cap_route(nrec, pc, spec.a, spec.b,
                                       slack=route_slack)
    # hop 2 buckets the whole column's records by block row: the worst
    # row bucket of the worst column takes skew(pr)*skew(pc) of the
    # 2*m_input records a processor row generated
    rec1 = pc * cap_r1
    cap_r2 = comm_model.plan_cap_route(
        int(nrec * pc * comm_model.rmat_strip_skew(pc, spec.a, spec.b)),
        pr, spec.a, spec.b, slack=route_slack)
    cap_r2 = min(cap_r2, _round_up(rec1, 32))    # can't exceed hop-1 recv

    t0 = time.perf_counter()
    stats = np.zeros((pr, pc, 7), np.int64)  # nnz nzc nzr maxdeg seg over sent
    # hop 1: each device (i, j) to its block-column owners (i, u // nc)
    inbox1 = [[[] for _ in range(pc)] for _ in range(pr)]
    for i in range(pr):
        for j in range(pc):
            u, v = _slice(spec, i * pc + j, m_per, dev)
            ru, rv = torch.cat([u, v]), torch.cat([v, u])
            del u, v
            groups, sent, over = _route(
                ru, rv, ru != rv, torch.div(ru, nc, rounding_mode="floor"),
                pc, cap_r1, j)
            del ru, rv
            stats[i, j, 5:] += (over, sent)
            for bj in range(pc):
                inbox1[i][bj].append(groups[bj])
            del groups
    # hop 2: each device (i, j) to its block-row owners (v // nr, j)
    inbox2 = [[[] for _ in range(pc)] for _ in range(pr)]
    for i in range(pr):
        for j in range(pc):
            gu, gv = _receive(inbox1[i][j])
            inbox1[i][j] = None
            groups, sent, over = _route(
                gu, gv, torch.ones_like(gu, dtype=torch.bool),
                torch.div(gv, nr, rounding_mode="floor"), pr, cap_r2, i)
            del gu, gv
            stats[i, j, 5:] += (over, sent)
            for bi in range(pr):
                inbox2[bi][j].append(groups[bi])
            del groups
    over = stats[:, :, 5].max()
    if over > 0:
        raise CapacityOverflow(
            f"2D routing bucket overflow by {int(over)} "
            f"records (cap_r1={cap_r1}, cap_r2={cap_r2}); rebuild with "
            f"a larger route_slack (> {route_slack})",
            cap_name="route_slack", cap_value=route_slack)
    shards = [[None] * pc for _ in range(pr)]
    rcnt = torch.zeros((pr, pc, nr), dtype=torch.int64, device=dev)
    for i in range(pr):
        for j in range(pc):
            # dedup in CSC order (primary u_loc, secondary v_loc)
            cu, cv = _dedup_sorted(inbox2[i][j], j * nc, i * nr, nr)
            _, _, runs = _runs(cu)
            rcnt[i, j] = torch.bincount(cv, minlength=nr)
            stats[i, j, :5] = (
                cu.numel(), runs.numel(), int((rcnt[i, j] > 0).sum()),
                int(runs.max()) if runs.numel() else 0,
                int(rcnt[i, j].reshape(pc, chunk).sum(1).max()))
            shards[i][j] = (cu, cv)
    # degree: the strip in-degree (summed over the block row) sliced to
    # each device's layout-A chunk (i*pc+j <-> strip offset j*chunk)
    deg = rcnt.sum(1).reshape(pr, pc, chunk).to(_I32)
    t1 = time.perf_counter()
    stats = stats.reshape(p, -1)
    nnz = stats[:, 0]
    cap = _round_up(max(int(nnz.max()), 1), cap_pad)
    cap_nzc = _round_up(max(int(stats[:, 1].max()), 1), 8)
    cap_nzr = _round_up(max(int(stats[:, 2].max()), 1), 8)
    maxdeg_col = int(stats[:, 3].max())
    cap_seg = _round_up(max(int(stats[:, 4].max()), 1), cap_pad)
    m = int(nnz.sum())

    g2 = (pr, pc)
    edge_src, row_idx = _stack(g2, cap, dev), _stack(g2, cap, dev)
    col_idx = _stack(g2, cap + cap_seg, dev)
    edge_dst = _stack(g2, cap + cap_seg, dev)
    col_ptr, row_ptr = _stack(g2, nc + 1, dev), _stack(g2, nr + 1, dev)
    jc, cp = _stack(g2, cap_nzc, dev), _stack(g2, cap_nzc + 1, dev)
    jr, rp = _stack(g2, cap_nzr, dev), _stack(g2, cap_nzr + 1, dev)
    nzc = torch.zeros(g2, dtype=_I32, device=dev)
    for i in range(pr):
        for j in range(pc):
            cu, cv = shards[i][j]
            shards[i][j] = None
            # CSC orientation (already sorted by u_loc, v_loc)
            _scatter_front(edge_src[i, j], cu)
            _scatter_front(row_idx[i, j], cv)
            ccnt = torch.bincount(cu, minlength=nc)
            col_ptr[i, j] = _ptr(ccnt)
            nzc[i, j] = int((ccnt > 0).sum())
            del ccnt
            jc[i, j], cp[i, j] = _first_occurrence(cu, nc, cap_nzc)
            # CSR orientation
            bu, bv = _by_row(cu, cv, nc)
            del cu, cv
            _scatter_front(col_idx[i, j], bu)
            _scatter_front(edge_dst[i, j], bv)
            row_ptr[i, j] = _ptr(rcnt[i, j])
            jr[i, j], rp[i, j] = _first_occurrence(bv, nr, cap_nzr)
            del bu, bv
    seg_ptr = row_ptr[:, :, torch.arange(pc + 1, device=dev) * chunk]
    nzr = (rcnt > 0).sum(2).to(_I32)
    del rcnt
    sync_device(dev)
    t2 = time.perf_counter()

    graph = BlockedGraph(
        part=part, m_input=m_input, m=m,
        col_ptr=col_ptr, row_idx=row_idx, edge_src=edge_src,
        row_ptr=row_ptr, col_idx=col_idx, edge_dst=edge_dst,
        seg_ptr=seg_ptr.contiguous(), jc=jc, cp=cp, jr=jr, rp=rp,
        nnz=torch.as_tensor(nnz.reshape(g2).astype(np.int32), device=dev),
        nzc=nzc, nzr=nzr, deg_A=deg,
        cap=cap, cap_seg=cap_seg, maxdeg_col=maxdeg_col)
    info = {
        "build_s": t2 - t0, "gen_route_s": t1 - t0, "format_s": t2 - t1,
        "cap_route": (cap_r1, cap_r2), "m": m, "m_input": m_input,
        "build_teps": m_input / max(t2 - t0, 1e-12),
        "route_words_measured": float(stats[:, 6].sum()),
        "route_words_expected": comm_model.build_route_2d_words(
            m_input, pr, pc),
        "route_words_padded": comm_model.build_route_padded_words(
            pc, cap_r1) + comm_model.build_route_padded_words(pr, cap_r2),
    }
    return graph, info


def dist_build(spec: BuildSpec, decomposition: str, mesh, grid,
               max_attempts: int = 3, **kw):
    """Dispatch on decomposition: "1d"/"1ds" build the strip format on
    p = prod(grid) shards, "2d" the checkerboard.  ``grid`` is (pr, pc),
    or an int / 1-tuple p for the 1D formats.

    A routing-bucket overflow heals here: the single-shot builders raise
    ``CapacityOverflow``, and this dispatcher doubles ``route_slack`` and
    builds again, at most ``max_attempts`` attempts in all, each one in
    ``info["retry_log"]`` (empty when the first attempt routes clean).
    The rebuilt graph is the one a first build at the final slack gives:
    the stream is a pure function of (seed, edge index) and the slack
    only sizes the buckets.  Exhaustion raises again with the whole
    escalation history."""
    if isinstance(grid, int):
        grid = (grid, 1)
    elif len(grid) == 1:
        grid = (grid[0], 1)
    pr, pc = grid
    if decomposition in ("1d", "1ds"):
        build = lambda **k: dist_build_1d(spec, pr * pc, mesh, **k)
    elif decomposition == "2d":
        build = lambda **k: dist_build_2d(spec, pr, pc, mesh, **k)
    else:
        raise ValueError(f"unknown decomposition {decomposition!r}")

    slack = float(kw.pop("route_slack", 1.5))
    history = []
    for attempt in range(1, max(1, max_attempts) + 1):
        try:
            graph, info = build(route_slack=slack, **kw)
        except CapacityOverflow as e:
            history.append(RetryAttempt(
                attempt=attempt, cap_name="route_slack", cap_value=slack,
                outcome="overflow", detail={"error": str(e)}))
            if attempt >= max(1, max_attempts):
                raise CapacityOverflow(
                    f"routing overflow persisted through {attempt} build "
                    f"attempts: {e}", cap_name="route_slack",
                    cap_value=slack, history=history) from e
            slack *= 2.0
            continue
        if history:
            history.append(RetryAttempt(
                attempt=attempt, cap_name="route_slack", cap_value=slack,
                outcome="ok", detail={}))
        info["retry_log"] = [a.to_json() for a in history]
        return graph, info


# ---------------------------------------------------------------------------
# Shard regeneration (graph store repair)
# ---------------------------------------------------------------------------
#
# A corrupted or truncated store shard is regenerated from the stream the
# build consumed: shard contents depend only on the edges that shard
# owns, so the stream is drawn in pieces, filtered down to one shard's
# edges and run through phases 1 and 2 again, bit-identical to the build
# (the store checks the stored CRC after regeneration to prove it).
# On a card each piece is one launch of the counter kernel.

_REGEN_STEP = 1 << 22     # the stream's pieces: bounds the peak memory


def _shard_edges(spec: BuildSpec, keep, dev) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Deduplicated (u, v) int64 pairs of the symmetrized, self-loop-free
    stream for which ``keep(u, v)`` holds, sorted by (u, v): the CSC
    dedup order of ``_dedup_sorted``."""
    keys = []
    for s in range(0, spec.m_input, _REGEN_STEP):
        cnt = min(_REGEN_STEP, spec.m_input - s)
        u, v = rmat_edges_counter(spec.scale, spec.edge_factor, spec.a,
                                  spec.b, spec.c, spec.seed, start=s,
                                  count=cnt, device=dev)
        for a, b in ((u, v), (v, u)):
            mask = (a != b) & keep(a, b)
            keys.append(a[mask].to(torch.int64) * spec.n + b[mask])
    key = torch.unique(torch.cat(keys), sorted=True)
    u = torch.div(key, spec.n, rounding_mode="floor")
    return u, key - u * spec.n


def _pad_i32(vals: torch.Tensor, cap: int, fill: int = 0) -> np.ndarray:
    out = np.full(cap, fill, np.int32)
    out[: vals.numel()] = vals.cpu().numpy()
    return out


def regen_shard_1d(spec: BuildSpec, part, k: int, *, cap: int,
                   cap_nzc: int, device="cuda") -> Dict[str, np.ndarray]:
    """Strip ``k``'s Blocked1DGraph arrays (the shard slice, no leading
    block dim) as host arrays, made on ``device``, bit-identical to
    ``dist_build_1d``'s; ``col_ptr`` as host builds with
    ``with_col_ptr=True`` store it (``regen_shard`` keeps the stored
    fields)."""
    dev = resolve_device(device)
    chunk, n_pad = part.chunk, part.n
    lo = k * chunk
    gu, gv = _shard_edges(spec, lambda a, b: (b >= lo) & (b < lo + chunk),
                          dev)
    u, v = gu.to(_I32), (gv - lo).to(_I32)
    nnz = u.numel()
    cnt = torch.bincount(v, minlength=chunk)[:chunk]
    uu, fi, _ = _runs(u)            # np.unique(u, return_index=True)
    cp = np.full(cap_nzc + 1, nnz, np.int32)
    cp[: fi.numel()] = fi.cpu().numpy()
    # a running sum in int64, narrowed once, as the host builders do
    col_ptr = torch.zeros(n_pad + 1, dtype=torch.int64, device=dev)
    col_ptr[1:] = torch.cumsum(torch.bincount(u, minlength=n_pad)[:n_pad], 0)
    bu, bv = _by_row(u, v, n_pad)
    return {
        "col_ptr": col_ptr.to(_I32).cpu().numpy(),
        "edge_src": _pad_i32(u, cap),
        "row_idx": _pad_i32(v, cap),
        "row_ptr": _ptr(cnt).cpu().numpy(),
        "col_idx": _pad_i32(bu, cap),
        "edge_dst": _pad_i32(bv, cap),
        "jc": _pad_i32(uu, cap_nzc, fill=n_pad),
        "cp": cp,
        "nnz": np.int32(nnz),
        "nzc": np.int32(uu.numel()),
        "deg_A": cnt.to(_I32).cpu().numpy(),
    }


def regen_shard_2d(spec: BuildSpec, part, i: int, j: int, *, cap: int,
                   cap_seg: int, cap_nzc: int, cap_nzr: int,
                   device="cuda") -> Dict[str, np.ndarray]:
    """Block ``(i, j)``'s BlockedGraph arrays (the shard slice, no
    leading block dims) as host arrays, made on ``device``,
    bit-identical to ``dist_build_2d``'s."""
    dev = resolve_device(device)
    nr, nc, chunk, pc = part.nr, part.nc, part.chunk, part.pc
    gu, gv = _shard_edges(
        spec, lambda a, b: (torch.div(a, nc, rounding_mode="floor") == j)
        & (torch.div(b, nr, rounding_mode="floor") == i), dev)
    u, v = (gu - j * nc).to(_I32), (gv - i * nr).to(_I32)
    nnz = u.numel()
    ccnt = torch.bincount(u, minlength=nc)[:nc]
    rcnt = torch.bincount(v, minlength=nr)[:nr]
    uu, fiu, _ = _runs(u)
    cp = np.full(cap_nzc + 1, nnz, np.int32)
    cp[: fiu.numel()] = fiu.cpu().numpy()
    bu, bv = _by_row(u, v, nc)           # CSR: primary v, secondary u
    vv, fiv, _ = _runs(bv)
    rp = np.full(cap_nzr + 1, nnz, np.int32)
    rp[: fiv.numel()] = fiv.cpu().numpy()
    row_ptr = _ptr(rcnt).cpu().numpy()
    # deg_A: the whole row's strip in-degree sliced to this block's
    # layout-A chunk, which needs the edges of EVERY column block of row i
    dlo = i * nr + j * chunk
    _, dv = _shard_edges(spec, lambda a, b: (b >= dlo) & (b < dlo + chunk),
                         dev)
    deg = torch.bincount(dv - dlo, minlength=chunk)[:chunk]
    return {
        "col_ptr": _ptr(ccnt).cpu().numpy(),
        "row_idx": _pad_i32(v, cap),
        "edge_src": _pad_i32(u, cap),
        "row_ptr": row_ptr,
        "col_idx": _pad_i32(bu, cap + cap_seg),
        "edge_dst": _pad_i32(bv, cap + cap_seg),
        "seg_ptr": row_ptr[np.arange(pc + 1) * chunk],
        "jc": _pad_i32(uu, cap_nzc, fill=nc),
        "cp": cp,
        "jr": _pad_i32(vv, cap_nzr, fill=nr),
        "rp": rp,
        "nnz": np.int32(nnz),
        "nzc": np.int32(int((ccnt > 0).sum())),
        "nzr": np.int32(int((rcnt > 0).sum())),
        "deg_A": deg.to(_I32).cpu().numpy(),
    }


def regen_shard(spec: BuildSpec, graph_kind: str, part, shard: int,
                scalars: Dict[str, int], fields: Dict[str, Any],
                device="cuda") -> Dict[str, np.ndarray]:
    """Regenerate one store shard from its BuildSpec and stored geometry,
    on ``device``.

    ``shard`` is the flat shard index (k for strips, i*pc + j for the
    checkerboard); ``scalars``/``fields`` are the store's meta entries
    (the fields give the capacities the scalars do not carry: cap_nzc
    and cap_nzr from the jc and jr shapes).  Returns only the arrays
    named in ``fields``."""
    if graph_kind == "Blocked1DGraph":
        arrs = regen_shard_1d(
            spec, part, shard, cap=int(scalars["cap"]),
            cap_nzc=int(fields["jc"][0][-1]), device=device)
    elif graph_kind == "BlockedGraph":
        arrs = regen_shard_2d(
            spec, part, shard // part.pc, shard % part.pc,
            cap=int(scalars["cap"]), cap_seg=int(scalars["cap_seg"]),
            cap_nzc=int(fields["jc"][0][-1]),
            cap_nzr=int(fields["jr"][0][-1]), device=device)
    else:
        raise ValueError(f"cannot regenerate shards of {graph_kind!r}")
    return {k: arrs[k] for k in fields}
