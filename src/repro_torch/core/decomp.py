"""Decomposition registry and the whole-search level loop.

A ``Decomposition`` entry, registered under the ``BFSConfig.decomposition``
string, declares what the session API (``core/engine.py``) needs to run a
search: the partition and graph types it takes, the grid it needs, the
LevelArgs factory, the whole-search body and its plan checks.
Registered:

  "2d"  the paper's checkerboard (§4.4), grid (pr, pc)
  "1d"  row strips (Alg. 1/2 baseline), grid (p, 1): expand = one dense
        bitmap allgather, no fold, transpose or rotation
  "1ds" the same strips with the sparse owner-directed exchange, capped
        buckets (``PlanStatics.cap_x``) with a dense fallback
        (core/steps_1d_sparse.py)

Each entry also carries the Graph500 validator's edge hook
(``local_edges``, ``edge_keys``; ``core/validate.py``) and its
collective-schedule contract (``rendezvous_axes``, ``schedule_dims``,
``level_steps`` with the ``state`` they start from), which
``repro_torch.analysis`` checks against the schedule a recorded run
issues.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import collectives, trace
from repro_torch.core.collectives import GRID_2D, STRIPS
from repro_torch.core.partition import Partition1D, Partition2D
from repro_torch.core.steps import (LevelArgs, bottomup_level, topdown_level,
                                    zero_counters)
from repro_torch.core.steps_1d import (LevelArgs1D, bottomup_level_1d,
                                       topdown_level_1d)
from repro_torch.core.steps_1d_sparse import (bottomup_level_1ds,
                                              topdown_level_1ds)
from repro_torch.graph.formats import Blocked1DGraph, BlockedGraph
from repro_torch.kernels.epilogue import ops as epilogue
from repro_torch.kernels.spmsv import ops as spmsv_ops

MAX_LEVELS = 64

_F32 = np.float32


@dataclass(frozen=True)
class PlanStatics:
    """Scalars a plan resolves once from the graph and the config."""
    cap_seg: int = 0          # 2D bottom-up sub-step edge window
    cap_f: int = 0            # kernel mode: frontier bound (0 = nc)
    cap_x: int = 0            # 1ds sparse exchange: ids per send bucket
    expand_chunks: int = 1    # 1d/1ds: top-down expand in this many steps;
    #                           2d: > 1 counts the R/G split ring


@dataclass(frozen=True)
class Decomposition:
    name: str                 # registry key, = BFSConfig.decomposition
    partition_cls: type
    graph_cls: type
    axis_sizes: Callable      # (part) -> (pr, pc) the grid must have
    #                           ((p, 1) for the strips)
    make_level_args: Callable  # (part, cfg, ops, statics, graph arrays,
    #                            device)
    body: Callable            # (g, roots, *, part, args, cfg, sync_axis)
    #                           -> the lockstep searches, one root a pod
    validate: Callable        # (part, statics) -> None (raises on bad plan)
    axes: Tuple[str, ...] = GRID_2D   # the mesh axes the graph spans
    # the collective-schedule contract, checked by repro_torch.analysis:
    # ``rendezvous_axes(axes, mesh_axes)`` declares the mesh axes the
    # level schedule rendezvouses on.  "2d" permutes, which the JAX
    # package lowers as whole-mesh rendezvous, so it declares the whole
    # mesh (pod axis included) and syncs its direction decision over the
    # pods; the strips gather and reduce along their one axis only.
    # None claims the whole mesh.  The linter recomputes each recorded
    # collective's rendezvous (R1) and flags an entry whose declaration
    # under-claims it (R3).
    rendezvous_axes: Optional[Callable] = None
    # the BFSConfig fields that change the per-level schedule; the R4
    # budget sweep takes their cross product (analysis/registry.py)
    schedule_dims: Tuple[str, ...] = ("expand_chunks",)
    # (topdown, bottomup) level steps, ``step(g, pi, front, args, lv)``,
    # the ones ``body`` drives: the budget sweep runs each alone
    level_steps: Optional[Tuple[Callable, Callable]] = None
    # ``state(g, part, args, cfg) -> (start, read)``: the search state of
    # the layout, ``start(root) -> (pi, front)`` and ``read(pi, front,
    # pending) -> (n_f, m_f, m_u, over)`` in one host read, which
    # ``body`` hands the loop and the budget sweep starts a step from
    state: Optional[Callable] = None
    # the Graph500 validator's edge hook: ``local_edges(g, part, shard,
    # start, stop) -> (u, v, valid)`` enumerates slots [start, stop) of
    # one shard's edge slots (``shard`` indexes the grid dims of the
    # arrays: (i, j) or (i,)) as int64 GLOBAL layout-A ids, ``u -> v`` a
    # stored directed edge iff ``valid``; slots past the shard's edges
    # still yield in-range ids.  ``edge_keys`` names the graph arrays it
    # reads.  An entry without a hook cannot be validated.
    edge_keys: Tuple[str, ...] = ()
    local_edges: Optional[Callable] = None


_REGISTRY: Dict[str, Decomposition] = {}


def register_decomposition(entry: Decomposition) -> Decomposition:
    if entry.name in _REGISTRY:
        raise ValueError(f"duplicate decomposition {entry.name!r}")
    _REGISTRY[entry.name] = entry
    return entry


def get_decomposition(name: str) -> Decomposition:
    if name not in _REGISTRY:
        raise ValueError(f"no decomposition registered for {name!r}; "
                         f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_decompositions() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def unregister_decomposition(name: str) -> None:
    """Remove an entry: for scoped registrations only (the linter's
    fixture registers a broken entry and leaves the registry as it found
    it)."""
    if name not in _REGISTRY:
        raise ValueError(f"no decomposition registered for {name!r}")
    del _REGISTRY[name]


# ---------------------------------------------------------------------------
# The whole-search level loop
# ---------------------------------------------------------------------------


def _masses(pi: torch.Tensor, front: torch.Tensor, deg: torch.Tensor,
            over: torch.Tensor = None, axes: Tuple[str, ...] = GRID_2D,
            extra: torch.Tensor = None):
    """Frontier size, frontier edge mass and unvisited edge mass, summed
    exactly in int64 and read to the host in one transfer: the loop's
    fused reduction over the graph ``axes``.  ``over``, a 0-d bool tensor
    (the uninstrumented "1ds" bucket-overflow indicator), rides the same
    read as a fourth value; ``extra``, int64 values that are no
    reduction (kernel 1's ``cap_f`` overflow), after them."""
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    vals = [front.sum(), torch.where(front, deg, zero).sum(),
            torch.where(pi == -1, deg, zero).sum()]
    if over is not None:
        vals.append(over.to(torch.int64))
    out = collectives.psum_stacked(vals, axes)
    if extra is not None:
        out = torch.cat([out, extra])
    return out.tolist()


def reduce_state(pi: torch.Tensor, front: torch.Tensor, deg: torch.Tensor,
                 over_cap: int = 0, expand_chunks: int = 1,
                 axes: Tuple[str, ...] = GRID_2D, pending: list = None):
    """(n_f, m_f, m_u, over) of a post-level state as float32 scalars and
    a bool, in one host read: one fused reduction over ``axes``.  ``over_cap`` > 0 (the uninstrumented "1ds"
    loop) adds the bucket-overflow indicator to that read; else ``over``
    is False.  ``pending`` holds kernel 1's deferred ``cap_f`` checks of
    the level (``spmsv_ops.deferred_cap_checks``): their overflow rides
    the same read, and a frontier past ``cap_f`` raises here, as the call
    on the CPU raises at once.

    The indicator is counted over ``front``, not the sieved send set
    ``front & ~visited``: in the loop the sieve leaves the frontier whole,
    so the count is the same.  At ``expand_chunks`` C > 1 each owner's
    chunk is C sub-ranges with buckets of ``over_cap // C`` ids, and any
    one of them overflowing sends the level to the dense fallback."""
    over = None
    if over_cap:
        counts = front.reshape(front.shape[0], expand_chunks, -1).sum(2)
        over = counts.max() > over_cap // expand_chunks
    extra = spmsv_ops.overflow(pending) if pending else None
    vals = _masses(pi, front, deg, over, axes, extra)
    if extra is not None:
        spmsv_ops.raise_overflow(pending, vals[-2:])
        vals = vals[:-2]
    n_f, m_f, m_u, *ov = vals
    return _F32(n_f), _F32(m_f), _F32(m_u), bool(ov and ov[0])


def decide_and_sync(cfg: BFSConfig, n_total: int, modes: Sequence[int],
                    states: Sequence[Tuple], sync_modes: bool = False,
                    sync_axis: Optional[str] = None) -> List[int]:
    """Beamer's direction rule in float32: each pod's next mode (0
    top-down, 1 bottom-up) from its own ``(n_f, m_f, m_u, ...)``.  With
    ``sync_modes`` ("2d", whose collectives span the whole mesh in the
    JAX package) the decision is the pods' shared one: bottom-up when any
    pod wants it (the reference's pmax), top-down again only when every
    pod wants it (its pmin); over a pod axis ``sync_axis`` the two are
    recorded, and that record is what makes the decision uniform over
    the pods (``analysis/uniformity.py``).  The lockstep frontier size,
    the pmax of the pods' ``n_f``, is the loop's own predicate
    (``_search_loop``)."""
    if not cfg.direction_optimizing:
        return list(modes)
    go_bu = [mode == 0 and m_f > m_u / _F32(cfg.alpha)
             for mode, (n_f, m_f, m_u, *_) in zip(modes, states)]
    go_td = [mode == 1 and n_f < _F32(n_total / cfg.beta)
             for mode, (n_f, m_f, m_u, *_) in zip(modes, states)]
    if sync_modes:
        if sync_axis is not None:
            collectives.noted("pmax", (sync_axis,), "decision")
            collectives.noted("pmin", (sync_axis,), "decision")
        go_bu = [any(go_bu)] * len(modes)
        go_td = [all(go_td)] * len(modes)
    return [1 if bu else 0 if td else mode
            for mode, bu, td in zip(modes, go_bu, go_td)]


# the level loop's step spans and modes, by mode (0 top-down, 1 bottom-up)
STEP_SPANS = ("bfs.td", "bfs.bu")
STEP_MODES = ("td", "bu")


def _at(tr, name: str, level: int, mode: str, pod: Optional[int] = None,
        attrs: Optional[Dict] = None):
    """Where the loop stands, for a schedule recorder (``collectives.at``),
    and the span ``name`` of what it does there, with ``attrs``, when the
    search is traced (``tr``, from ``trace.current``)."""
    collectives.at(level, mode, pod)
    return trace.OFF if tr is None else tr.span(name, **(attrs or {}))


def _search_loop(roots: Sequence[int], *, n_total: int, cfg: BFSConfig,
                 td_level, bu_level, start, read, sync_modes: bool = False,
                 sync_axis: Optional[str] = None):
    """Beamer's direction heuristics, and with ``cfg.instrument`` the
    per-level stats and counter accumulation, over the (pi, front, lv) ->
    (pi, front, ctr) steps.  The body hands the loop the state of its
    layout: ``start(root) -> (pi, front)`` the root's, and ``read(pi,
    front, pending) -> (n_f, m_f, m_u, over)`` the post-level values in
    one host read (``pending``: kernel 1's deferred ``cap_f`` checks).
    The strips' ``front`` is a bool mask reduced by ``reduce_state``; the
    2D steps' is a ``Front`` whose masses their level epilogue summed.

    ``roots`` holds one root per pod: the searches run in lockstep, as
    the JAX package's pod-batched program runs them.  Each pod keeps its
    own frontier size, which its direction rule reads
    (``decide_and_sync``); the loop runs while any pod's frontier is
    live, so a pod whose search has ended runs the real steps on an empty
    frontier, each writing its stats row ``(0, 0, mode, 1,
    wire_expand)``.  On one card the pods run one after the other inside
    each level.  A single search is the case of one pod.

    The loop is a Python loop.  Each level ends with one host read a pod
    (``read``): the next frontier's size and the frontier and
    unvisited edge masses, which the next level's direction decision and
    the loop's exit need (the JAX package keeps them on the device inside
    a while loop).  Kernel 1 reads nothing (``spmsv/ops.py``); its
    ``cap_f`` checks, where a plan sets one, ride the tail read
    (``deferred_cap_checks``).  An instrumented "1ds" top-down level adds one:
    the largest send count (the overflow predicate, which picks the
    level's branch) with the send total.  Uninstrumented, the overflow
    indicator rides the tail read instead (``reduce_state``'s
    ``over_cap``, the "1ds" bucket capacity, over ``expand_chunks``
    sub-ranges) and reaches the step as ``lv["over"]``, so that level
    reads nothing more.
    The strip kernels' grids are fixed by the graph, so "1d" reads nothing
    more, and neither do bottom-up levels or dense discovery.

    The masses are summed exactly in int64 and cast to float32.  The JAX
    package sums them in float32, which is exact up to 2**24 and beyond
    that depends on its reduction order, so past 2**24 the two can differ
    in the last bits of m_f and m_u and, at a threshold, in a decision.

    The loop tells ``core/collectives.py`` where it stands (``at``: the
    level, the mode and, with a pod axis ``sync_axis``, the pod), so a
    ``ScheduleRecorder`` files each collective under its level: a step's
    under "td" or "bu", the tail reduction (over the graph's axes), the
    decision's pod sync and the lockstep pmax over ``sync_axis`` under
    "loop".  The reduction before the first level is filed at level -1.

    Uninstrumented (the JAX package's ``_search_loop_fast``), the
    counters come back ``{}`` (never zeros, which would read as
    measurements) and the stats all zeros.  The modes, the parents and
    the overflowed levels are the instrumented run's: the same values
    meet the same rule.

    A traced search (``core/trace.py``; the decision ``trace.current``
    is read once here and reaches the steps as ``lv["trace"]``) spans
    the loop's entry through its first reduction (``bfs.start``), each
    pod's step (``bfs.td`` / ``bfs.bu``, with the level, the pod, the
    ``n_f``, ``m_f``, ``m_u`` and ``over`` the rule read and the mode it
    chose: the mode sequence, instrumented or not) and each pod's
    reduction with its host read (``bfs.tail``); a Recorder also counts
    the levels, the top-down and bottom-up steps and the host reads.
    ``_at`` sets the schedule recorder's position and opens the span in
    one call.

    Returns (pis, n_levels, ctrs, stats): a list of pi and of counters, a
    pod each, the lockstep trip count, and (pods, MAX_LEVELS, 5) stats."""
    instrument = cfg.instrument
    tr = trace.current()
    stats = np.zeros((len(roots), MAX_LEVELS, 5), np.float32)
    ctrs = [zero_counters() if instrument else {} for _ in roots]

    def pod(k):
        return None if sync_axis is None else k

    def tail(level, pending):
        """The post-level reductions: each pod's (the first also reads
        the level's deferred ``cap_f`` checks), then the lockstep pmax of
        the pods' frontier sizes."""
        out = []
        for k, (pi, f) in enumerate(zip(pis, fronts)):
            with _at(tr, "bfs.tail", level, "loop", pod(k)):
                out.append(read(pi, f, pending))
            if tr is not None:
                tr.count("host_reads")
        if sync_axis is not None:
            collectives.at(level, "loop")
            collectives.noted("pmax", (sync_axis,), "lockstep")
        return out

    with spmsv_ops.deferred_cap_checks() as pending:
        with trace.OFF if tr is None else tr.span("bfs.start"):
            pis, fronts = (list(x) for x in zip(*map(start, roots)))
            states = tail(-1, pending)
        modes, level = [0] * len(roots), 0
        while level < MAX_LEVELS and max(st[0] for st in states) > 0:
            collectives.at(level, "loop")
            modes = decide_and_sync(cfg, n_total, modes, states, sync_modes,
                                    sync_axis)
            for k, (mode, (n_f, m_f, m_u, over)) in enumerate(zip(modes,
                                                                  states)):
                step = bu_level if mode == 1 else td_level
                with _at(tr, STEP_SPANS[mode], level, STEP_MODES[mode],
                         pod(k), None if tr is None else dict(
                             level=level, pod=k, mode=STEP_MODES[mode],
                             n_f=float(n_f), m_f=float(m_f),
                             m_u=float(m_u), over=over)):
                    pis[k], fronts[k], c2 = step(pis[k], fronts[k],
                                                 {"n_f": n_f, "m_f": m_f,
                                                  "over": over, "trace": tr})
                if tr is not None:
                    tr.count(STEP_MODES[mode] + "_levels")
                if instrument:
                    ctrs[k] = {key: ctrs[k][key] + c2[key]
                               for key in ctrs[k]}
                    # stats row: n_f, m_f, mode, used, measured expand words
                    stats[k, level] = (n_f, m_f, mode, 1, c2["wire_expand"])
            states = tail(level, pending)
            level += 1
    if tr is not None:
        tr.count("levels", level)
    return pis, level, ctrs, stats


# ---------------------------------------------------------------------------
# 2D checkerboard entry
# ---------------------------------------------------------------------------


def _read_front_2d(pi: torch.Tensor, front: epilogue.Front,
                   pending: list):
    """The 2D tail: (n_f, m_f, m_u, over) of a post-level state from the
    masses its level epilogue summed (the fused psum over the grid that
    ``_masses`` records), with kernel 1's deferred ``cap_f`` checks, in
    one host read; ``over`` is False."""
    collectives.noted("psum", GRID_2D, nbytes=3 * collectives.SCALAR_BYTES)
    vals = front.masses
    extra = spmsv_ops.overflow(pending) if pending else None
    if extra is not None:
        vals = torch.cat([vals, extra])
    vals = vals.tolist()
    if extra is not None:
        spmsv_ops.raise_overflow(pending, vals[-2:])
    n_f, m_f, m_u = vals[:3]
    return _F32(n_f), _F32(m_f), _F32(m_u), False


def _state_2d(g, part: Partition2D, args: LevelArgs, cfg: BFSConfig):
    """The 2D state: a root's is ``pi`` all -1 through the level
    epilogue with the root as the one candidate (the flat index of the
    grid layout is the vertex id), read by ``_read_front_2d``."""
    deg = g["deg_A"]

    def start(root):
        pi = torch.full(deg.shape, -1, dtype=torch.int32, device=deg.device)
        return pi, args.ops.epilogue(pi, deg, root=root)

    return start, _read_front_2d


def _bfs_body_2d(g, roots, *, part: Partition2D, args: LevelArgs,
                 cfg: BFSConfig, sync_axis: Optional[str] = None,
                 sync_modes: bool = True):
    """The 2D search over one root a pod (``sync_axis`` names the pod
    axis of a batch); the JAX package's 2D steps rendezvous with the
    whole mesh, so the pods share each direction decision
    (``sync_modes``; the linter's fixture turns it off)."""
    start, read = _state_2d(g, part, args, cfg)
    return _search_loop(
        roots, n_total=part.n, cfg=cfg,
        td_level=lambda pi, f, lv: topdown_level(g, pi, f, args, lv),
        bu_level=lambda pi, f, lv: bottomup_level(g, pi, f, args, lv),
        start=start, read=read, sync_modes=sync_modes,
        sync_axis=sync_axis)


def _make_args_2d(part, cfg, ops, statics: PlanStatics, arrays,
                  device) -> LevelArgs:
    return LevelArgs(part=part, fold_mode=cfg.fold_mode,
                     perm=collectives.perm_index(part.transpose_perm(), device),
                     seg_ptr=arrays["seg_ptr"].cpu().numpy().astype(np.int64),
                     ops=ops, cap_seg=statics.cap_seg, cap_f=statics.cap_f,
                     instrument=cfg.instrument,
                     use_edge_dst=cfg.use_edge_dst,
                     compact_updates=cfg.compact_updates,
                     expand_chunks=statics.expand_chunks)


def _validate_2d(part, statics: PlanStatics) -> None:
    if statics.cap_seg <= 0:
        raise ValueError("2d decomposition needs cap_seg > 0 "
                         "(pass graph.cap_seg)")


# The validator's edge slots are read from the CSR side, ``col_idx`` with
# the row of each slot recovered from ``row_ptr``, which every LocalOps
# entry ships.  The JAX package's hooks read the CSC side (``edge_src``/
# ``row_idx``) for "2d" and ``edge_dst`` for the strips, which the kernel
# entries do not ship and strips built ``with_edge_lists=False`` do not
# have.  Both orientations store the same multiset of valid slots, so
# every count of the validator is the same.
EDGE_KEYS = ("row_ptr", "col_idx", "nnz")


def _csr_slots(g, shard, start: int, stop: int):
    """(source field, local row, valid) of CSR slots [start, stop) of one
    shard: the row of a slot is the last row whose ``row_ptr`` entry is at
    or below it (clamped to the last row past the shard's edges)."""
    rp = g["row_ptr"][shard]
    slot = torch.arange(start, stop, dtype=rp.dtype, device=rp.device)
    row = torch.searchsorted(rp, slot, right=True).sub_(1)
    row.clamp_(0, rp.numel() - 2)
    valid = slot < g["nnz"][shard]
    return g["col_idx"][shard][start:stop].to(torch.int64), row, valid


def _local_edges_2d(g, part: Partition2D, shard, start: int, stop: int):
    """(u, v, valid) for block (i, j): CSR ``col_idx`` is the block-local
    source (column j owns sources [j*nc, (j+1)*nc)), the row the
    block-local dest (row i owns dests [i*nr, (i+1)*nr)).  The JAX
    package reads the CSC side (``edge_src``, ``row_idx``): the same
    valid slots in another order."""
    i, j = shard
    src, row, valid = _csr_slots(g, shard, start, stop)
    return src.add_(j * part.nc), row.add_(i * part.nr), valid


def _local_edges_1d(g, part: Partition1D, shard, start: int, stop: int):
    """(u, v, valid) for strip i: CSR ``col_idx`` is already the GLOBAL
    source, the row the strip-local dest (strip i owns [i*chunk,
    (i+1)*chunk)).  The JAX package reads ``edge_dst`` for the dest: the
    same valid slots."""
    (i,) = shard
    src, row, valid = _csr_slots(g, shard, start, stop)
    return src, row.add_(i * part.chunk), valid


register_decomposition(Decomposition(
    name="2d", partition_cls=Partition2D, graph_cls=BlockedGraph,
    axis_sizes=lambda part: (part.pr, part.pc),
    make_level_args=_make_args_2d, body=_bfs_body_2d,
    validate=_validate_2d,
    # permutes rendezvous with every device: hence sync_modes above
    rendezvous_axes=lambda axes, mesh_axes: tuple(mesh_axes),
    schedule_dims=("fold_mode", "compact_updates", "expand_chunks"),
    level_steps=(topdown_level, bottomup_level), state=_state_2d,
    edge_keys=EDGE_KEYS, local_edges=_local_edges_2d))


# ---------------------------------------------------------------------------
# 1D row-strip entries ("1d", "1ds")
# ---------------------------------------------------------------------------


def _make_strip_state(sparse: bool):
    """The state of a strip entry: global ids in the (p, chunk) strip
    layout, bool fronts reduced by ``reduce_state``; ``sparse`` for
    "1ds", whose uninstrumented read carries the overflow indicator of
    its buckets."""

    def state(g, part: Partition1D, args: LevelArgs1D, cfg: BFSConfig):
        deg = g["deg_A"]
        gidx = torch.arange(part.n, dtype=torch.int32,
                            device=deg.device).reshape(part.p, part.chunk)
        cap = args.cap_x if sparse and not cfg.instrument else 0

        def start(root):
            return torch.where(gidx == root, root, -1).to(torch.int32), \
                gidx == root

        def read(pi, front, pending):
            return reduce_state(pi, front, deg, cap, args.expand_chunks,
                                STRIPS, pending)

        return start, read

    return state


def _make_strip_body(td_step, bu_step, state):
    """The whole-search body of a strip entry: the shared loop over the
    given level steps from the entry's ``state``, one root a pod.  The
    strips' collectives stay inside a pod in the JAX package, so each pod
    switches direction on its own (no ``sync_modes``)."""

    def body(g, roots, *, part: Partition1D, args: LevelArgs1D,
             cfg: BFSConfig, sync_axis: Optional[str] = None):
        start, read = state(g, part, args, cfg)
        return _search_loop(
            roots, n_total=part.n, cfg=cfg,
            td_level=lambda pi, f, lv: td_step(g, pi, f, args, lv),
            bu_level=lambda pi, f, lv: bu_step(g, pi, f, args, lv),
            start=start, read=read, sync_axis=sync_axis)

    return body


def _make_args_strip(part, cfg, ops, statics: PlanStatics, arrays,
                     device) -> LevelArgs1D:
    return LevelArgs1D(part=part, ops=ops,
                       nnz=arrays["nnz"].cpu().numpy().astype(np.int64),
                       expand_chunks=statics.expand_chunks,
                       cap_x=statics.cap_x, cap_f=statics.cap_f,
                       codec=cfg.frontier_codec,
                       instrument=cfg.instrument,
                       use_edge_dst=cfg.use_edge_dst)


def _validate_strip_chunks(part, statics: PlanStatics) -> None:
    """The pipelined expand splits each owner's chunk/32 packed words
    into expand_chunks equal sub-chunks; a ragged last one would
    mis-align the owner-major layout."""
    c = statics.expand_chunks
    words = part.chunk // 32
    if c > 1 and words % c != 0:
        raise ValueError(
            f"expand_chunks={c} does not divide the per-device strip's "
            f"packed word count ({words} = chunk {part.chunk} / 32); "
            f"pick a divisor of {words}")


def _validate_1ds(part, statics: PlanStatics) -> None:
    if statics.cap_x <= 0:
        raise ValueError(
            "1ds decomposition needs cap_x > 0 (plan_bfs derives it from "
            "the graph via comm_model.plan_cap_x; graph-less plans must "
            "pass cap_x explicitly)")
    if statics.cap_x > part.chunk:
        raise ValueError(
            f"cap_x={statics.cap_x} exceeds the owned chunk "
            f"({part.chunk}); a bucket can never hold more frontier ids "
            f"than a processor owns")
    _validate_strip_chunks(part, statics)
    c = statics.expand_chunks
    if c > 1 and statics.cap_x % c != 0:
        raise ValueError(
            f"expand_chunks={c} does not divide cap_x={statics.cap_x}; "
            f"the chunked sparse exchange splits the send bucket into "
            f"expand_chunks equal sub-buckets")


for _name, _td, _bu, _validate, _dims in (
        ("1d", topdown_level_1d, bottomup_level_1d, _validate_strip_chunks,
         ("expand_chunks",)),
        ("1ds", topdown_level_1ds, bottomup_level_1ds, _validate_1ds,
         ("frontier_codec", "expand_chunks"))):
    _state = _make_strip_state(sparse=_name == "1ds")
    register_decomposition(Decomposition(
        name=_name, partition_cls=Partition1D, graph_cls=Blocked1DGraph,
        axis_sizes=lambda part: (part.p, 1),
        make_level_args=_make_args_strip,
        body=_make_strip_body(_td, _bu, _state),
        validate=_validate, axes=STRIPS,
        # gathers and reductions along the strip axis only: per-pod
        # direction decisions are safe
        rendezvous_axes=lambda axes, mesh_axes: tuple(axes),
        schedule_dims=_dims, level_steps=(_td, _bu), state=_state,
        edge_keys=EDGE_KEYS, local_edges=_local_edges_1d))
