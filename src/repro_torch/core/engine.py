"""BFSEngine: the plan -> compile -> run traversal session.

The Graph500 methodology (paper §7) is "build the distributed graph once,
then run BFS from 16-64 roots", so a session has three stages:

  plan    ``plan_bfs(graph, cfg, mesh) -> BFSPlan`` resolves the
          Decomposition entry (core/decomp.py) and the LocalOps entry
          (core/local_ops.py), pulls the static scalars (cap_seg, and
          for "1ds" the planned bucket capacity cap_x) from the graph,
          and checks graph, partition, mesh and config up front.

  compile ``BFSPlan.compile() -> BFSEngine`` ships the graph arrays to
          the mesh's device ONCE, builds the search program once (the
          level arguments and, for ``local_mode="kernel"``, every CUDA
          kernel the LocalOps entry can launch) and warms it up with
          one search; ``ship_s`` and ``compile_s`` report the two costs
          apart.

  run     ``BFSEngine.run(root)`` / ``run_many(roots)`` reuse both;
          ``validate=True`` checks each tree on the device with the
          Graph500 validator (``core/validate.py``).
          ``run_batch(roots, pod_axis="pod")`` runs the roots spread
          over the mesh's pod axis, the searches of each scan position
          in lockstep (the JAX package's pod-batched program).

``run_bfs_healed`` plans, compiles and runs a "1ds" session with a
bounded ``cap_x`` escalation when its buckets overflow (the JAX
package's self-healing session).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import comm_model, trace
from repro_torch.core.decomp import (MAX_LEVELS, Decomposition, PlanStatics,
                                     get_decomposition,
                                     registered_decompositions)
from repro_torch.core.local_ops import LocalOps, get_local_ops
from repro_torch.core.steps_1d_sparse import CODECS
from repro_torch.kernels import build


@dataclass
class BFSResult:
    parents: np.ndarray          # (n_orig,) int64
    n_levels: int
    counters: Dict[str, float]   # whole-search totals (paper 64-bit words);
    #                              {} with cfg.instrument False
    level_stats: np.ndarray      # (MAX_LEVELS, 5) float32: n_f, m_f, mode,
    #                              used, measured expand words that level;
    #                              all zeros with cfg.instrument False
    validation: Optional[Any] = None  # ValidationReport when run(...,
    #                              validate=True); None otherwise


@dataclass
class BFSBatchResult:
    """Pod-batched searches, in the caller's root order.  No counters (the
    batch does not accumulate them per root; use ``run``/``run_many``).
    ``level_stats`` holds each root's own frontier sizes and modes; the
    searches at one scan position share the lockstep trip count
    ``n_levels``, so a root's rows past its own search read (0, 0,
    mode, 1, wire_expand).  All zeros with cfg.instrument False."""
    roots: np.ndarray            # (n_roots,) int64
    parents: np.ndarray          # (n_roots, n_orig) int64
    n_levels: np.ndarray         # (n_roots,) int64
    level_stats: np.ndarray      # (n_roots, MAX_LEVELS, 5) float32


# the values of the BFSConfig string fields a plan takes (the
# decomposition: any registered entry)
_VALUES = {"fold_mode": ("reduce", "alltoall", "bitmap", "bitmap_pure"),
           "storage": ("csr", "dcsc")}


@dataclass(frozen=True)
class BFSPlan:
    """A validated description of one traversal session: which
    decomposition and local format run on which grid with which static
    capacities.  ``compile()`` it into a BFSEngine once a graph is
    attached."""
    part: Any
    cfg: BFSConfig
    mesh: Any                     # launch.mesh.SimMesh
    entry: Decomposition
    ops: LocalOps
    statics: PlanStatics
    graph: Any = None

    @property
    def keys(self) -> Tuple[str, ...]:
        """Graph arrays this plan ships (from the LocalOps entry)."""
        return self.ops.keys

    def _level_args(self, graph_arrays: Dict[str, torch.Tensor]):
        return self.entry.make_level_args(self.part, self.cfg, self.ops,
                                          self.statics, graph_arrays,
                                          self.mesh.device)

    def build_fn(self, graph_arrays: Dict[str, torch.Tensor]):
        """The single-root search program over shipped arrays:
        fn(root) -> (pi in the grid layout, (pr, pc, chunk) or (p, chunk),
        n_levels, counters, level_stats)."""
        args = self._level_args(graph_arrays)

        def fn(root: int):
            pis, level, ctrs, stats = self.entry.body(
                graph_arrays, [root], part=self.part, args=args,
                cfg=self.cfg)
            return pis[0], level, ctrs[0], stats[0]
        return fn

    def build_batch_fn(self, graph_arrays: Dict[str, torch.Tensor],
                       pod_axis: str = "pod"):
        """The pod-batched program: fn(roots) -> (pis, n_levels,
        level_stats), pis ``(*grid, n_roots, chunk)`` with the grid
        ``(pr, pc)`` or ``(p,)``, n_levels (n_roots,) int32 and the stats
        (n_roots, MAX_LEVELS, 5).  Pod k takes roots[k*rpp:(k+1)*rpp] and
        scans them in order; the pods' searches at one scan position run
        in lockstep, as ``shard_map`` over the pod axis runs them in the
        JAX package."""
        pods = _pod_count(self.mesh, pod_axis)
        args = self._level_args(graph_arrays)

        def fn(roots):
            roots = [int(r) for r in np.asarray(roots).reshape(-1)]
            _check_split(len(roots), pods)
            rpp = len(roots) // pods
            pis = [None] * len(roots)
            levels = np.zeros(len(roots), np.int32)
            stats = np.zeros((len(roots), MAX_LEVELS, 5), np.float32)
            for j in range(rpp):
                at = [k * rpp + j for k in range(pods)]
                pi_j, level, _, st = self.entry.body(
                    graph_arrays, [roots[i] for i in at], part=self.part,
                    args=args, cfg=self.cfg, sync_axis=pod_axis)
                for k, i in enumerate(at):
                    pis[i], levels[i], stats[i] = pi_j[k], level, st[k]
            pis = torch.stack(pis, dim=-2)
            return pis, levels, stats
        return fn

    def lint(self, pod_axis: Optional[str] = None) -> List[Any]:
        """The collective-schedule linter (``repro_torch.analysis``, rules
        R1-R3) on one recorded search of this plan; the findings, empty
        when clean.  On a mesh with a "pod" axis (or a ``pod_axis``) it
        lints the pod-batched search, where divergence hazards live.
        The plan is compiled and searched from its highest-degree
        vertices.  The registry-wide sweeps, R4 included, are ``python
        -m repro_torch.analysis.lint``."""
        from repro_torch.analysis.registry import lint_plan
        if pod_axis is None and "pod" in self.mesh.shape:
            pod_axis = "pod"
        return lint_plan(self, pod_axis=pod_axis)

    def compile(self, store=None, exec_key: str = "default") -> "BFSEngine":
        """Ship the graph and build the search program (both once); the
        engine runs any number of roots against them.  ``store`` (a
        ``ckpt/graph_store.py::GraphStore``) is asked for a program saved
        under ``exec_key`` and given the fresh one, as in the JAX package;
        the port's store keeps none, so the session is always built here
        (``engine.exec_from_store`` False, ``exec_load_s`` 0)."""
        return BFSEngine(self, store=store, exec_key=exec_key)


def _check_config(cfg: BFSConfig) -> None:
    for field, values in dict(
            _VALUES, decomposition=registered_decompositions()).items():
        if getattr(cfg, field) not in values:
            raise ValueError(f"cfg.{field}={getattr(cfg, field)!r} is not "
                             f"one of {values}")
    if cfg.frontier_codec not in CODECS:
        raise ValueError(f"cfg.frontier_codec={cfg.frontier_codec!r} is not "
                         f"a frontier codec; have {CODECS}")
    if cfg.expand_chunks < 1:
        raise ValueError(f"cfg.expand_chunks={cfg.expand_chunks} must be "
                         f">= 1 (1 = unpipelined expand)")


def plan_for_part(part, cfg: BFSConfig, mesh, *, local_mode: str = "dense",
                  cap_seg: int = 0, cap_f: int = 0, cap_x: int = 0) -> BFSPlan:
    """A graph-less plan from a partition and static capacities; every
    check that needs no arrays."""
    _check_config(cfg)
    entry = get_decomposition(cfg.decomposition)
    if not isinstance(part, entry.partition_cls):
        raise TypeError(
            f"decomposition={cfg.decomposition!r} needs a "
            f"{entry.partition_cls.__name__}, got {type(part).__name__}")
    if (mesh.pr, mesh.pc) != tuple(entry.axis_sizes(part)):
        raise ValueError(f"mesh grid {mesh.pr}x{mesh.pc} but the partition "
                         f"needs {entry.axis_sizes(part)}")
    ops = get_local_ops(cfg.decomposition, local_mode, cfg.storage)
    statics = PlanStatics(cap_seg=cap_seg, cap_f=cap_f, cap_x=cap_x,
                          expand_chunks=cfg.expand_chunks)
    entry.validate(part, statics)
    return BFSPlan(part=part, cfg=cfg, mesh=mesh, entry=entry, ops=ops,
                   statics=statics)


def plan_bfs(graph, cfg: BFSConfig, mesh, *, local_mode: str = "dense",
             cap_f: int = 0, cap_x: int = 0) -> BFSPlan:
    """Plan a traversal session over a concrete blocked graph: resolve the
    entries, pull the statics from the graph, and check that the graph
    carries every array the chosen local format ships.  ``cap_x`` (the
    "1ds" bucket capacity) is planned from the graph when not given:
    ``comm_model.plan_cap_x`` at the packed codec's width
    ``codec_bits(chunk)``, or 64 bits for raw ids."""
    _check_config(cfg)
    entry = get_decomposition(cfg.decomposition)
    if not isinstance(graph, entry.graph_cls):
        raise TypeError(
            f"cfg.decomposition={cfg.decomposition!r} does not match "
            f"graph type {type(graph).__name__}")
    part = graph.part
    if cap_x <= 0:
        bits = comm_model.codec_bits(part.chunk) \
            if cfg.frontier_codec == "packed" else 64
        cap_x = comm_model.plan_cap_x(part.n, part.p, int(graph.m),
                                      bits=bits)
    plan = plan_for_part(part, cfg, mesh, local_mode=local_mode,
                         cap_f=cap_f, cap_seg=getattr(graph, "cap_seg", 0),
                         cap_x=cap_x)
    arrays = graph.device_arrays()
    missing = [k for k in plan.keys if k not in arrays]
    if missing:
        raise ValueError(f"graph lacks arrays {missing} needed by "
                         f"local_mode={local_mode!r}")
    return replace(plan, graph=graph)


def _pod_count(mesh, pod_axis: str) -> int:
    if pod_axis not in mesh.shape:
        raise ValueError(f"mesh has no {pod_axis!r} axis for batched "
                         f"roots; axes are {tuple(mesh.shape)}")
    return mesh.shape[pod_axis]


def _check_split(n_roots: int, pods: int) -> None:
    if n_roots == 0 or n_roots % pods:
        raise ValueError(f"{n_roots} roots do not split evenly over "
                         f"{pods} pods")


def sync_device(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU):
    what a host-clock search time needs after ``search``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BFSEngine:
    """A compiled traversal session: graph shipped once, program built
    once, traversed from many roots.

    Attributes:
      ship_s       seconds to move the graph arrays to the mesh's device
      compile_s    seconds to build the search program (kernels included)
                   and run one warm-up search
      ship_count   graph shipments so far (1 after compile; run/run_many
                   never add one)
      trace_count  search programs built so far (1 after compile; one
                   more for each new (pod_axis, roots-per-pod) batch)
      batch_compile_s  cumulative seconds building pod-batched programs
                   (0.0 until the first run_batch)
      exec_from_store  whether the program came from a store (never in
                   the port: its store keeps no programs)
      exec_load_s  seconds loading a stored program (0.0)

    Graph tensors already on the mesh's device (born-sharded builds,
    store loads onto a mesh) are used as they are: shipping them copies
    nothing.
    """

    def __init__(self, plan: BFSPlan, store=None,
                 exec_key: str = "default"):
        if plan.graph is None:
            raise ValueError("plan has no graph attached; build it with "
                             "plan_bfs(graph, cfg, mesh)")
        self.plan = plan
        self.ship_count = 0
        self.trace_count = 0
        self.batch_compile_s = 0.0
        self._batch_cache: Dict[Tuple[str, int], Any] = {}
        dev = plan.mesh.device
        t0 = time.perf_counter()
        self._gdev = self._ship(plan.graph.device_arrays(), dev)
        sync_device(dev)
        t1 = time.perf_counter()
        self.ship_s = t1 - t0
        self.exec_from_store = False
        self.exec_load_s = 0.0
        if store is not None:
            store.load_executable(plan, exec_key)   # always a miss
        if dev.type == "cuda" and plan.ops.kernels:
            build.build_libraries({k.stem for k in plan.ops.kernels})
            for k in plan.ops.kernels:
                k.load()
        self._fn = plan.build_fn(self._gdev)
        self.trace_count += 1
        # warm-up from the highest-degree vertex: with the direction
        # heuristics on, it runs top-down (for "1ds", the sparse exchange
        # of the one-vertex frontier) and then bottom-up on the hub's
        # neighbourhood, so every level kind has run before the first
        # timed root; the kernels are built and loaded above whichever
        # levels it reaches
        self._fn(int(torch.argmax(self._gdev["deg_A"].reshape(-1))))
        sync_device(dev)
        self.compile_s = time.perf_counter() - t1
        if store is not None:
            store.save_executable(self, exec_key)

    def _ship(self, arrays: Dict[str, torch.Tensor], dev: torch.device):
        self.ship_count += 1
        return {k: arrays[k].to(dev) for k in self.plan.keys}

    def collective_counts(self, root: Optional[int] = None) -> Dict:
        """The collectives one search issues, recorded
        (``core/collectives.py``): per-kind counts and their ``total``,
        the reduction before the first level (``startup``) and, level by
        level, the mode and the counts of its body and of the loop
        (``levels``).  ``root`` defaults to the highest-degree vertex.
        The JAX package counts its compiled program's text instead."""
        from repro_torch.core.collectives import ScheduleRecorder
        if root is None:
            root = int(torch.argmax(self._gdev["deg_A"].reshape(-1)))
        with ScheduleRecorder() as rec:
            self.search(root)
        return rec.summary()

    def _check_root(self, root) -> int:
        """A root in the padded ghost range has no edges and would return
        an empty tree; reject it at the session boundary."""
        part = self.plan.part
        root = int(root)
        if not 0 <= root < part.n_orig:
            raise ValueError(
                f"root {root} out of range [0, {part.n_orig}): the graph "
                f"has {part.n_orig} vertices (padded to {part.n})")
        return root

    def search(self, root: int):
        """The device search: (pi on the device, n_levels, counters,
        level_stats).  Time this plus a synchronize for traversal time.
        The whole call is the ``bfs.search`` span (``core/trace.py``)."""
        with trace.search() as sp:
            out = self._fn(self._check_root(root))
            if sp is not None:
                sp.attrs.update(roots=[int(root)], pods=1,
                                n_levels=int(out[1]))
        return out

    def to_result(self, out) -> BFSResult:
        """Parents by global vertex id on the host, counters as floats
        (none from an uninstrumented search)."""
        part = self.plan.part
        pi, level, ctr, stats = out
        pi = pi.reshape(part.n)[: part.n_orig].cpu().numpy()
        return BFSResult(parents=pi.astype(np.int64), n_levels=int(level),
                         counters={k: float(v) for k, v in ctr.items()},
                         level_stats=np.asarray(stats))

    def run(self, root: int, validate: bool = False) -> BFSResult:
        """One whole search against the shipped graph, results on host.

        ``validate=True`` runs the Graph500 parent-tree validator
        (``core/validate.py``) on the DEVICE parent array, before its host
        copy, where the graph's shards live: the report is attached as
        ``result.validation`` and a failing tree raises ``ValidationError``
        carrying it.  The validator is built on the first validated run
        and kept."""
        out = self.search(root)
        rep = None
        if validate:
            from repro_torch.core import validate as _validate
            rep = _validate.validate_device(self, self._check_root(root),
                                            out[0])
        res = self.to_result(out)
        res.validation = rep
        if rep is not None and not rep.ok:
            raise _validate.ValidationError(rep)
        return res

    def search_batch(self, roots: Sequence[int], pod_axis: str = "pod"):
        """The device side of ``run_batch``: (pis ``(*grid, n_roots,
        chunk)`` on the device, n_levels, level_stats).  Time this plus a
        synchronize for the batch's traversal time.  The batched program
        is built once per (pod_axis, roots-per-pod) and kept.  The whole
        call is the ``bfs.search`` span (``core/trace.py``)."""
        with trace.search() as sp:
            pods = _pod_count(self.plan.mesh, pod_axis)
            roots = np.asarray(roots, dtype=np.int32).reshape(-1)
            _check_split(roots.size, pods)
            for r in roots:
                self._check_root(r)
            key = (pod_axis, roots.size // pods)
            if key not in self._batch_cache:
                t0 = time.perf_counter()
                self._batch_cache[key] = self.plan.build_batch_fn(
                    self._gdev, pod_axis)
                self.trace_count += 1
                self.batch_compile_s += time.perf_counter() - t0
            out = self._batch_cache[key](roots)
            if sp is not None:
                sp.attrs.update(roots=roots.tolist(), pods=pods,
                                n_levels=out[1].tolist())
        return out

    def run_batch(self, roots: Sequence[int],
                  pod_axis: str = "pod") -> BFSBatchResult:
        """Multi-source BFS with the roots spread over ``pod_axis``: each
        pod scans its len(roots)/pods roots while the pods' level loops
        stay in lockstep, against the one shipped graph; parents by
        global vertex id on the host, in the caller's root order."""
        roots = np.asarray(roots, dtype=np.int32).reshape(-1)
        pis, levels, stats = self.search_batch(roots, pod_axis)
        part = self.plan.part
        # (*grid, n_roots, chunk) -> (n_roots, n) in layout A
        pis = torch.movedim(pis, -2, 0).reshape(roots.size, part.n)
        pis = pis[:, : part.n_orig].cpu().numpy()
        return BFSBatchResult(roots=roots.astype(np.int64),
                              parents=pis.astype(np.int64),
                              n_levels=levels.astype(np.int64),
                              level_stats=stats)

    def run_many(self, roots: Sequence[int], validate: bool = False,
                 monitor=None) -> List[BFSResult]:
        """The Graph500 loop: sequential searches from many roots against
        the one shipped graph and program.

        ``monitor`` takes a ``runtime.straggler.StragglerMonitor``: each
        root's wall time (search, host copy and, with ``validate``, the
        validation) is fed through ``monitor.observe(step, dt)``, so
        anomalously slow roots are recorded as its events, never raised
        here."""
        results = []
        for step, r in enumerate(roots):
            t0 = time.perf_counter()
            results.append(self.run(int(r), validate=validate))
            if monitor is not None:
                monitor.observe(step, time.perf_counter() - t0)
        return results


# ---------------------------------------------------------------------------
# Self-healing session: bounded cap_x replan-retry
# ---------------------------------------------------------------------------


@dataclass
class HealedRun:
    """Result of ``run_bfs_healed``: the final (healthy) session plus the
    structured escalation log, one entry per plan attempt, empty when the
    first plan was already overflow-free."""
    result: BFSResult
    engine: BFSEngine
    plan: BFSPlan
    retry_log: List[Dict[str, Any]]


def _overflow_levels_1ds(plan: BFSPlan, stats) -> List[int]:
    """Levels whose sparse exchange fell back to the dense bitmap.

    The "1ds" exchange never raises on bucket overflow: it reverts the
    level to the dense bitmap (parents stay exact, the wire jumps to the
    (p-1)*n/64 dense words).  An instrumented run records the measured
    wire per level (stats column 4), so a fallback shows on the host: a
    used top-down level whose wire matches the dense formula instead of
    the sparse or packed words its frontier size (column 0) predicts, in
    the JAX package's float32 closed forms.  The double check (== dense
    AND != sparse) keeps frontier sizes sitting exactly at the crossover,
    where both formulas agree and there is nothing to heal, out of the
    list."""
    part, cfg = plan.part, plan.cfg
    C = plan.statics.expand_chunks
    p = part.p
    stats = np.asarray(stats, dtype=np.float64)
    n_f = stats[:, 0]
    if cfg.frontier_codec == "packed":
        bits = comm_model.codec_bits(part.chunk // C)
        exp = np.array([comm_model.compressed_expand_1d_words(
            f, p, bits, C) for f in n_f])
    else:
        exp = np.array([comm_model.sparse_expand_1d_words(f, p)
                        for f in n_f])
    dense = comm_model.chunked_expand_1d_level_words(part.n, p, C) \
        if C > 1 else comm_model.expand_1d_level_words(part.n, p)
    exp32 = np.float32(exp).astype(np.float64)
    dense32 = float(np.float32(dense))
    wire = stats[:, 4]
    over = ((stats[:, 3] > 0) & (stats[:, 2] == 0)
            & np.isclose(wire, dense32, rtol=1e-4)
            & ~np.isclose(wire, exp32, rtol=1e-4))
    return [int(i) for i in np.nonzero(over)[0]]


def run_bfs_healed(graph, cfg: BFSConfig, mesh, root: int, *,
                   max_attempts: int = 3, store=None,
                   exec_key: str = "healed", validate: bool = False,
                   **plan_kw) -> HealedRun:
    """Plan, compile and run with a bounded ``cap_x`` replan-retry.

    For "1ds" an undersized bucket capacity corrupts nothing (overflowing
    levels revert to the dense bitmap) but forfeits the wire savings the
    sparse exchange exists for.  This function detects the fallback from an
    instrumented probe run, escalates ``cap_x`` geometrically (x2 per
    attempt, clamped to the chunk, where overflow is impossible),
    replans and retries, at most ``max_attempts`` plan attempts.  Parents
    are bit-identical across the attempts (fallback levels are exact);
    the history lands in ``HealedRun.retry_log``, and running out of
    attempts raises ``CapacityOverflow`` carrying all of it.  When the
    caller asked for the uninstrumented program, it is rebuilt at the
    healthy cap.  Other decompositions have no cap_x: one attempt, an
    empty log.

    ``plan_kw`` goes to ``plan_bfs`` (``local_mode``, ``cap_f``,
    ``cap_x``: the first attempt's cap, planned from the graph when 0).
    ``store`` and ``exec_key`` go to ``BFSPlan.compile``, each attempt's
    key tagged with its cap (``"<exec_key>-x<cap_x>"``) as in the JAX
    package.
    """
    from repro_torch.runtime.retry import CapacityOverflow, RetryAttempt

    if cfg.decomposition != "1ds":
        plan = plan_bfs(graph, cfg, mesh, **plan_kw)
        engine = plan.compile(store=store, exec_key=exec_key)
        return HealedRun(result=engine.run(root, validate=validate),
                         engine=engine, plan=plan, retry_log=[])

    probe_cfg = cfg if cfg.instrument else replace(cfg, instrument=True)
    history = []
    cap_x = int(plan_kw.pop("cap_x", 0))
    part = graph.part
    for attempt in range(1, max_attempts + 1):
        plan = plan_bfs(graph, probe_cfg, mesh, cap_x=cap_x, **plan_kw)
        cap_now = plan.statics.cap_x
        engine = plan.compile(store=store,
                              exec_key=f"{exec_key}-x{cap_now}")
        res = engine.run(root, validate=validate)
        levels = _overflow_levels_1ds(plan, res.level_stats)
        if not levels:
            history.append(RetryAttempt(
                attempt=attempt, cap_name="cap_x", cap_value=cap_now,
                outcome="ok", detail={}))
            if probe_cfg is not cfg:
                # the caller wanted the fast program: rebuild it at the
                # healthy cap (parents bit-identical by construction)
                plan = plan_bfs(graph, cfg, mesh, cap_x=cap_now, **plan_kw)
                engine = plan.compile(store=store,
                                      exec_key=f"{exec_key}-x{cap_now}")
                res = engine.run(root, validate=validate)
            log = [a.to_json() for a in history]
            # drop the no-op log when the FIRST plan was already clean
            if len(log) == 1 and log[0]["outcome"] == "ok":
                log = []
            return HealedRun(result=res, engine=engine, plan=plan,
                             retry_log=log)
        history.append(RetryAttempt(
            attempt=attempt, cap_name="cap_x", cap_value=cap_now,
            outcome="overflow", detail={"levels": levels}))
        nxt = min(cap_now * 2, part.chunk)
        if nxt <= cap_now:
            break
        cap_x = nxt
    raise CapacityOverflow(
        f"cap_x escalation exhausted after {len(history)} attempts "
        f"(levels still falling back to the dense bitmap)",
        cap_name="cap_x", cap_value=cap_now, history=history)
