"""The JAX package's one-shot BFS API (``core/bfs.py``), as thin
wrappers over the session API (``core/engine.py``).

The ``make_*_bfs_fn`` builders return ``(fn, keys)``: ``fn(graph_arrays,
root)`` (or ``(graph_arrays, roots)`` for the pod batch) over the
arrays named by ``keys``, and ``run_bfs`` plans, compiles and runs one
root (shipping the graph on every call: prefer ``plan_bfs(...).compile()``
for more than one root).

The signatures are the JAX package's.  A simulated mesh has no named
grid axes, so ``row_axis``/``col_axis``/``axis`` take only the
reference's defaults ("data", "model"); the pod axis is looked up in
``mesh.shape``.  ``maxdeg`` and ``n_real_edges`` are taken and ignored:
the port's LocalOps entries size their launches from the live frontier
and need neither.  The host copies the level arguments read (``seg_ptr``
for "2d", ``nnz`` for the strips) come from the ``graph_arrays`` that
``fn`` receives, at its first call with them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import BFSConfig
from repro_torch.core.decomp import MAX_LEVELS  # noqa: F401  (re-export)
from repro_torch.core.engine import (BFSBatchResult, BFSResult,  # noqa: F401
                                     _pod_count, plan_bfs, plan_for_part)
from repro_torch.core.partition import Partition1D, Partition2D

_ROW_AXIS, _COL_AXIS = "data", "model"


def _check_axes(**given) -> None:
    want = {"row_axis": _ROW_AXIS, "col_axis": _COL_AXIS, "axis": _ROW_AXIS}
    for name, value in given.items():
        if value != want[name]:
            raise ValueError(
                f"{name}={value!r}: a simulated mesh has no named grid "
                f"axes; only the default {want[name]!r} is taken")


def _on_arrays(plan, build):
    """``fn(graph_arrays, x)`` over ``build(plan, arrays)``: the program is
    built at the first call with a given arrays dict (moved to the mesh's
    device) and kept for later calls with the same dict."""
    built = {}

    def fn(graph_arrays, x):
        if built.get("arrays") is not graph_arrays:
            dev = plan.mesh.device
            built["fn"] = build({k: graph_arrays[k].to(dev)
                                 for k in plan.keys})
            built["arrays"] = graph_arrays
        return built["fn"](x)
    return fn


def make_bfs_fn_1d(mesh, part: Partition1D, cfg: BFSConfig,
                   axis: str = "data", local_mode: str = "dense",
                   maxdeg: int = 0, cap_f: int = 0, cap_x: int = 0):
    """The whole-search 1D BFS function: fn(graph_arrays, root) -> (pi
    (p, chunk), n_levels, counters, level_stats), and the keys it reads.
    A "2d" config runs as "1d"."""
    del maxdeg
    _check_axes(axis=axis)
    if cfg.decomposition not in ("1d", "1ds"):
        cfg = dataclasses.replace(cfg, decomposition="1d")
    plan = plan_for_part(part, cfg, mesh, local_mode=local_mode,
                         cap_f=cap_f, cap_x=cap_x)
    return _on_arrays(plan, plan.build_fn), plan.keys


def make_bfs_fn(mesh, part, cfg: BFSConfig, cap_seg: int = 0,
                row_axis: str = "data", col_axis: str = "model",
                local_mode: str = "dense", n_real_edges: float = 0.0,
                maxdeg: int = 0, cap_f: int = 0, cap_x: int = 0):
    """The whole-search BFS function of ``cfg.decomposition``:
    fn(graph_arrays, root) -> (pi in the grid layout, n_levels,
    counters, level_stats), and the keys it reads."""
    del n_real_edges, maxdeg
    _check_axes(row_axis=row_axis, col_axis=col_axis)
    plan = plan_for_part(part, cfg, mesh, local_mode=local_mode,
                         cap_seg=cap_seg, cap_f=cap_f, cap_x=cap_x)
    return _on_arrays(plan, plan.build_fn), plan.keys


def make_multiroot_bfs_fn(mesh, part: Partition2D, cfg: BFSConfig,
                          cap_seg: int, n_roots: int,
                          pod_axis: str = "pod", row_axis: str = "data",
                          col_axis: str = "model", maxdeg: int = 0,
                          local_mode: str = "dense", cap_f: int = 0,
                          cap_x: int = 0, n_real_edges: float = 0.0):
    """Independent roots spread over the pod axis, in any registered
    decomposition: fn(graph_arrays, roots) -> (pis ``(*grid, n_roots,
    chunk)``, n_levels (n_roots,), level_stats (n_roots, MAX_LEVELS,
    5)), and the keys it reads.  ``n_roots`` is documentation only, as
    in the JAX package: the roots given to ``fn`` fix the count.  Prefer
    ``BFSEngine.run_batch``."""
    del n_roots, maxdeg, n_real_edges
    _check_axes(row_axis=row_axis, col_axis=col_axis)
    plan = plan_for_part(part, cfg, mesh, local_mode=local_mode,
                         cap_seg=cap_seg, cap_f=cap_f, cap_x=cap_x)
    _pod_count(mesh, pod_axis)
    return (_on_arrays(plan, lambda arrays: plan.build_batch_fn(arrays,
                                                                pod_axis)),
            plan.keys)


def run_bfs(graph, root: int, cfg: BFSConfig, mesh,
            row_axis: str = "data", col_axis: str = "model",
            local_mode: str = "dense", cap_f: int = 0,
            cap_x: int = 0) -> BFSResult:
    """Plan, compile and run one root.  ``graph`` is a BlockedGraph
    ("2d") or a Blocked1DGraph ("1d", "1ds"), as ``cfg.decomposition``
    says; ``cap_x`` overrides the planned "1ds" bucket capacity."""
    _check_axes(row_axis=row_axis, col_axis=col_axis)
    plan = plan_bfs(graph, cfg, mesh, local_mode=local_mode, cap_f=cap_f,
                    cap_x=cap_x)
    return plan.compile().run(root)
