"""Dry-run of every (architecture x input shape x mesh) cell on PyTorch's
``meta`` device: each cell's step is traced once, allocating nothing, on
the simulated production mesh (16 x 16, and 2 x 16 x 16 with "pod"),
and counted as it is issued: FLOPs by dtype class, bytes read and
written and the peak of live bytes (``roofline.StepCounter``), and the
mesh's collectives with their per-device bytes (``ScheduleRecorder``).
The roofline terms use the H100's figures (``launch/roofline.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cells smollm-135m/prefill_32k
Results are cached per cell in results/dryrun_torch/<cell>__<mesh>.json
(``--results DIR`` elsewhere), so the run is resumable.  ``--cells all``
is the 40 (arch x shape) cells, the three BFS scales and the JAX
package's eight hill-climb records (``cells.HILLCLIMB_CELLS``), each at
its own mesh; ``bfs`` the BFS scales alone.

A record has the JAX package's keys, counted rather than compiled:
``flops`` and ``bytes_accessed`` are the trace's over the mesh's devices
(the simulated mesh runs every shard on one device, so the trace is the
whole mesh's work, split evenly); ``memory`` holds per device the
arguments' bytes under the cell's specs, the outputs' (an output shaped
like an argument takes its spec, any other is split evenly) and the
temps: the trace's peak of live bytes beyond the outputs, split evenly
over the devices.  ``lower_s`` and ``compile_s`` are one ``trace_s``.
The port executes its loops, so the counts cover every layer and level
(no scan correction applies).  Single-pod BFS records carry
``level_step``, the level cell's record.  The whole search cannot be
traced on ``meta`` (its level loop reads the host): a whole-search
record runs the cell's graph-less plan checks and holds its arguments'
bytes, and its counts are one top-down plus one bottom-up body, the
level cell's trace on the 16 x 16 grid (per device the same on the
multi-pod mesh, where each pod searches its own root), traced once per
(arch, shape) in a process.  ``--jobs N`` traces the cells in N worker
processes (a BFS arch's cells in one, sharing its trace).
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.collectives import ScheduleRecorder
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (StepCounter,
                                         collective_bytes_from_records,
                                         roofline_report)

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _spec_pairs(args, specs) -> List[Tuple[torch.Tensor, tuple]]:
    if isinstance(args, torch.Tensor):
        return [(args, specs or ())]
    if isinstance(args, dict):
        return [x for k, v in args.items()
                for x in _spec_pairs(v, (specs or {}).get(k))]
    if isinstance(args, (tuple, list)):
        specs = specs if specs is not None else (None,) * len(args)
        return [x for a, s in zip(args, specs) for x in _spec_pairs(a, s)]
    return []


def output_bytes(out, cell, mesh) -> Tuple[int, int]:
    """(bytes of the outputs, per-device bytes): an output shaped like an
    argument takes that argument's spec, any other splits evenly."""
    shapes = {(tuple(t.shape), t.dtype): s
              for t, s in _spec_pairs(cell.args, cell.specs)}
    total = per_dev = 0
    for t in _leaves(out):
        n = t.numel() * t.element_size()
        total += n
        spec = shapes.get((tuple(t.shape), t.dtype))
        per_dev += (cells_mod.per_device_bytes(t, spec, mesh)
                    if spec is not None else n // mesh.size)
    return total, per_dev


def count_cell(cell, mesh) -> Dict:
    """Trace ``cell``'s step once under a counter and a schedule recorder:
    the per-device counts of a record (without its roofline)."""
    n_dev = mesh.size
    t0 = time.time()
    with ScheduleRecorder() as rec, StepCounter() as c:
        out = cell.fn(*cell.args)
        out_total, out_dev = output_bytes(out, cell, mesh)
        peak = c.peak_bytes
        del out
    trace_s = time.time() - t0
    return {
        "n_devices": n_dev,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_size_in_bytes": cells_mod.per_device_bytes(
                cell.args, cell.specs, mesh),
            "output_size_in_bytes": out_dev,
            "temp_size_in_bytes": max(peak - out_total, 0) // n_dev},
        "flops": c.total_flops / n_dev,
        "flops_by_class": {k: v / n_dev for k, v in c.flops.items()},
        "bytes_accessed": c.bytes_accessed / n_dev,
        "peak_bytes": peak,
        "kernels": c.summary()["kernels"],
        "collectives": collective_bytes_from_records(rec.records),
    }


@functools.lru_cache(maxsize=None)
def _level_counts(arch: str, shape: str) -> Dict:
    """The single-pod level cell's counts (traced once a process)."""
    mesh = make_production_mesh(device="meta")
    return count_cell(cells_mod.build_cell(arch, shape, mesh,
                                           level_only=True), mesh)


def run_cell(arch: str, shape: str, multi_pod: bool,
             level_only: bool = False) -> Dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    kw = {"level_only": True} if level_only else {}
    cell = cells_mod.build_cell(arch, shape, mesh, **kw)
    if cell is None:
        return {"cell": f"{arch}/{shape}", "skipped": True,
                "reason": cells_mod.SKIP_REASON}
    if cell.meta.get("family") == "bfs":
        t0 = time.time()
        counts = dict(_level_counts(arch, shape), n_devices=mesh.size)
        counts["memory"] = dict(counts["memory"],
                                argument_size_in_bytes=(
                                    cells_mod.per_device_bytes(
                                        cell.args, cell.specs, mesh)))
        counts["trace_s"] = round(time.time() - t0, 2)
    else:
        counts = count_cell(cell, mesh)
    out = {"cell": cell.label, "mesh": "2x16x16" if multi_pod else "16x16",
           **counts, "meta": cell.meta}
    out["roofline"] = roofline_report(out)
    return out


def run_and_save(arch: str, shape: str, mp: bool, path: str) -> str:
    """Run one cell (a single-pod BFS cell with its level step), write its
    record to ``path``; the ``[ok]`` line."""
    out = run_cell(arch, shape, mp)
    if arch.startswith("bfs") and not mp:
        out["level_step"] = run_cell(arch, shape, mp, level_only=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    r = out.get("roofline", {})
    tag = os.path.basename(path)[:-5]
    return (f"[ok] {tag}: trace={out.get('trace_s')}s "
            f"flops={out.get('flops', 0):.3g} "
            f"coll={out.get('collectives', {}).get('total_bytes', 0):.3g}B "
            f"bound={r.get('dominant', 'skipped')}")


def _run_unit(unit) -> List[Tuple[str, Optional[str], str]]:
    """(tag, error or None, line) of each cell of one unit of work."""
    out = []
    for arch, shape, mp, path in unit:
        tag = os.path.basename(path)[:-5]
        try:
            out.append((tag, None, run_and_save(arch, shape, mp, path)))
        except Exception as e:
            out.append((tag, str(e), f"[FAIL] {tag}: {e}\n"
                        + traceback.format_exc(limit=6)))
    return out


def todo_for(spec: str, meshes) -> List[Tuple[str, str, bool]]:
    """(arch, shape, multi_pod) of every cell ``--cells``/``--mesh``
    name."""
    if spec in ("all", "bfs"):
        base = (cells_mod.all_cells() + cells_mod.bfs_cells()
                if spec == "all" else cells_mod.bfs_cells())
        out = [(a, s, mp) for a, s in base for mp in meshes]
        if spec == "all":
            out += [c for c in cells_mod.HILLCLIMB_CELLS if c[2] in meshes]
        return out
    return [(*c.split("/", 1), mp) for c in spec.split(",") for mp in meshes]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="all",
                    help="'all', 'bfs', or comma-sep arch/shape ids")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", default=RESULTS,
                    help="the directory of the per-cell records")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells at once")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.results, exist_ok=True)
    units: Dict[Tuple[str, str], list] = {}
    for arch, shape, mp in todo_for(args.cells, meshes):
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
        path = os.path.join(args.results, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {tag}")
            continue
        # a BFS arch's cells share one level trace: one unit of work
        key = (arch, shape) if arch.startswith("bfs") else (tag, "")
        units.setdefault(key, []).append((arch, shape, mp, path))
    # the BFS units first: they take longest
    work = sorted(units.values(), key=lambda u: not u[0][0].startswith("bfs"))
    if args.jobs > 1 and len(work) > 1:
        with multiprocessing.get_context("fork").Pool(args.jobs) as pool:
            results = [r for rs in pool.imap_unordered(_run_unit, work)
                       for r in rs]
            for tag, err, line in results:
                print(line, flush=True)
    else:
        results = []
        for unit in work:
            for r in _run_unit(unit):
                print(r[2], flush=True)
                results.append(r)
    failures = [(t, e) for t, e, _ in results if e is not None]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e.splitlines()[0][:200] if e else "")
        return 1
    print("\nDRY-RUN COMPLETE: all cells traced and counted.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
