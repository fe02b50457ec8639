"""The Graph500 driver (the paper's §7 methodology) on one card: R-MAT,
the distributed graph built and the search compiled ONCE (plan ->
compile -> run, ``core/engine.py``), BFS from 16 random roots, the
harmonic-mean TEPS over the per-root traversal time alone (compile and
ship reported apart), every tree validated, and the measured
communication volume beside the §6 model.  The JAX package's
``examples/graph500_bfs.py``, flag for flag.

    PYTHONPATH=src python -m repro_torch.examples.graph500_bfs --scale 20 --local-mode kernel
    PYTHONPATH=src python -m repro_torch.examples.graph500_bfs --scale 11 --device cpu

``--grid PRxPC`` is a simulated mesh on the one device
(``launch/mesh.py``).  ``--decomposition 1d``/``1ds`` runs the 1D row
strips on p = pr*pc strips of the same graph; ``--local-mode kernel
--storage dcsc`` the kernel entries over compressed pointers.  Trees are
validated on the host with ``core/ref.py::validate_parents`` on the CPU,
and on the card with ``core/ref.py::TreeValidator`` (the same checks on
the device).  ``--born`` and ``--store`` (the born-sharded build and the
graph store) are not ported yet and are refused by name.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import comm_model
from repro_torch.core.engine import plan_bfs, sync_device
from repro_torch.core.metrics import harmonic_mean, teps
from repro_torch.core.ref import TreeValidator, validate_parents
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import random_source, rmat_graph
from repro_torch.launch.mesh import (make_local_mesh, make_local_mesh_1d,
                                     resolve_device)

NOT_PORTED = ("not ported yet: it waits for the born-sharded build and "
              "store (ROADMAP queue 1, \"Born-sharded build and store\")")


class Trees:
    """Validates BFS trees of ``edges``: on the host for a CPU graph, on
    the card (``TreeValidator``, keys sorted once) for a CUDA one."""

    def __init__(self, edges):
        self.edges = edges
        self.on_card = edges.src.device.type == "cuda"
        if self.on_card:
            self.tv = TreeValidator(edges.n, edges.src, edges.dst)
        else:
            self.src = edges.src.numpy()
            self.dst = edges.dst.numpy()

    def check(self, root: int, pi: torch.Tensor):
        """``pi``: the search's parents in the grid layout, on its
        device."""
        parents = pi.reshape(-1)[: self.edges.n]
        if self.on_card:
            return self.tv.check(root, parents)
        return validate_parents(self.edges.n, self.src, self.dst, root,
                                parents.numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--grid", default="1x1")
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--no-diropt", action="store_true")
    ap.add_argument("--decomposition", choices=("1d", "1ds", "2d"),
                    default="2d")
    ap.add_argument("--local-mode", choices=("dense", "kernel"),
                    default="dense")
    ap.add_argument("--storage", choices=("csr", "dcsc"), default="csr")
    ap.add_argument("--fast", action="store_true",
                    help="instrument=False: no counters or level stats, "
                         "one host read a level (TEPS runs; the "
                         "comm-volume report is skipped)")
    ap.add_argument("--born", action="store_true",
                    help="the born-sharded device build: " + NOT_PORTED)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="the graph store: " + NOT_PORTED)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    for flag, given in (("--born", args.born), ("--store", args.store)):
        if given:
            ap.error(f"{flag} is {NOT_PORTED}")
    pr, pc = map(int, args.grid.split("x"))
    dev = resolve_device(args.device)

    edges = rmat_graph(args.scale, 16, seed=1, device=dev)
    if args.decomposition in ("1d", "1ds"):
        graph = build_blocked_1d(
            edges, pr * pc, align=32,
            with_col_ptr=(args.local_mode == "kernel"
                          and args.storage == "csr"))
        mesh = make_local_mesh_1d(pr * pc, device=dev)
    else:
        graph = build_blocked(edges, pr, pc, align=32)
        mesh = make_local_mesh(pr, pc, device=dev)
    cfg = BFSConfig(decomposition=args.decomposition, storage=args.storage,
                    direction_optimizing=not args.no_diropt,
                    instrument=not args.fast)
    rng = np.random.default_rng(0)

    # plan + compile once; every root below is pure traversal (the §7
    # methodology: harmonic-mean TEPS must not be smeared by compilation)
    engine = plan_bfs(graph, cfg, mesh, local_mode=args.local_mode).compile()
    engine.search(0)
    sync_device(dev)                           # untimed first-call warm-up
    print(f"compile: {engine.compile_s:.3f}s (kernels built, one warm-up "
          f"search), graph ship: {engine.ship_s:.3f}s (paid once, reused "
          f"for {args.roots} roots)")

    trees = Trees(edges)
    rates, res = [], None
    for _ in range(args.roots):
        root = random_source(edges, rng)
        # time the device search only; the result's host copy and the
        # validation stay outside the timed region
        t0 = time.perf_counter()
        out = engine.search(root)
        sync_device(dev)
        dt = time.perf_counter() - t0
        res = engine.to_result(out)
        ok, msg = trees.check(root, out[0])
        if not ok:
            raise SystemExit(f"root {root}: invalid BFS tree: {msg}")
        rates.append(teps(graph.m_input, dt))
        print(f"root {root:>8}: {res.n_levels} levels, {dt*1e3:8.2f} ms, "
              f"{rates[-1]:.3e} TEPS, valid")
    print(f"\nharmonic-mean TEPS over {args.roots} roots "
          f"(traversal only): {harmonic_mean(rates):.3e}")
    if args.fast:
        # an uninstrumented search has no counters: no comm-volume report
        return
    useful = sum(v for k, v in res.counters.items() if k.startswith('use_'))
    if args.decomposition in ("1d", "1ds"):
        wt = comm_model.topdown_1d_words(graph.m, pr * pc)
        we = comm_model.expand_1d_words(graph.part.n, pr * pc, res.n_levels)
        # "1d" must reproduce the dense closed form exactly; "1ds" ships
        # sparse ids, so the dense volume is its per-search upper bound
        rel = "vs model" if args.decomposition == "1d" \
            else "vs dense-bitmap bound"
        print(f"useful words (last search): {useful:.3e}  "
              f"({args.decomposition} top-down model w={wt:.3e}; "
              f"wire_expand measured {res.counters['wire_expand']:.3e} "
              f"{rel} {we:.3e})")
    else:
        wt = comm_model.topdown_words(graph.part.n, graph.m, pr, pc)
        print(f"useful words (last search): {useful:.3e}  "
              f"(pure top-down model w_t={wt:.3e})")


if __name__ == "__main__":
    main()
