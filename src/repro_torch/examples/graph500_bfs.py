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
the device).

``--born`` builds the graph on the device shard by shard
(``graph/dist_build.py``: the counter stream a shard, owner routing,
shard-local dedup); no edge list exists, so the roots come from the
degree vector and tree validation is skipped, as in the JAX driver.
``--store DIR`` persists the born graph to a ``GraphStore`` and loads it
back on the next identical run (the port keeps no compiled program
there: its sessions build in seconds):

    ... -m repro_torch.examples.graph500_bfs --scale 20 --born --store DIR
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.graph_store import GraphStore
from repro_torch.configs.base import BFSConfig
from repro_torch.core import comm_model
from repro_torch.core.engine import plan_bfs, sync_device
from repro_torch.core.metrics import harmonic_mean, teps
from repro_torch.core.ref import TreeValidator, validate_parents
from repro_torch.graph.dist_build import BuildSpec, dist_build
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import random_source, rmat_graph
from repro_torch.launch.mesh import (make_local_mesh, make_local_mesh_1d,
                                     resolve_device)


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
                    help="device-side distributed build (graph/"
                         "dist_build): no host edge list, validation "
                         "skipped")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="GraphStore directory: persist the born graph; "
                         "identical reruns reload it from disk")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    pr, pc = map(int, args.grid.split("x"))
    dev = resolve_device(args.device)
    strips = args.decomposition in ("1d", "1ds")
    mesh = make_local_mesh_1d(pr * pc, device=dev) if strips \
        else make_local_mesh(pr, pc, device=dev)

    store = None
    if args.store:
        store = GraphStore(args.store, device=dev)

    edges = None
    if args.born:
        spec = BuildSpec(scale=args.scale, edge_factor=16, seed=1)
        name = f"s{args.scale}-{args.decomposition}"
        graph = None
        if store is not None:
            try:                       # identical rerun: reload from disk
                t0 = time.perf_counter()
                graph = store.load_graph(name, mesh=mesh, expect_spec=spec)
                print(f"store load: {time.perf_counter() - t0:.3f}s "
                      f"(graph shards from {args.store})")
            except FileNotFoundError:
                pass
        if graph is None:
            graph, info = dist_build(spec, args.decomposition, mesh,
                                     (pr, pc))
            print(f"born-sharded build: {info['build_s']:.3f}s "
                  f"({info['build_teps']:.3e} edges/s input rate; "
                  f"m={info['m']}, no host edge materialization)")
            if store is not None:
                t0 = time.perf_counter()
                store.save_graph(name, graph, spec=spec)
                print(f"store save: {time.perf_counter() - t0:.3f}s -> "
                      f"{args.store}")
    else:
        edges = rmat_graph(args.scale, 16, seed=1, device=dev)
        if strips:
            graph = build_blocked_1d(
                edges, pr * pc, align=32,
                with_col_ptr=(args.local_mode == "kernel"
                              and args.storage == "csr"))
        else:
            graph = build_blocked(edges, pr, pc, align=32)
    cfg = BFSConfig(decomposition=args.decomposition, storage=args.storage,
                    direction_optimizing=not args.no_diropt,
                    instrument=not args.fast)
    rng = np.random.default_rng(0)

    # plan + compile once; every root below is pure traversal (the §7
    # methodology: harmonic-mean TEPS must not be smeared by compilation)
    engine = plan_bfs(graph, cfg, mesh,
                      local_mode=args.local_mode).compile(store=store)
    engine.search(0)
    sync_device(dev)                           # untimed first-call warm-up
    print(f"compile: {engine.compile_s:.3f}s (kernels built, one warm-up "
          f"search), graph ship: {engine.ship_s:.3f}s (paid once, reused "
          f"for {args.roots} roots)")

    # born graphs have no edge list: draw the roots from the degree
    # vector instead of random_source(edges)
    if edges is None:
        deg_global = np.flatnonzero(graph.deg_A.reshape(-1).cpu().numpy()
                                    > 0)
    else:
        trees = Trees(edges)
    rates, res = [], None
    for _ in range(args.roots):
        root = int(rng.choice(deg_global)) if edges is None \
            else random_source(edges, rng)
        # time the device search only; the result's host copy and the
        # validation stay outside the timed region
        t0 = time.perf_counter()
        out = engine.search(root)
        sync_device(dev)
        dt = time.perf_counter() - t0
        res = engine.to_result(out)
        if edges is not None:
            ok, msg = trees.check(root, out[0])
            if not ok:
                raise SystemExit(f"root {root}: invalid BFS tree: {msg}")
            valid = "valid"
        else:
            valid = "validation skipped (born-sharded: no host edges)"
        rates.append(teps(graph.m_input, dt))
        print(f"root {root:>8}: {res.n_levels} levels, {dt*1e3:8.2f} ms, "
              f"{rates[-1]:.3e} TEPS, {valid}")
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
