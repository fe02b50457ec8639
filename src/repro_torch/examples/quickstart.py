"""Quickstart: direction-optimizing BFS on an R-MAT graph through the
plan -> compile -> run session (compile once, traverse many); the JAX
package's ``examples/quickstart.py`` on one card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--local-mode kernel`` (the default) runs the CUDA kernels on the card
and their plain versions on the CPU; ``dense`` runs the edge-parallel
oracle path, the JAX quickstart's default.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import BFSConfig
from repro_torch.core.engine import plan_bfs, sync_device
from repro_torch.core.metrics import teps
from repro_torch.examples.graph500_bfs import Trees
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import random_source, rmat_graph
from repro_torch.launch.mesh import make_local_mesh, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-mode", choices=("dense", "kernel"),
                    default="kernel")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    edges = rmat_graph(scale=12, edge_factor=16, seed=1, device=dev)
    print(f"R-MAT scale 12: n={edges.n} m={edges.m} (Graph500 params)")
    graph = build_blocked(edges, pr=1, pc=1, align=32)
    mesh = make_local_mesh(1, 1, device=dev)
    cfg = BFSConfig(direction_optimizing=True, storage="dcsc")
    root = random_source(edges, np.random.default_rng(0))

    engine = plan_bfs(graph, cfg, mesh,
                      local_mode=args.local_mode).compile()  # ship + build, once
    t0 = time.perf_counter()
    out = engine.search(root)                       # device search only
    sync_device(dev)
    dt = time.perf_counter() - t0
    res = engine.to_result(out)
    ok, msg = Trees(edges).check(root, out[0])
    print(f"BFS from {root}: {res.n_levels} levels, valid tree: {ok}")
    print(f"compile {engine.compile_s:.3f}s (once); "
          f"TEPS (traversal): {teps(edges.m_input, dt):.3e}")
    modes = res.level_stats[: res.n_levels, 2]
    print(f"direction schedule (0=top-down, 1=bottom-up): {modes}")
    useful = sum(v for k, v in res.counters.items() if k.startswith('use_'))
    print(f"useful communication words: {useful:.3e}")
    if not ok:
        raise SystemExit(f"invalid BFS tree: {msg}")


if __name__ == "__main__":
    main()
