"""The 2D checkerboard off the 1x1 grid, against the benchmark's plain
reference (``bench/reference.py``) on ``g500-kron-s24``'s generator cut
to scale 10, from 8 of its search keys (``bench/graphs.py``).

Top-down only, every grid and storage gives the least-id parents the
configurations guarantee.  Direction-optimizing with pc > 1, a
bottom-up level keeps the first find in the order the completed bitmap
rotates around the processor row (the paper's Algorithm 4), so the tree
is a valid one (the reference's reached set and depths, every parent a
neighbour one level up) but not always the least-id one; at pc == 1
the rotation has one member and the parents are the least-id ones."""
import json
from pathlib import Path

import pytest
import torch

from bench import graphs, reference
from repro_torch.configs.base import BFSConfig
from repro_torch.core import trace
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import preprocess
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

SCALE = 10
N = 1 << SCALE
ROOTS = 8

# (grid, storage, direction-optimizing): top-down on two grids in both
# storages, direction-optimizing on 4x4 (the rotation's tree) and at
# pc == 1 (the least-id tree)
CASES = [((4, 4), "dcsc", False), ((4, 4), "csr", False),
         ((2, 4), "dcsc", False), ((2, 4), "csr", False),
         ((4, 4), "dcsc", True), ((4, 4), "csr", True),
         ((4, 1), "dcsc", True), ((1, 1), "csr", True)]


@pytest.fixture(scope="module")
def instance():
    """The raw pairs, the reference's graph, the keys and each key's
    reference parents and depths."""
    cfg = json.loads((REPO / "bench/configs/g500-kron-s24.json").read_text())
    cfg["scale"] = SCALE
    src, dst = graphs.edges(cfg, "cpu")
    keys = graphs.search_keys(src, dst, N, ROOTS, cfg["instance_seed"])
    rs, rd = reference.build(src, dst)
    want = {r: (reference.parents(N, rs, rd, r), reference.levels(N, rs, rd, r))
            for r in keys}
    edge_keys = torch.unique(rs.to(torch.int64) * N + rd)
    return src, dst, keys, want, edge_keys


@pytest.fixture(scope="module")
def graphs_by_grid(instance):
    src, dst = instance[:2]
    edges = preprocess(src.clone(), dst.clone(), N)
    return {grid: build_blocked(edges, *grid, align=32)
            for grid in sorted({c[0] for c in CASES})}


@pytest.mark.parametrize("grid,storage,do", CASES,
                         ids=[f"{g[0]}x{g[1]}-{s}-{'do' if d else 'td'}"
                              for g, s, d in CASES])
def test_grid_search_against_the_plain_reference(instance, graphs_by_grid,
                                                 grid, storage, do):
    _, _, keys, want, edge_keys = instance
    engine = plan_bfs(graphs_by_grid[grid],
                      BFSConfig(decomposition="2d", storage=storage,
                                fold_mode="reduce", alpha=14.0, beta=24.0,
                                direction_optimizing=do, instrument=False),
                      make_local_mesh(*grid, device="cpu"),
                      local_mode="kernel").compile()
    exact = not do or grid[1] == 1
    with trace.Recorder() as rec:
        outs = [engine.search(root) for root in keys]
    bu_levels = sum(c.get("bu_levels", 0) for c in rec.counters.values())
    # the direction-optimizing searches do run bottom-up levels
    assert (bu_levels > 0) == do
    for root, out in zip(keys, outs):
        par = out[0].reshape(-1)[:N].to(torch.int32)
        least, depth = want[root]
        if exact:
            assert reference.wrong_parents(par, least) == 0, root
            continue
        reached = depth >= 0
        assert torch.equal(par >= 0, reached), root
        assert int(par[root]) == root
        child = torch.nonzero(reached).reshape(-1)
        child = child[child != root]
        p = par[child].to(torch.int64)
        # every parent one level up from its child, and a neighbour
        assert torch.equal(depth[p], depth[child] - 1), root
        assert torch.isin(p * N + child, edge_keys).all(), root
