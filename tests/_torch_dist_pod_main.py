"""Subprocess entry: the port's pod-batched searches
(``BFSEngine.run_batch``) against the JAX package's on 16 forced host
devices, on the graph of the reference's ``multipod`` mode (R-MAT scale
10, edge factor 8, seed 9, ``cap_pad=32``): 2 pods x 2x2
("2d") and 2 pods x 4 strips ("1d", "1ds"), 4 roots a pod
instrumented and 2 with ``instrument=False``.  The reference runs
``local_mode="dense"``; the port runs "dense" and "kernel" (the plain
versions on the CPU).  Roots, parents, n_levels and the whole
``(n_roots, 64, 5)`` level_stats must agree bit for bit, the lockstep
rows of ended searches included.  Also the ``make_multiroot_bfs_fn``
wrappers of both packages on the 2D pod mesh, ``pis`` in the
``(pr, pc, n_roots, chunk)`` layout.

Run as:  python tests/_torch_dist_pod_main.py
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist-pod`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import BFSConfig as RConfig  # noqa: E402
from repro.core.bfs import make_multiroot_bfs_fn as r_multiroot  # noqa: E402
from repro.core.engine import plan_bfs as r_plan_bfs  # noqa: E402
from repro.graph.formats import build_blocked as r_build_2d  # noqa: E402
from repro.graph.formats import build_blocked_1d as r_build_1d  # noqa: E402
from repro.graph.rmat import rmat_graph as r_rmat_graph  # noqa: E402
from repro.launch.mesh import make_local_mesh as r_mesh  # noqa: E402
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d  # noqa: E402
from repro_torch.configs.base import BFSConfig  # noqa: E402
from repro_torch.core.bfs import make_multiroot_bfs_fn  # noqa: E402
from repro_torch.core.engine import plan_bfs  # noqa: E402
from repro_torch.graph.formats import build_blocked, build_blocked_1d  # noqa: E402,E501
from repro_torch.graph.rmat import rmat_graph  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d  # noqa: E402,E501

PODS = 2
# (decomposition, storage, grid): the 1D grids are 4 strips
CASES = [("2d", "csr", (2, 2)), ("1d", "csr", (4,)), ("1ds", "dcsc", (4,))]
# roots a pod by instrument: each decomposition runs 4 a pod instrumented
# (the lockstep rows show in the stats) and 2 uninstrumented, so each
# reference program is compiled once
RPP = {True: 4, False: 2}


def same_batch(want, got, tag):
    assert np.array_equal(want.roots, got.roots), tag
    assert got.parents.dtype == np.int64 and got.n_levels.dtype == np.int64
    assert np.array_equal(want.parents, got.parents), tag
    assert np.array_equal(want.n_levels, got.n_levels), (
        tag, want.n_levels, got.n_levels)
    assert got.level_stats.shape == want.level_stats.shape, tag
    assert np.array_equal(want.level_stats, got.level_stats), tag


def check_multiroot_fn(r_edges, t_edges, roots):
    """Both packages' ``make_multiroot_bfs_fn`` on 2 pods x 2x2."""
    g_r = r_build_2d(r_edges, 2, 2, align=32, cap_pad=32)
    g_t = build_blocked(t_edges, 2, 2, align=32, cap_pad=32)
    mesh_r = r_mesh(2, 2, pods=PODS)
    fn_r, keys_r = r_multiroot(mesh_r, g_r.part, RConfig(), g_r.cap_seg,
                               n_roots=PODS, maxdeg=g_r.maxdeg_col)
    arrs = g_r.device_arrays()
    sh = NamedSharding(mesh_r, P("data", "model"))
    gdev = {k: jax.device_put(np.asarray(arrs[k]), sh) for k in keys_r}
    r_pis, r_levels, r_stats = fn_r(gdev, jax.device_put(
        roots, NamedSharding(mesh_r, P("pod"))))
    for local_mode in ("dense", "kernel"):
        fn, keys = make_multiroot_bfs_fn(
            make_local_mesh(2, 2, device="cpu", pods=PODS), g_t.part,
            BFSConfig(), g_t.cap_seg, n_roots=PODS, maxdeg=g_t.maxdeg_col,
            local_mode=local_mode)
        arrays = g_t.device_arrays()
        pis, levels, stats = fn({k: arrays[k] for k in keys}, roots)
        assert tuple(pis.shape) == np.asarray(r_pis).shape, pis.shape
        assert np.array_equal(pis.numpy(), np.asarray(r_pis)), local_mode
        assert np.array_equal(levels, np.asarray(r_levels)), local_mode
        assert np.array_equal(stats, np.asarray(r_stats)), local_mode


def main():
    r_edges = r_rmat_graph(10, 8, seed=9)
    t_edges = rmat_graph(10, 8, seed=9, device="cpu")
    deg = r_edges.out_degrees()
    # the reference's multiroot draw: searches of 4 to 6 levels, so some
    # pods run lockstep levels on an empty frontier, and the 2D batch
    # takes modes its single-root runs do not
    roots = np.random.default_rng(0).choice(
        np.flatnonzero(deg > 0), size=8, replace=False).astype(np.int32)
    n_lockstep = 0
    for dec, storage, grid in CASES:
        if dec == "2d":
            g_r = r_build_2d(r_edges, *grid, align=32, cap_pad=32)
            g_t = build_blocked(t_edges, *grid, align=32, cap_pad=32)
            mesh_r = r_mesh(*grid, pods=PODS)
            mesh_t = make_local_mesh(*grid, device="cpu", pods=PODS)
        else:
            g_r = r_build_1d(r_edges, grid[0], align=32, cap_pad=32)
            g_t = build_blocked_1d(t_edges, grid[0], align=32, cap_pad=32,
                                   with_col_ptr=True)
            mesh_r = r_mesh_1d(grid[0], pods=PODS)
            mesh_t = make_local_mesh_1d(grid[0], device="cpu", pods=PODS)
        for instrument in (True, False):
            kw = dict(decomposition=dec, storage=storage,
                      instrument=instrument)
            ref = r_plan_bfs(g_r, RConfig(**kw), mesh_r,
                             local_mode="dense").compile()
            engines = [plan_bfs(g_t, BFSConfig(**kw), mesh_t,
                                local_mode=m).compile()
                       for m in ("dense", "kernel")]
            rpp = RPP[instrument]
            batch = roots[: PODS * rpp]
            want = ref.run_batch(batch)
            if instrument:
                n_lockstep += int((want.level_stats[:, :, 3] == 1).sum()
                                  - (want.level_stats[:, :, 0] > 0).sum())
            for eng, m in zip(engines, ("dense", "kernel")):
                same_batch(want, eng.run_batch(batch),
                           (dec, instrument, rpp, m))
            assert all((e.ship_count, e.trace_count) == (1, 2)
                       for e in engines)
    assert n_lockstep > 0, "no search ran a lockstep level on an empty frontier"
    check_multiroot_fn(r_edges, t_edges, roots[:PODS])
    print(f"OK torch-dist-pod ({n_lockstep} lockstep rows)")


if __name__ == "__main__":
    main()
