"""Subprocess entry: the port's simulated-mesh sessions on 2x2 and 4x4
grids against the JAX package's ``local_mode="dense"`` sessions on 16
forced host devices, plus ``expand_bitmap`` on those grids and the 2D
SpMM (``core/spmm.py::spmm_2d``) on the 4x4 and 2x8 grids.

Run as:  python tests/_torch_dist_main.py
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import BFSConfig as RConfig  # noqa: E402
from repro.core import frontier as rf  # noqa: E402
from repro.core.compat import shard_map  # noqa: E402
from repro.core.engine import plan_bfs as r_plan_bfs  # noqa: E402
from repro.core.spmm import spmm_2d as r_spmm_2d  # noqa: E402
from repro.core.partition import make_partition as r_make_partition  # noqa: E402,E501
from repro.graph.formats import build_blocked as r_build_blocked  # noqa: E402
from repro.graph.rmat import rmat_graph as r_rmat_graph  # noqa: E402
from repro.launch.mesh import make_local_mesh as r_mesh  # noqa: E402
from repro_torch.configs.base import BFSConfig  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core import frontier as tf  # noqa: E402
from repro_torch.core.engine import plan_bfs  # noqa: E402
from repro_torch.core.partition import make_partition  # noqa: E402
from repro_torch.core.spmm import spmm_2d  # noqa: E402
from repro_torch.graph.formats import build_blocked  # noqa: E402
from repro_torch.graph.rmat import rmat_graph  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402


def same_result(want, got, local_mode, tag):
    """Parents, n_levels, level_stats and counters equal.  A kernel
    session examines only the frontier's edges, so its top-down
    edges_examined is the frontier edge mass: its total equals the dense
    session's edges_useful."""
    assert np.array_equal(want.parents, got.parents), tag
    assert want.n_levels == got.n_levels, tag
    assert np.array_equal(want.level_stats, got.level_stats), tag
    assert set(want.counters) == set(got.counters), tag
    for k, v in want.counters.items():
        if local_mode == "kernel" and k == "edges_examined":
            v = want.counters["edges_useful"]
        assert got.counters[k] == v, (tag, k, v, got.counters[k])


def check_expand(pr, pc, rng):
    tpart = make_partition(1000, pr, pc, align=32)
    front = rng.random(tpart.n) < 0.3
    P = jax.sharding.PartitionSpec
    perm = r_make_partition(1000, pr, pc, align=32).transpose_perm()

    def body(f):
        w, wire = rf.expand_bitmap(f.reshape(-1), perm, ("data", "model"))
        return w[None, None], wire

    fn = shard_map(body, mesh=r_mesh(pr, pc), in_specs=(P("data", "model"),),
                   out_specs=(P("data", "model"), P()), check_vma=False)
    w_ref, wire_ref = fn(jnp.asarray(front.reshape(pr, pc, -1)))
    w, wire = tf.expand_bitmap(
        tf.pack_bits(torch.from_numpy(front.reshape(pr, pc, -1))),
        collectives.perm_index(tpart.transpose_perm(), "cpu"))
    assert np.array_equal(w.numpy().view(np.uint32), np.asarray(w_ref)), \
        (pr, pc)
    assert wire == np.float32(wire_ref), (pr, pc)


def check_spmm(grids):
    """The port's spmm_2d against the JAX package's on the same graph
    (scale 10, edge factor 8, seed 11, as ``_dist_spmm_main.py``), within
    1e-5 of the largest output plus 1e-6."""
    r_edges = r_rmat_graph(10, 8, seed=11)
    t_edges = rmat_graph(10, 8, seed=11, device="cpu")
    x = np.random.default_rng(0).normal(size=(r_edges.n, 8)).astype(
        np.float32)
    for pr, pc in grids:
        want = np.asarray(r_spmm_2d(r_build_blocked(r_edges, pr, pc, align=32,
                                                    cap_pad=32),
                                    x, r_mesh(pr, pc)))
        got = spmm_2d(build_blocked(t_edges, pr, pc, align=32, cap_pad=32),
                      torch.from_numpy(x)).numpy()
        tol = 1e-5 * np.abs(want).max() + 1e-6
        assert np.abs(got - want).max() <= tol, (pr, pc)
        print(f"spmm {pr}x{pc} == reference")


def main():
    rng = np.random.default_rng(0)
    for grid in ((2, 2), (4, 4)):
        check_expand(*grid, rng)
    check_spmm(((4, 4), (2, 8)))
    r_edges = r_rmat_graph(10, 8, seed=3)
    t_edges = rmat_graph(10, 8, seed=3, device="cpu")
    deg = r_edges.out_degrees()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 40, 200]]]
    cases = [((2, 2), "reduce", True), ((2, 2), "reduce", False),
             ((2, 2), "alltoall", True), ((2, 2), "alltoall", False),
             ((4, 4), "reduce", True), ((4, 4), "alltoall", False)]
    for (pr, pc), fold, diro in cases:
        g_r = r_build_blocked(r_edges, pr, pc, align=32, cap_pad=32)
        g_t = build_blocked(t_edges, pr, pc, align=32, cap_pad=32)
        ref = r_plan_bfs(g_r, RConfig(fold_mode=fold,
                                      direction_optimizing=diro),
                         r_mesh(pr, pc), local_mode="dense").compile()
        cfg = BFSConfig(fold_mode=fold, direction_optimizing=diro)
        mesh = make_local_mesh(pr, pc, device="cpu")
        for local_mode in ("dense", "kernel"):
            eng = plan_bfs(g_t, cfg, mesh, local_mode=local_mode).compile()
            for root in roots:
                same_result(ref.run(root), eng.run(root), local_mode,
                            (pr, pc, fold, diro, local_mode, root))
    print("OK torch-dist")


if __name__ == "__main__":
    main()
