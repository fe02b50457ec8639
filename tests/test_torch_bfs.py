"""The port's ``core/bfs.py`` wrappers against the JAX package's: the
keys each ships for every registered ``(decomposition, local_mode,
storage)``, the parents of ``make_bfs_fn``/``make_bfs_fn_1d``'s ``fn``
on a one-device mesh, and ``run_bfs`` against the session it wraps."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs.base import BFSConfig as RConfig
from repro.core import bfs as r_bfs
from repro.graph.formats import build_blocked as r_build_2d
from repro.graph.formats import build_blocked_1d as r_build_1d
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.launch.mesh import make_local_mesh as r_mesh
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d
from repro_torch.configs.base import BFSConfig
from repro_torch.core import bfs, local_ops
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def graphs():
    r = r_rmat_graph(10, 8, seed=4)
    t = rmat_graph(10, 8, seed=4, device="cpu")
    deg = r.out_degrees()
    roots = [int(x) for x in np.flatnonzero(deg > 0)[[0, 17, 300]]]
    return {"2d": (r, r_build_2d(r, 1, 1, align=32, cap_pad=32),
                   t, build_blocked(t, 1, 1, align=32, cap_pad=32)),
            "1d": (r, r_build_1d(r, 1, align=32, cap_pad=32,
                                 with_col_ptr=True),
                   t, build_blocked_1d(t, 1, align=32, cap_pad=32,
                                       with_col_ptr=True)),
            "roots": roots}


@pytest.mark.parametrize("combo", local_ops.registered_combos())
def test_wrapper_keys_equal_reference(graphs, combo):
    """The counterpart of the reference's
    ``test_multiroot_routes_through_registry``: each wrapper ships the
    keys of the LocalOps entry its local_mode and storage pick."""
    dec, mode, storage = combo
    kind = "2d" if dec == "2d" else "1d"
    g_r, g_t = graphs[kind][1], graphs[kind][3]
    cfg = dict(decomposition=dec, storage=storage)
    kw = dict(local_mode=mode, cap_x=32)
    if kind == "2d":
        _, want = r_bfs.make_bfs_fn(r_mesh(1, 1), g_r.part, RConfig(**cfg),
                                    cap_seg=32, **kw)
        _, got = bfs.make_bfs_fn(make_local_mesh(1, 1, device="cpu"),
                                 g_t.part, BFSConfig(**cfg), cap_seg=32,
                                 **kw)
        pods_r, pods_t = r_mesh(1, 1, pods=1), make_local_mesh(
            1, 1, device="cpu", pods=1)
    else:
        _, want = r_bfs.make_bfs_fn_1d(r_mesh_1d(1), g_r.part,
                                       RConfig(**cfg), **kw)
        _, got = bfs.make_bfs_fn_1d(make_local_mesh_1d(1, device="cpu"),
                                    g_t.part, BFSConfig(**cfg), **kw)
        pods_r, pods_t = r_mesh_1d(1, pods=1), make_local_mesh_1d(
            1, device="cpu", pods=1)
    assert tuple(got) == tuple(want)
    _, want_m = r_bfs.make_multiroot_bfs_fn(pods_r, g_r.part, RConfig(**cfg),
                                            cap_seg=32, n_roots=1, **kw)
    _, got_m = bfs.make_multiroot_bfs_fn(pods_t, g_t.part, BFSConfig(**cfg),
                                         cap_seg=32, n_roots=1, **kw)
    assert tuple(got_m) == tuple(want_m)


@pytest.mark.parametrize("kind,dec", [("2d", "2d"), ("1d", "1d"),
                                      ("1d", "1ds")])
def test_fn_parents_equal_reference(graphs, kind, dec):
    """``fn(graph_arrays, root)`` of both packages on a one-device mesh:
    the same parents and level count, in dense and kernel mode (the
    reference in dense mode).  ``maxdeg`` and ``n_real_edges`` are taken
    and ignored; the level arguments come from the arrays at the first
    call."""
    r, g_r, t, g_t = graphs[kind]
    cfg = dict(decomposition=dec, storage="csr")
    if kind == "2d":
        mesh_r = r_mesh(1, 1)
        fn_r, keys_r = r_bfs.make_bfs_fn(mesh_r, g_r.part, RConfig(**cfg),
                                         cap_seg=g_r.cap_seg)
        spec = P("data", "model")
    else:
        mesh_r = r_mesh_1d(1)
        fn_r, keys_r = r_bfs.make_bfs_fn_1d(mesh_r, g_r.part,
                                            RConfig(**cfg), cap_x=32)
        spec = P("data")
    arrs = g_r.device_arrays()
    gdev = {k: jax.device_put(np.asarray(arrs[k]),
                              NamedSharding(mesh_r, spec)) for k in keys_r}
    for mode in ("dense", "kernel"):
        if kind == "2d":
            fn, keys = bfs.make_bfs_fn(
                make_local_mesh(1, 1, device="cpu"), g_t.part,
                BFSConfig(**cfg), cap_seg=g_t.cap_seg, local_mode=mode,
                maxdeg=g_t.maxdeg_col, n_real_edges=float(g_t.m))
        else:
            fn, keys = bfs.make_bfs_fn_1d(
                make_local_mesh_1d(1, device="cpu"), g_t.part,
                BFSConfig(**cfg), local_mode=mode, maxdeg=7, cap_x=32)
        arrays = g_t.device_arrays()
        gt = {k: arrays[k] for k in keys}
        for root in graphs["roots"]:
            pi_r, lvl_r, _, stats_r = fn_r(gdev, root)
            pi, lvl, _, stats = fn(gt, root)
            assert tuple(pi.shape) == np.asarray(pi_r).shape
            assert torch.equal(pi, torch.from_numpy(np.array(pi_r))), mode
            assert lvl == int(lvl_r)
            assert np.array_equal(stats, np.asarray(stats_r))


def test_make_bfs_fn_1d_runs_a_2d_config_as_1d(graphs):
    r, g_r, t, g_t = graphs["1d"]
    fn, keys = bfs.make_bfs_fn_1d(make_local_mesh_1d(1, device="cpu"),
                                  g_t.part, BFSConfig())
    arrays = g_t.device_arrays()
    root = graphs["roots"][0]
    got = fn({k: arrays[k] for k in keys}, root)
    want = plan_bfs(g_t, BFSConfig(decomposition="1d"), make_local_mesh_1d(
        1, device="cpu")).compile().search(root)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("kind,cfg", [
    ("2d", dict()), ("2d", dict(storage="dcsc", instrument=False)),
    ("1d", dict(decomposition="1ds", storage="dcsc"))])
def test_run_bfs_equals_the_session(graphs, kind, cfg):
    r, g_r, t, g_t = graphs[kind]
    mesh = make_local_mesh(1, 1, device="cpu") if kind == "2d" \
        else make_local_mesh_1d(1, device="cpu")
    for root in graphs["roots"]:
        got = bfs.run_bfs(g_t, root, BFSConfig(**cfg), mesh,
                          local_mode="kernel")
        want = plan_bfs(g_t, BFSConfig(**cfg), mesh,
                        local_mode="kernel").compile().run(root)
        assert np.array_equal(got.parents, want.parents)
        assert got.n_levels == want.n_levels
        assert got.counters == want.counters
        assert np.array_equal(got.level_stats, want.level_stats)


def test_wrappers_take_only_the_default_axis_names(graphs):
    t, g_t = graphs["2d"][2:]
    mesh = make_local_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="row_axis='rows'"):
        bfs.make_bfs_fn(mesh, g_t.part, BFSConfig(), cap_seg=32,
                        row_axis="rows")
    with pytest.raises(ValueError, match="col_axis='y'"):
        bfs.run_bfs(g_t, 0, BFSConfig(), mesh, col_axis="y")
    with pytest.raises(ValueError, match="axis='x'"):
        bfs.make_bfs_fn_1d(make_local_mesh_1d(1, device="cpu"),
                           graphs["1d"][3].part, BFSConfig(), axis="x")
    with pytest.raises(ValueError, match="no 'pod' axis"):
        bfs.make_multiroot_bfs_fn(mesh, g_t.part, BFSConfig(), cap_seg=32,
                                  n_roots=2)
