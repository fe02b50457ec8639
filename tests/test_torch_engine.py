"""The port's traversal sessions against the JAX package's: parents,
n_levels, every counter and level_stats, bit for bit (tolerance 0: the
counters are float32 sums of integers below 2**24); the uninstrumented
(``instrument=False``) sessions in parents and n_levels, with no
counters and zero stats.  1x1 runs in this process; 2x2 and 4x4 run in
one 16-device subprocess.  Also the session contract: one graph shipment
and one program build per compile, and plan errors up front."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import BFSConfig as RConfig
from repro.core.engine import plan_bfs as r_plan_bfs
from repro.graph.formats import build_blocked as r_build_blocked
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.launch.mesh import make_local_mesh as r_mesh
from repro_torch.configs.base import BFSConfig, get_config
from repro_torch.core import local_ops
from repro_torch.core.engine import plan_bfs
from repro_torch.core.metrics import harmonic_mean, teps
from repro_torch.core.ref import TreeValidator, bfs_depths, validate_parents
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def graphs():
    r = r_rmat_graph(10, 8, seed=4)
    t = rmat_graph(10, 8, seed=4, device="cpu")
    return (r, r_build_blocked(r, 1, 1, align=32, cap_pad=32),
            t, build_blocked(t, 1, 1, align=32, cap_pad=32))


def _roots(r_edges):
    deg = r_edges.out_degrees()
    return [int(x) for x in np.flatnonzero(deg > 0)[[0, 17, 300]]]


def _same(want, got, local_mode):
    assert np.array_equal(want.parents, got.parents)
    assert want.n_levels == got.n_levels
    assert np.array_equal(want.level_stats, got.level_stats)
    assert set(want.counters) == set(got.counters)
    for k, v in want.counters.items():
        # a kernel session examines only the frontier's edges: its total
        # equals the dense session's edges_useful
        if local_mode == "kernel" and k == "edges_examined":
            v = want.counters["edges_useful"]
        assert got.counters[k] == v, k


@pytest.mark.parametrize("fold", ["reduce", "alltoall"])
@pytest.mark.parametrize("diro", [True, False])
def test_sessions_match_reference_1x1(graphs, fold, diro):
    r, g_r, t, g_t = graphs
    ref = r_plan_bfs(g_r, RConfig(fold_mode=fold, direction_optimizing=diro),
                     r_mesh(1, 1), local_mode="dense").compile()
    mesh = make_local_mesh(1, 1, device="cpu")
    cfg = BFSConfig(fold_mode=fold, direction_optimizing=diro)
    modes = set()
    for local_mode in ("dense", "kernel"):
        eng = plan_bfs(g_t, cfg, mesh, local_mode=local_mode).compile()
        for root in _roots(r):
            want, got = ref.run(root), eng.run(root)
            _same(want, got, local_mode)
            modes |= set(got.level_stats[:got.n_levels, 2].tolist())
    assert modes == ({0.0, 1.0} if diro else {0.0})


@pytest.mark.parametrize("fold", ["reduce", "alltoall"])
@pytest.mark.parametrize("diro", [True, False])
def test_fast_sessions_match_reference_1x1(graphs, fold, diro):
    """``instrument=False``: parents and n_levels equal the reference's
    fast dense session's and the port's instrumented session's on the
    same root, in dense and kernel modes; counters ``{}`` and
    level_stats all zero, as the reference returns them."""
    r, g_r, t, g_t = graphs
    kw = dict(fold_mode=fold, direction_optimizing=diro)
    ref = r_plan_bfs(g_r, RConfig(instrument=False, **kw), r_mesh(1, 1),
                     local_mode="dense").compile()
    mesh = make_local_mesh(1, 1, device="cpu")
    for local_mode in ("dense", "kernel"):
        instr = plan_bfs(g_t, BFSConfig(**kw), mesh,
                         local_mode=local_mode).compile()
        fast = plan_bfs(g_t, BFSConfig(instrument=False, **kw), mesh,
                        local_mode=local_mode).compile()
        for root in _roots(r):
            want, got, full = ref.run(root), fast.run(root), instr.run(root)
            assert want.counters == {} and got.counters == {}
            assert not got.level_stats.any()
            for other in (want, full):
                assert np.array_equal(got.parents, other.parents), root
                assert got.n_levels == other.n_levels, root


def test_sessions_match_reference_on_2x2_and_4x4_meshes():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_torch_dist_main.py")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK torch-dist" in r.stdout


def test_trees_validate_on_host_and_device(graphs):
    r, g_r, t, g_t = graphs
    eng = plan_bfs(g_t, BFSConfig(), make_local_mesh(1, 1, device="cpu"),
                   local_mode="kernel").compile()
    tv = TreeValidator(t.n, t.src, t.dst)
    src, dst = t.src.numpy(), t.dst.numpy()
    for root in _roots(r):
        par = eng.run(root).parents
        assert validate_parents(t.n, src, dst, root, par) == (True, "ok")
        assert tv.check(root, torch.from_numpy(par)) == (True, "ok")
        depth = bfs_depths(t.n, src, dst, root)
        assert np.array_equal(tv.depths(root).numpy(), depth)
        bad = par.copy()
        v = int(np.flatnonzero((par >= 0) & (np.arange(t.n) != root))[0])
        bad[v] = v                         # a self loop is no graph edge
        assert not tv.check(root, torch.from_numpy(bad))[0]
        assert not validate_parents(t.n, src, dst, root, bad)[0]
        bad = par.copy()
        bad[root] = -1
        assert tv.check(root, torch.from_numpy(bad)) == \
            (False, "root parent mismatch")


def test_compile_ships_once_and_builds_once(graphs):
    r, g_r, t, g_t = graphs
    plan = plan_bfs(g_t, BFSConfig(), make_local_mesh(1, 1, device="cpu"),
                    local_mode="kernel")
    eng = plan.compile()
    assert (eng.ship_count, eng.trace_count) == (1, 1)
    assert set(eng._gdev) == set(plan.keys)
    assert eng.ship_s >= 0 and eng.compile_s > 0
    res = eng.run_many(_roots(r) * 2)
    assert (eng.ship_count, eng.trace_count) == (1, 1)
    assert len(res) == 6 and np.array_equal(res[0].parents, res[3].parents)


def test_plan_errors_up_front(graphs):
    r, g_r, t, g_t = graphs
    mesh = make_local_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="mesh grid"):
        plan_bfs(g_t, BFSConfig(), make_local_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="no LocalOps"):
        plan_bfs(g_t, BFSConfig(), mesh, local_mode="pallas")
    for bad in (dict(fold_mode="psum"), dict(storage="coo"),
                dict(decomposition="3d")):
        with pytest.raises(ValueError, match="is not one of"):
            plan_bfs(g_t, BFSConfig(**bad), mesh)
    # pod-batched roots need a mesh with a pod axis; their arch is
    # registered
    assert get_config("bfs-rmat-multiroot").storage == "dcsc"
    with pytest.raises(ValueError, match="no 'pod' axis"):
        plan_bfs(g_t, BFSConfig(), mesh).compile().run_batch([0, 1])
    # "1d" is ported: a 2D graph is the wrong graph type for it
    with pytest.raises(TypeError, match="graph type"):
        plan_bfs(g_t, BFSConfig(decomposition="1d"), mesh)
    eng = plan_bfs(g_t, BFSConfig(), mesh).compile()
    with pytest.raises(ValueError, match="out of range"):
        eng.run(t.n)


def test_cap_f_smaller_than_frontier_raises(graphs):
    r, g_r, t, g_t = graphs
    mesh = make_local_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="exceeds cap_f"):
        plan_bfs(g_t, BFSConfig(direction_optimizing=False), mesh,
                 local_mode="kernel", cap_f=1).compile()


def test_registry_lists_the_ported_combos():
    assert local_ops.registered_combos() == tuple(
        (d, m, s) for d in ("1d", "1ds", "2d") for m in ("dense", "kernel")
        for s in ("csr", "dcsc"))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        rmat_graph(6, 4)


def test_metrics():
    assert teps(100, 2.0) == 50.0
    assert harmonic_mean([1.0, 4.0, 4.0]) == pytest.approx(2.0)
    assert harmonic_mean([]) == 0.0
