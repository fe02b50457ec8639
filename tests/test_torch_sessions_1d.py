"""The port's 1D strip sessions ("1d", and "1ds" with both codecs and
the pipelined expand): against the JAX package's dense sessions on 16
forced host devices (one subprocess, instrumented and
``instrument=False``), against the pinned scale-14/p=16 ``wire_expand``
totals of the reference's acceptance run, against the port's own 2D
sessions (the same parents), the host reads of an uninstrumented "1ds"
search, and the plan checks."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import decomp
from repro_torch.core import steps_1d_sparse as sparse
from repro_torch.core.engine import plan_bfs
from repro_torch.core.ref import TreeValidator, validate_parents
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)


def _cfg(dec="1ds", **kw):
    return BFSConfig(decomposition=dec, storage="dcsc", **kw)


@pytest.fixture(scope="module")
def small():
    e = rmat_graph(11, 16, seed=1, device="cpu")
    deg = e.out_degrees().numpy()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 40, 200]]]
    return e, build_blocked_1d(e, 16, align=32, cap_pad=32), roots


def test_sessions_match_reference_on_16_strips():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_torch_dist_1d_main.py")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK torch-dist-1d" in r.stdout


@pytest.mark.parametrize("local_mode", ["dense", "kernel"])
def test_pinned_scale_14_wire_totals(local_mode):
    """The reference's pinned acceptance config (``_dist_bfs_main.py``
    mode ``onedsparse``): R-MAT scale 14, edge factor 4, seed 14, 16
    strips, top-down only, a low-degree root, planned bucket caps.  Its
    measured totals: packed 10313.9 < raw 12150.0 < dense 23040.0."""
    e = rmat_graph(14, 4, seed=14, device="cpu")
    deg = e.out_degrees().numpy()
    root = int(np.flatnonzero((deg > 0) & (deg <= 32))[0])
    g = build_blocked_1d(e, 16, align=32, cap_pad=32)
    mesh = make_local_mesh_1d(16, device="cpu")
    got, parents = {}, []
    for label, dec, codec in (("packed", "1ds", "packed"),
                              ("raw", "1ds", "none"),
                              ("dense", "1d", "packed")):
        res = plan_bfs(g, _cfg(dec, frontier_codec=codec,
                               direction_optimizing=False), mesh,
                       local_mode=local_mode).compile().run(root)
        assert res.counters["wire_expand"] == \
            res.level_stats[:res.n_levels, 4].sum()
        got[label] = round(float(res.counters["wire_expand"]), 1)
        parents.append(res.parents)
    assert got == {"packed": 10313.9, "raw": 12150.0, "dense": 23040.0}
    assert all(np.array_equal(parents[0], q) for q in parents[1:])


def test_strip_parents_equal_2d_parents(small):
    """With a 1x1 grid and p strips both decompositions take the min
    source in top-down, the first (ascending) hit in bottom-up and the
    same global sums in the heuristics: the same parents and levels."""
    e, g, roots = small
    two_d = plan_bfs(build_blocked(e, 1, 1, align=32, cap_pad=32),
                     BFSConfig(), make_local_mesh(1, 1, device="cpu"),
                     local_mode="kernel").compile()
    mesh = make_local_mesh_1d(16, device="cpu")
    engines = [plan_bfs(g, _cfg(**kw), mesh, local_mode="kernel").compile()
               for kw in (dict(), dict(expand_chunks=4),
                          dict(frontier_codec="none", expand_chunks=2))]
    engines.append(plan_bfs(g, _cfg("1d"), mesh,
                            local_mode="kernel").compile())
    for root in roots:
        want = two_d.run(root)
        for eng in engines:
            got = eng.run(root)
            assert np.array_equal(got.parents, want.parents), root
            assert got.n_levels == want.n_levels
            assert np.array_equal(got.level_stats[:, :4],
                                  want.level_stats[:, :4])


@pytest.mark.parametrize("codec,chunks", [("packed", 1), ("packed", 2),
                                          ("none", 2)])
def test_fast_1ds_reads_once_a_level(small, monkeypatch, codec, chunks):
    """An ``instrument=False`` "1ds" search never calls the exchange's
    ``_send_counts``: its one host read a level is the loop's tail read
    ``_masses`` (one more before the first level), which carries the
    overflow predicate.  Buckets of 4 ids, top-down only, so that levels
    overflow: the fast run's predicates are the instrumented run's,
    level by level, and so are its parents and n_levels."""
    e, g, roots = small
    mesh = make_local_mesh_1d(16, device="cpu")
    kw = dict(frontier_codec=codec, expand_chunks=chunks,
              direction_optimizing=False)
    engines = {instr: plan_bfs(g, _cfg(instrument=instr, **kw), mesh,
                               local_mode="kernel", cap_x=4).compile()
               for instr in (True, False)}
    calls = {"masses": 0, "send_counts": 0}
    overs = {True: [], False: []}
    cap = 4 // chunks
    real = (decomp._masses, sparse._send_counts, sparse.sparse_exchange_1d,
            sparse._pipelined_topdown_1ds)

    def masses(*a):
        calls["masses"] += 1
        return real[0](*a)

    def send_counts(counts):
        calls["send_counts"] += 1
        n_max, n_f = real[1](counts)
        overs[True].append(n_max > cap)
        return n_max, n_f

    def exchange(*a, over=None, **kw_):
        if over is not None:
            overs[False].append(over)
        return real[2](*a, over=over, **kw_)

    def pipelined(g_, send, args, over=None):
        if over is not None:
            overs[False].append(over)
        return real[3](g_, send, args, over)

    for mod, name, fn in ((decomp, "_masses", masses),
                          (sparse, "_send_counts", send_counts),
                          (sparse, "sparse_exchange_1d", exchange),
                          (sparse, "_pipelined_topdown_1ds", pipelined)):
        monkeypatch.setattr(mod, name, fn)
    for root in roots:
        for v in calls:
            calls[v] = 0
        for v in overs.values():
            v.clear()
        want = engines[True].run(root)
        assert calls["send_counts"] == want.n_levels      # top-down only
        assert calls["masses"] == want.n_levels + 1
        calls["send_counts"] = calls["masses"] = 0
        got = engines[False].run(root)
        assert calls == {"masses": got.n_levels + 1, "send_counts": 0}
        assert overs[False] == overs[True] and any(overs[True])
        assert np.array_equal(got.parents, want.parents)
        assert got.n_levels == want.n_levels
        assert got.counters == {} and not got.level_stats.any()


def test_session_contract_and_trees(small):
    e, g, roots = small
    plan = plan_bfs(g, _cfg(expand_chunks=2), make_local_mesh_1d(
        16, device="cpu"), local_mode="kernel")
    assert plan.statics.cap_x == 32 and plan.statics.expand_chunks == 2
    eng = plan.compile()
    assert (eng.ship_count, eng.trace_count) == (1, 1)
    assert set(eng._gdev) == set(plan.keys)
    res = eng.run_many(roots * 2)
    assert (eng.ship_count, eng.trace_count) == (1, 1)
    tv = TreeValidator(e.n, e.src, e.dst)
    for root, r in zip(roots, res):
        assert validate_parents(e.n, e.src.numpy(), e.dst.numpy(), root,
                                r.parents) == (True, "ok")
        assert tv.check(root, torch.from_numpy(r.parents)) == (True, "ok")
        assert r.parents.shape == (e.n,)
    assert np.array_equal(res[0].parents, res[len(roots)].parents)
    with pytest.raises(ValueError, match="no 'pod' axis"):
        eng.run_batch(roots)
    with pytest.raises(ValueError, match="out of range"):
        eng.run(e.n)


def test_plan_errors_up_front(small):
    e, g, roots = small
    mesh = make_local_mesh_1d(16, device="cpu")
    # the csr strips' kernel entry reads the (p, n+1) strip col_ptr,
    # which this graph was built without
    for dec in ("1d", "1ds"):
        with pytest.raises(ValueError, match="lacks arrays"):
            plan_bfs(g, BFSConfig(decomposition=dec, storage="csr"),
                     mesh, local_mode="kernel")
    # pod-batched roots need a mesh with a pod axis
    with pytest.raises(ValueError, match="no 'pod' axis"):
        plan_bfs(g, _cfg(use_edge_dst=True, compact_updates=True),
                 mesh).compile().run_batch(roots)
    with pytest.raises(ValueError, match="frontier codec"):
        plan_bfs(g, _cfg(frontier_codec="varint"), mesh)
    with pytest.raises(ValueError, match=">= 1"):
        plan_bfs(g, _cfg(expand_chunks=0), mesh)
    with pytest.raises(ValueError, match="does not divide the per-device"):
        plan_bfs(g, _cfg(expand_chunks=3), mesh)
    with pytest.raises(ValueError, match="does not divide cap_x"):
        plan_bfs(g, _cfg(expand_chunks=4), mesh, cap_x=6)
    with pytest.raises(ValueError, match="exceeds the owned chunk"):
        plan_bfs(g, _cfg(), mesh, cap_x=g.part.chunk + 32)
    with pytest.raises(ValueError, match="mesh grid"):
        plan_bfs(g, _cfg(), make_local_mesh(4, 4, device="cpu"))
    with pytest.raises(TypeError, match="graph type"):
        plan_bfs(g, BFSConfig(), make_local_mesh(16, 1, device="cpu"))
    lean = build_blocked_1d(e, 16, align=32, cap_pad=32,
                            with_edge_lists=False)
    with pytest.raises(ValueError, match="lacks arrays"):
        plan_bfs(lean, _cfg(), mesh, local_mode="dense")
    plan_bfs(lean, _cfg(), mesh, local_mode="kernel")


def test_mesh_1d_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh_1d(16)


@pytest.mark.parametrize("dec", ["1d", "1ds"])
def test_cap_f_smaller_than_frontier_raises_on_strips(dec):
    """The strip csr kernel entry bounds the frontier by ``cap_f`` as the
    2D entries do: a frontier of more ids raises (the JAX package's
    kernel truncated it silently), one of exactly ``cap_f`` ids runs, and
    a ``cap_f`` at the largest frontier gives the parents of
    ``cap_f=0``.  Top-down only, on 4 strips at scale 10."""
    e = rmat_graph(10, 8, seed=4, device="cpu")
    g = build_blocked_1d(e, 4, align=32, cap_pad=32, with_col_ptr=True)
    mesh = make_local_mesh_1d(4, device="cpu")
    cfg = BFSConfig(decomposition=dec, direction_optimizing=False)
    deg = e.out_degrees().numpy()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 40, 200]]]
    # compile() warms up from the hub, so its search counts too
    searches = [int(np.argmax(deg))] + roots
    free = plan_bfs(g, cfg, mesh, local_mode="kernel").compile()
    want = free.run_many(searches)
    widest = int(max(r.level_stats[:, 0].max() for r in want))
    assert widest > 1
    with pytest.raises(ValueError, match=f"exceeds cap_f={widest - 1}"):
        plan_bfs(g, cfg, mesh, local_mode="kernel",
                 cap_f=widest - 1).compile().run_many(roots)
    with pytest.raises(ValueError, match="frontier of .* exceeds cap_f=1"):
        plan_bfs(g, cfg, mesh, local_mode="kernel", cap_f=1).compile()
    capped = plan_bfs(g, cfg, mesh, local_mode="kernel",
                      cap_f=widest).compile()
    for root, w in zip(searches, want):
        got = capped.run(root)
        assert np.array_equal(got.parents, w.parents), root
        assert got.n_levels == w.n_levels
        assert np.array_equal(got.level_stats, w.level_stats)
