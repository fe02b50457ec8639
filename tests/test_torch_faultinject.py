"""The port's parent-fault injectors, store corruption, capacity
squeezes, seeded fault matrix and its CLI, retry types, straggler monitor
and self-healing session (``repro_torch.runtime.faultinject``/``retry``/
``straggler``, ``core/engine.py::run_bfs_healed``) against the JAX
package's, tolerance 0.  The healed run on 4 strips is held against the reference's
``retry_log`` in ``_torch_dist_validate_main.py`` (``test_torch_validate.
py``); here the port's own on 4 strips against its unsqueezed run."""
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.configs.base import BFSConfig as RConfig
from repro.core.engine import plan_bfs as r_plan_bfs
from repro.graph.formats import build_blocked_1d as r_build_1d
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d
from repro.runtime import faultinject as RF
from repro.runtime import retry as r_retry
from repro.runtime.straggler import StragglerMonitor as RMonitor
from repro_torch.configs.base import BFSConfig
from repro_torch.core import comm_model
from repro_torch.core.engine import (_overflow_levels_1ds, plan_bfs,
                                     run_bfs_healed)
from repro_torch.core.ref import TreeValidator, bfs_depths
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from repro_torch.runtime import retry
from repro_torch.ckpt.graph_store import GraphStore
from repro_torch.runtime import faultinject
from repro_torch.runtime.faultinject import (PARENT_FAULTS, InjectionError,
                                             corrupt_shard, inject_parents,
                                             run_fault_matrix, undersize_cap,
                                             undersize_route_slack)
from repro_torch.runtime.straggler import StragglerMonitor
from _torch_threads import one_thread  # noqa: F401

ROOT = 5


@pytest.fixture(scope="module")
def tree():
    """Both packages' edges (R-MAT scale 9, edge factor 8, seed 4) and the
    reference's 1ds parents from ROOT on 1 strip."""
    r_e = r_rmat_graph(9, edge_factor=8, seed=4)
    t_e = rmat_graph(9, edge_factor=8, seed=4, device="cpu")
    g = r_build_1d(r_e, 1, align=32, cap_pad=32)
    res = r_plan_bfs(g, RConfig(decomposition="1ds"),
                     r_mesh_1d(1)).compile().run(ROOT)
    return r_e, t_e, res.parents, g.part.chunk


@pytest.fixture(scope="module")
def strips():
    """The port's 4 strips of the reference validator graph, and the true
    depths from ROOT."""
    e = rmat_graph(8, 8, seed=4, device="cpu")
    depth = bfs_depths(e.n, e.src.numpy(), e.dst.numpy(), ROOT)
    return (build_blocked_1d(e, 4, align=32, cap_pad=32, with_col_ptr=True),
            make_local_mesh_1d(4, device="cpu"), depth)


@pytest.mark.parametrize("kind", PARENT_FAULTS)
def test_inject_parents_makes_the_reference_mutation(tree, kind):
    """The same (array, info) for each kind and seed, the seeded
    candidate orders included; with the edge keys and depths given (made
    once, as a caller injecting many faults does) too."""
    r_e, t_e, parents, chunk = tree
    tv = TreeValidator(t_e.n, t_e.src, t_e.dst)
    depth = tv.depths(ROOT)
    for seed in range(4):
        for c in (1, 4):
            want, w_info = RF.inject_parents(
                kind, parents, ROOT, seed, n=r_e.n, src=r_e.src,
                dst=r_e.dst, chunk=chunk, expand_chunks=c)
            got, info = inject_parents(
                kind, parents, ROOT, seed, n=t_e.n, src=t_e.src,
                dst=t_e.dst, chunk=chunk, expand_chunks=c)
            again, info2 = inject_parents(
                kind, parents, ROOT, seed, n=t_e.n, src=t_e.src,
                dst=t_e.dst, chunk=chunk, expand_chunks=c, keys=tv.keys,
                depth=depth)
            assert info == w_info == info2, (kind, seed, c)
            assert got.dtype == np.int64
            assert np.array_equal(got, want) and np.array_equal(again, want)


def test_inject_parents_takes_numpy_edges(tree):
    r_e, _, parents, chunk = tree
    for kind in PARENT_FAULTS:
        want = RF.inject_parents(kind, parents, ROOT, 2, n=r_e.n,
                                 src=r_e.src, dst=r_e.dst, chunk=chunk)
        got = inject_parents(kind, parents, ROOT, 2, n=r_e.n, src=r_e.src,
                             dst=r_e.dst, chunk=chunk)
        assert got[1] == want[1] and np.array_equal(got[0], want[0]), kind


def test_injector_refuses_degenerate_trees():
    """A 2-vertex path has no same-level edge to skew; a lone root has
    nothing to corrupt; the argument errors are the reference's."""
    src = np.array([0, 1], np.int64)
    dst = np.array([1, 0], np.int64)
    parents = np.array([0, 0, -1, -1], np.int64)
    for inject in (inject_parents, RF.inject_parents):
        with pytest.raises(RuntimeError, match="no same-level edge"):
            inject("level_skew", parents, 0, 0, n=4, src=src, dst=dst)
        with pytest.raises(RuntimeError, match="no non-root vertices"):
            inject("flip_bit", np.array([0, -1, -1, -1]), 0, 0, n=4,
                   src=src, dst=dst)
        with pytest.raises(ValueError, match="unknown parent fault"):
            inject("bit_rot", parents, 0, 0, n=4, src=src, dst=dst)
        with pytest.raises(ValueError, match="chunk size"):
            inject("drop_subrange", parents, 0, 0, n=4, src=src, dst=dst)
    with pytest.raises(InjectionError):
        inject_parents("level_skew", parents, 0, 0, n=4, src=src, dst=dst)


def test_undersize_cap_and_escalate_match_reference():
    for cap in (32, 64, 512, 4096, 52448, 1 << 20):
        for seed in range(6):
            for align in (1, 32):
                assert undersize_cap(cap, seed, align) == \
                    RF.undersize_cap(cap, seed, align), (cap, seed, align)
    assert undersize_cap(52448, 0) == 3264
    for value, kw in ((32, {}), (32, {"factor": 4}), (96, {"ceiling": 128}),
                      (128, {"ceiling": 128}), (3264, {"ceiling": 1 << 20})):
        assert retry.escalate(value, **kw) == r_retry.escalate(value, **kw)


def test_capacity_overflow_carries_the_reference_history():
    def hist(mod):
        return [mod.RetryAttempt(1, "cap_x", 32, "overflow", {"levels": [2]}),
                mod.RetryAttempt(2, "cap_x", 64, "overflow", {"levels": [3]})]
    got = retry.CapacityOverflow("cap_x escalation exhausted",
                                 cap_name="cap_x", cap_value=64,
                                 history=hist(retry))
    want = r_retry.CapacityOverflow("cap_x escalation exhausted",
                                    cap_name="cap_x", cap_value=64,
                                    history=hist(r_retry))
    assert isinstance(got, RuntimeError)
    assert str(got) == str(want)
    assert "[escalation history: attempt 1: cap_x=32 -> overflow" in str(got)
    assert got.history_json() == want.history_json()
    assert (got.cap_name, got.cap_value) == (want.cap_name, want.cap_value)
    bare = retry.CapacityOverflow("no history")
    assert str(bare) == "no history" and bare.history == ()


def test_straggler_monitor_gives_the_reference_events():
    rng = np.random.default_rng(11)
    series = rng.gamma(4.0, 0.01, size=120)
    series[[17, 40, 41, 90]] *= 9.0
    seen = ([], [])
    got = StragglerMonitor(window=20, factor=2.5, min_samples=5,
                           on_straggler=lambda *a: seen[0].append(a))
    want = RMonitor(window=20, factor=2.5, min_samples=5,
                    on_straggler=lambda *a: seen[1].append(a))
    deadlines = []
    for step, dt in enumerate(series):
        assert got.observe(step, float(dt)) == want.observe(step, float(dt))
        deadlines.append((got.deadline, want.deadline))
    assert got.events == want.events and got.events
    assert seen[0] == seen[1] == got.events
    assert all(a == b for a, b in deadlines)
    assert deadlines[0] == (None, None)


def test_run_many_feeds_straggler_monitor(strips):
    g, mesh, _ = strips
    eng = plan_bfs(g, BFSConfig(decomposition="1ds", instrument=False),
                   mesh).compile()
    mon = StragglerMonitor(min_samples=2, factor=1e-9)
    res = eng.run_many([5, 6, 7, 8], monitor=mon)
    assert len(res) == 4
    # with a zero deadline every root after the warm-up samples is an event
    assert [e[0] for e in mon.events] == [2, 3]
    assert all(r.validation is None for r in res)
    checked = eng.run_many([5, 6], validate=True)
    assert all(r.validation.ok for r in checked)


def test_run_bfs_healed_clean_plan_empty_log(strips):
    g, mesh, _ = strips
    cfg = BFSConfig(decomposition="1ds", instrument=False,
                    direction_optimizing=False)
    # buckets of a whole chunk: no level can overflow
    h = run_bfs_healed(g, cfg, mesh, ROOT, local_mode="kernel",
                       cap_x=g.part.chunk)
    assert h.retry_log == []
    assert not h.plan.cfg.instrument          # the fast program, not the probe
    assert h.result.counters == {}
    base = plan_bfs(g, cfg, mesh, local_mode="kernel").compile().run(ROOT)
    assert np.array_equal(h.result.parents, base.parents)


def test_run_bfs_healed_non_1ds_single_attempt():
    e = rmat_graph(8, 8, seed=4, device="cpu")
    g = build_blocked(e, 1, 1, align=32, cap_pad=32)
    cfg = BFSConfig(decomposition="2d", instrument=False)
    h = run_bfs_healed(g, cfg, make_local_mesh(1, 1, device="cpu"), ROOT,
                       validate=True)
    assert h.retry_log == []
    assert h.result.validation.ok


def _overflowing_levels(res, cap_x: int, g, depth) -> list:
    """The top-down levels whose busiest owner holds more than ``cap_x``
    frontier vertices (level d's frontier is the vertices at depth d),
    counted apart from the wire-based detection."""
    out = []
    for d in range(res.n_levels):
        counts = np.bincount(np.flatnonzero(depth == d) // g.part.chunk,
                             minlength=g.part.p)
        if res.level_stats[d, 2] == 0 and counts.max() > cap_x:
            out.append(d)
    return out


@pytest.mark.parametrize("instrument", [True, False])
def test_run_bfs_healed_squeezed_cap_heals(strips, instrument):
    """From ``undersize_cap(chunk)`` on 4 strips: an overflow attempt at
    each squeezed cap, then a clean one; the overflowed levels are those
    whose busiest owner's frontier exceeds the cap; the parents equal the
    unsqueezed run's and validate.  An uninstrumented request is probed
    instrumented and rebuilt uninstrumented at the healthy cap."""
    g, mesh, depth = strips
    cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                    instrument=instrument, direction_optimizing=False)
    squeezed = undersize_cap(g.part.chunk, 0)
    assert squeezed < g.part.chunk
    h = run_bfs_healed(g, cfg, mesh, ROOT, cap_x=squeezed, validate=True,
                       local_mode="kernel")
    log = h.retry_log
    assert [a["attempt"] for a in log] == list(range(1, len(log) + 1))
    assert [a["outcome"] for a in log] == ["overflow"] * (len(log) - 1) \
        + ["ok"]
    assert log[0]["cap_value"] == squeezed
    assert all(b["cap_value"] == min(2 * a["cap_value"], g.part.chunk)
               for a, b in zip(log, log[1:]))
    probe = BFSConfig(decomposition="1ds", storage="dcsc",
                      direction_optimizing=False)
    for a in log:
        at = plan_bfs(g, probe, mesh, cap_x=a["cap_value"]).compile()
        res = at.run(ROOT)
        assert a["detail"].get("levels", []) == _overflowing_levels(
            res, a["cap_value"], g, depth)
    good = plan_bfs(g, cfg, mesh, local_mode="kernel").compile().run(ROOT)
    assert np.array_equal(h.result.parents, good.parents)
    assert h.result.validation.ok
    assert h.plan.cfg.instrument == instrument
    assert h.plan.statics.cap_x == log[-1]["cap_value"]


def test_run_bfs_healed_exhaustion_raises_with_history(strips):
    g, mesh, _ = strips
    cfg = BFSConfig(decomposition="1ds", direction_optimizing=False)
    squeezed = undersize_cap(g.part.chunk, 0)
    with pytest.raises(retry.CapacityOverflow, match="exhausted after 1 "
                       "attempts") as ei:
        run_bfs_healed(g, cfg, mesh, ROOT, cap_x=squeezed, max_attempts=1)
    assert ei.value.cap_name == "cap_x" and ei.value.cap_value == squeezed
    assert [a.outcome for a in ei.value.history] == ["overflow"]
    assert "escalation history: attempt 1: cap_x=" in str(ei.value)


def test_run_bfs_healed_accepts_a_store(strips, tmp_path):
    """A store goes through to every attempt's compile: the same log and
    parents as without one, each engine built fresh (the port's store
    keeps no programs) and nothing written into the store."""
    g, mesh, _ = strips
    cfg = BFSConfig(decomposition="1ds", direction_optimizing=False)
    squeezed = undersize_cap(g.part.chunk, 0)
    store = GraphStore(str(tmp_path), device="cpu")
    h = run_bfs_healed(g, cfg, mesh, ROOT, cap_x=squeezed, store=store,
                       exec_key="k")
    want = run_bfs_healed(g, cfg, mesh, ROOT, cap_x=squeezed)
    assert h.retry_log == want.retry_log and len(h.retry_log) > 1
    assert np.array_equal(h.result.parents, want.result.parents)
    assert not h.engine.exec_from_store and h.engine.exec_load_s == 0.0
    assert list(tmp_path.iterdir()) == []


def test_overflow_detection_uses_the_reference_closed_forms(strips):
    """The packed and raw-id wire of a level equal the closed forms the
    detection compares against, in float32, on a 4-strip run whose
    buckets hold a whole chunk (no level can overflow)."""
    g, mesh, _ = strips
    for codec in ("packed", "none"):
        eng = plan_bfs(g, BFSConfig(decomposition="1ds", frontier_codec=codec,
                                    direction_optimizing=False),
                       mesh, cap_x=g.part.chunk).compile()
        res = eng.run(ROOT)
        for n_f, _, mode, used, wire in res.level_stats[:res.n_levels]:
            bits = comm_model.codec_bits(g.part.chunk)
            exp = comm_model.compressed_expand_1d_words(
                np.float64(n_f), g.part.p, bits, 1) if codec == "packed" \
                else comm_model.sparse_expand_1d_words(np.float64(n_f),
                                                       g.part.p)
            assert np.isclose(wire, np.float32(exp), rtol=1e-4), (codec,
                                                                  n_f)
        assert _overflow_levels_1ds(eng.plan, res.level_stats) == []


# ---------------------------------------------------------------------------
# the store half: shard corruption, the route_slack squeeze, the matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_shard_writes_the_reference_bytes(tmp_path, mode):
    """On two identical stores with the same seed, the port's and the
    reference's corrupt_shard pick the same shard and leave the same
    bytes."""
    from repro_torch.graph.dist_build import BuildSpec, dist_build
    g, _ = dist_build(BuildSpec(8, 8, 3), "1d", make_local_mesh_1d(
        4, device="cpu"), 4, align=32, cap_pad=32)
    GraphStore(str(tmp_path / "a"), device="cpu").save_graph("g", g)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for seed in (0, 2, 5):
        got = corrupt_shard(types.SimpleNamespace(root=str(tmp_path / "a")),
                            "g", seed, mode=mode)
        want = RF.corrupt_shard(types.SimpleNamespace(
            root=str(tmp_path / "b")), "g", seed, mode=mode)
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, "rb").read() == open(want, "rb").read()
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_shard(types.SimpleNamespace(root=str(tmp_path / "a")), "g",
                      0, mode="melt")
    with pytest.raises(FileNotFoundError, match="no graph steps"):
        corrupt_shard(types.SimpleNamespace(root=str(tmp_path)), "h", 0)


def test_undersize_route_slack_draws_the_reference_values():
    for seed in range(16):
        s = undersize_route_slack(seed)
        assert s == RF.undersize_route_slack(seed) and 0.2 <= s < 0.45


def _verdicts(report):
    """Each case's name, verdict and detail; a store case's detail is its
    corrupted file, mode and repaired shards (the reasons quote the zip
    reader, and each package orders its npz members its own way)."""
    out = []
    for c in report["cases"]:
        d = c["detail"]
        if c["name"].startswith("store/"):
            d = {**d, "repaired": [r["shard"] for r in d["repaired"]]}
        out.append((c["name"], c["ok"], json.dumps(d, sort_keys=True)))
    return out


def test_fault_matrix_equals_reference_on_one_device():
    """The 22 cases' names and verdicts, the kill cases' faults and
    violations, both heal logs and the repaired shards are the
    reference's."""
    got = run_fault_matrix(devices=1, device="cpu")
    want = RF.run_fault_matrix(devices=1)
    assert len(got["cases"]) == 22 and got["ok"] and want["ok"]
    assert _verdicts(got) == _verdicts(want)
    with pytest.raises(ValueError, match="supports devices in"):
        run_fault_matrix(devices=3, device="cpu")


def test_fault_matrix_cli_equals_reference_on_four_devices(tmp_path,
                                                           monkeypatch):
    """The port's CLI on a 4-shard simulated mesh against the reference's
    CLI on 4 forced host devices: exit 0, the same report; then a matrix
    whose route_slack heal cannot heal exits 1."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env.pop("XLA_FLAGS", None)
    want_json = str(tmp_path / "ref.json")
    r = subprocess.run([sys.executable, "-m", "repro.runtime.faultinject",
                        "--devices", "4", "--json", want_json],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    got_json = str(tmp_path / "port.json")
    assert faultinject.main(["--devices", "4", "--device", "cpu", "--json",
                             got_json]) == 0
    got, want = json.load(open(got_json)), json.load(open(want_json))
    assert {k: got[k] for k in ("seed", "scale", "edge_factor", "devices",
                                "ok")} == \
        {k: want[k] for k in ("seed", "scale", "edge_factor", "devices",
                              "ok")}
    assert _verdicts(got) == _verdicts(want)
    monkeypatch.setattr(faultinject, "undersize_route_slack",
                        lambda seed: 1e-6)
    assert faultinject.main(["--devices", "1", "--device", "cpu"]) == 1
