"""The port's spans and counters (``core/trace.py``) on the CPU: the span
tree of a traced 2D search, its mode sequence against an instrumented
run's ``level_stats``, the batch's one search id, the strips' loop spans
and the "1ds" read, the off path (no profiler call, no Recorder call),
the spans in a CPU ``torch.profiler`` trace, nesting, kernel 2's
loaded-edge rule (``loaded_edges_plain``) against a row-by-row count, and
the level epilogue's launch count (``level_epilogues``): (levels + 1) x
pods on the card, none through the plain twin."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import collectives, trace
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels import edge_cases as ec
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from _torch_threads import one_thread  # noqa: F401

TD_STAGES = ["bfs.expand", "bfs.discover", "bfs.fold", "bfs.update"]
BU_STAGES = ["bfs.expand", "bfs.discover", "bfs.exchange", "bfs.update"]


@pytest.fixture(scope="module")
def edges():
    return rmat_graph(10, 16, seed=3, device="cpu")


@pytest.fixture(scope="module")
def graph(edges):
    return build_blocked(edges, 1, 1, align=32, cap_pad=32)


def _roots(graph, k=3):
    deg = graph.deg_A.reshape(-1)
    hub = int(torch.argmax(deg))
    others = torch.nonzero(deg == 1).reshape(-1)[:k - 1].tolist()
    return [hub] + [int(r) for r in others]


def _engine(graph, mesh=None, **cfg):
    return plan_bfs(graph, BFSConfig(decomposition="2d", **cfg),
                    mesh or make_local_mesh(1, 1, device="cpu")).compile()


def _children(spans, idx):
    return [s.name for s in spans if s.parent == idx]


@pytest.mark.parametrize("direction_optimizing", [True, False])
def test_span_tree_and_mode_sequence_of_a_2d_search(graph,
                                                    direction_optimizing):
    fast = _engine(graph, instrument=False,
                   direction_optimizing=direction_optimizing)
    slow = _engine(graph, instrument=True,
                   direction_optimizing=direction_optimizing)
    for root in _roots(graph):
        with trace.Recorder() as rec:
            out = fast.search(root)
        n_levels = out[1]
        assert not out[3].any()                # level_stats stay zeros
        spans = rec.spans
        assert {s.search for s in spans} == {0}
        top = spans[0]
        assert top.name == "bfs.search" and top.parent is None
        assert top.attrs == {"roots": [root], "pods": 1,
                             "n_levels": n_levels}
        kids = _children(spans, 0)
        assert kids[0] == "bfs.start"
        assert _children(spans, 1) == ["bfs.tail"]
        steps = [s for s in spans if s.name in ("bfs.td", "bfs.bu")]
        assert kids[1:] == [n for s in steps
                            for n in (s.name, "bfs.tail")]
        for s in steps:
            idx = spans.index(s)
            want = TD_STAGES if s.name == "bfs.td" else BU_STAGES
            assert _children(spans, idx) == want
            assert s.start_ns <= spans[idx + 1].start_ns
            assert spans[-1].end_ns <= top.end_ns
        for s in spans:
            assert s.start_ns <= s.end_ns
            if s.parent is not None:
                par = spans[s.parent]
                assert par.start_ns <= s.start_ns <= s.end_ns <= par.end_ns
        ctr = rec.counters[0]
        assert ctr["levels"] == n_levels == len(steps)
        assert ctr["host_reads"] == n_levels + 1
        assert ctr.get("td_levels", 0) + ctr.get("bu_levels", 0) == n_levels
        # the mode sequence and frontier sizes of the instrumented run
        res = slow.run(root)
        assert res.n_levels == n_levels
        st = res.level_stats[:n_levels]
        assert [s.attrs["mode"] for s in steps] == \
            ["bu" if m else "td" for m in st[:, 2]]
        assert [s.attrs["level"] for s in steps] == list(range(n_levels))
        np.testing.assert_array_equal(
            np.float32([s.attrs["n_f"] for s in steps]), st[:, 0])
        np.testing.assert_array_equal(
            np.float32([s.attrs["m_f"] for s in steps]), st[:, 1])
        assert ctr.get("bu_levels", 0) == int(st[:, 2].sum())


def test_batch_is_one_search(graph):
    mesh = make_local_mesh(1, 1, device="cpu", pods=2)
    eng = _engine(graph, mesh=mesh, instrument=False)
    roots = _roots(graph, 4)
    with trace.Recorder() as rec:
        pis, levels, _ = eng.search_batch(roots)
    assert {s.search for s in rec.spans} == {0}
    top = rec.spans[0]
    assert top.name == "bfs.search"
    assert top.attrs == {"roots": roots, "pods": 2,
                         "n_levels": levels.tolist()}
    kids = _children(rec.spans, 0)
    assert kids.count("bfs.start") == 2      # two roots a pod, in turn
    steps = [s for s in rec.spans if s.name in ("bfs.td", "bfs.bu")]
    assert sorted({s.attrs["pod"] for s in steps}) == [0, 1]
    ctr = rec.counters[0]
    assert ctr["levels"] == int(levels[0]) + int(levels[1])
    assert ctr["td_levels"] + ctr["bu_levels"] == 2 * ctr["levels"]
    assert ctr["host_reads"] == 2 * (ctr["levels"] + 2)
    # the pods share each decision
    for lv in range(int(levels[0])):
        modes = {s.name for s in steps[:2 * int(levels[0])]
                 if s.attrs["level"] == lv}
        assert len(modes) == 1


@pytest.mark.parametrize("decomposition,instrument",
                         [("1d", False), ("1ds", False), ("1ds", True)])
def test_strip_loops_carry_the_loop_spans(edges, decomposition, instrument):
    g = build_blocked_1d(edges, 2, align=32, cap_pad=32)
    eng = plan_bfs(g, BFSConfig(decomposition=decomposition,
                                instrument=instrument),
                   make_local_mesh_1d(2, device="cpu")).compile()
    root = int(torch.argmax(g.deg_A.reshape(-1)))
    with trace.Recorder() as rec:
        res = eng.run(root)
    names = [s.name for s in rec.spans]
    assert not set(names) & set(TD_STAGES + BU_STAGES)
    steps = [s for s in rec.spans if s.name in ("bfs.td", "bfs.bu")]
    assert len(steps) == res.n_levels == rec.counters[0]["levels"]
    reads = res.n_levels + 1
    if instrument:                 # one send-count read a top-down level
        reads += sum(s.name == "bfs.td" for s in steps)
    assert rec.counters[0]["host_reads"] == reads


def test_off_calls_no_profiler_and_no_recorder(graph, monkeypatch):
    eng = _engine(graph, instrument=False)
    mesh = make_local_mesh(1, 1, device="cpu", pods=2)
    batch = _engine(graph, mesh=mesh, instrument=False)
    root = _roots(graph)[0]
    want = eng.search(root)[0]

    def boom(*a, **k):
        raise AssertionError("tracing ran while off")

    monkeypatch.setattr(trace, "profiler_range", boom)
    for cls, name in ((trace.Recorder, "count"),
                      (trace.Recorder, "new_search"),
                      (trace.Search, "__init__"), (trace._SpanCtx, "__init__"),
                      (trace.Search, "count")):
        monkeypatch.setattr(cls, name, boom)
    assert trace.current() is None
    assert torch.equal(eng.search(root)[0], want)
    batch.search_batch(_roots(graph, 2))
    assert trace.current() is None


def test_profiler_sees_the_spans(graph):
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(graph, instrument=False)
    root = _roots(graph)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n_levels = eng.search(root)[1]
    names = [ev.name for ev in prof.events()]
    for name in ("bfs.search", "bfs.start", "bfs.tail", "bfs.expand",
                 "bfs.discover", "bfs.update"):
        assert name in names, name
    assert names.count("bfs.search") == 1
    assert names.count("bfs.tail") == n_levels + 1
    assert names.count("bfs.td") + names.count("bfs.bu") == n_levels
    # no Recorder: nothing kept
    assert trace._ACTIVE is None and trace.current() is None


def test_recorders_nest(graph):
    eng = _engine(graph, instrument=False)
    root = _roots(graph)[0]
    with trace.Recorder() as outer:
        eng.search(root)
        with trace.Recorder() as inner:
            eng.search(root)
        eng.search(root)
    assert sorted(outer.counters) == [0, 1] and sorted(inner.counters) == [0]
    assert {s.search for s in outer.spans} == {0, 1}
    assert [outer.counters[k]["levels"] for k in (0, 1)] == \
        [inner.counters[0]["levels"]] * 2
    assert trace._ACTIVE is None


@pytest.mark.parametrize("direction_optimizing", [False, True])
@pytest.mark.parametrize("trace_outside", [False, True])
def test_wire_bytes_sum_the_schedule_of_a_4x4_search(edges,
                                                     direction_optimizing,
                                                     trace_outside):
    """``wire_bytes`` is the ``nbytes`` a ScheduleRecorder records over
    the same search, whichever of the two is entered first."""
    g = build_blocked(edges, 4, 4, align=32, cap_pad=32)
    eng = _engine(g, mesh=make_local_mesh(4, 4, device="cpu"),
                  instrument=False, storage="dcsc",
                  direction_optimizing=direction_optimizing)
    root = _roots(g)[0]
    first, second = (trace.Recorder(), collectives.ScheduleRecorder())
    if not trace_outside:
        first, second = second, first
    with first, second:
        eng.search(root)
    rec, sched = (first, second) if trace_outside else (second, first)
    want = sum(r.nbytes for r in sched.records)
    assert want > 0
    assert rec.counters[0][trace.WIRE_BYTES] == want
    # the search's own records only: a second search counts the same
    with trace.Recorder() as again:
        eng.search(root)
    assert again.counters[0][trace.WIRE_BYTES] == want
    assert collectives._ACTIVE is None and trace._ACTIVE is None


def test_wire_bytes_counts_nothing_without_a_recorder(edges, monkeypatch):
    g = build_blocked(edges, 4, 4, align=32, cap_pad=32)
    eng = _engine(g, mesh=make_local_mesh(4, 4, device="cpu"),
                  instrument=False)
    root = _roots(g)[0]

    def boom(*a, **k):
        raise AssertionError("counted with no Recorder")

    monkeypatch.setattr(trace.Search, "count", boom)
    monkeypatch.setattr(collectives, "wire_tap", boom)
    eng.search(root)
    # a schedule recorder alone records, and no search counts
    with collectives.ScheduleRecorder() as sched:
        eng.search(root)
    assert sched.records and collectives._ACTIVE is None


def test_twin_counts_no_level_epilogues(graph):
    eng = _engine(graph, instrument=False)
    with trace.Recorder() as rec:
        eng.search(_roots(graph)[0])
    assert rec.counters[0]["levels"] > 0
    assert trace.LEVEL_EPILOGUES not in rec.counters[0]


@pytest.mark.cuda
def test_level_epilogues_count_every_level_and_pod():
    """On the card a recorded 2D search counts one launch a level and
    pod and one a root at the start: (levels + 1) x pods, each loop
    call's own, so a batch of two groups on 2 pods counts 2 x (levels +
    2); the host reads count the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = build_blocked(rmat_graph(10, 16, seed=3, device=dev), 1, 1,
                      align=32, cap_pad=32)
    roots = _roots(g, 4)
    for pods in (1, 2):
        eng = plan_bfs(g, BFSConfig(decomposition="2d", instrument=False),
                       make_local_mesh(1, 1, device=dev, pods=pods),
                       local_mode="kernel").compile()
        with trace.Recorder() as rec:
            if pods == 1:
                n_levels = eng.search(roots[0])[1]
            else:
                eng.search_batch(roots)
        ctr = rec.counters[0]
        groups = 1 if pods == 1 else len(roots) // pods
        if pods == 1:
            assert ctr["levels"] == n_levels
        assert ctr[trace.LEVEL_EPILOGUES] == \
            pods * (ctr["levels"] + groups) == ctr["host_reads"]


def _loaded_by_rows(rp, ue, fw, cv, n_edges):
    """The kernel's rule, a row at a time."""
    bits = fw.tolist()
    total = 0
    for r in range(cv.shape[0]):
        lo, hi = int(rp[r]), min(int(rp[r + 1]), n_edges)
        if int(cv[r]) or lo >= hi:
            continue
        hits = [(bits[u >> 5] >> (u & 31)) & 1
                for u in ue[lo:hi].tolist()]
        head = min(hi - lo, bu_ops.LANE_EDGES)
        total += head
        if any(hits[:head]) or hi - lo <= head:
            continue
        for e0 in range(lo + head, hi, bu_ops.WARP_EDGES):
            step = hits[e0 - lo:e0 - lo + bu_ops.WARP_EDGES]
            total += len(step)
            if any(step):
                break
    return total


CASES = ec.bottomup_cases(2, 1 << 15)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaded_edges_plain_counts_the_kernels_rule(case):
    rp, ci, fw, cv, ne = CASES[case]
    for i in range(rp.shape[0]):
        got = bu_ops.loaded_edges_plain(rp[i], ci[i], fw, cv[i], int(ne[i]))
        assert got == _loaded_by_rows(rp[i], ci[i], fw, cv[i], int(ne[i]))


def test_loaded_edges_plain_on_hand_rows():
    # rows: hit at 0; hit at 3; hit at 4 (first walk step); hit at 40
    # (second step); no hit in 50; completed; empty
    lens = [10, 10, 50, 50, 50, 50, 0]
    rp = torch.tensor([0] + np.cumsum(lens).tolist(), dtype=torch.int32)
    n = int(rp[-1])
    ue = torch.full((n,), 1, dtype=torch.int32)       # vertex 1: no hit
    for row, at in ((0, 0), (1, 3), (2, 4), (3, 40)):
        ue[int(rp[row]) + at] = 0                     # vertex 0: a hit
    fw = torch.tensor([1], dtype=torch.int32)
    cv = torch.tensor([0, 0, 0, 0, 0, 1, 0], dtype=torch.int32)
    want = 4 + 4 + (4 + 32) + (4 + 46) + 50
    assert bu_ops.loaded_edges_plain(rp, ue, fw, cv, n) == want
    # the edge count cuts the last live row at 30 edges
    cut = int(rp[4]) + 30
    assert bu_ops.loaded_edges_plain(rp, ue, fw, cv, cut) == want - 50 + 30
