"""The readers of the port's own spans and counters on hand-built traces:
the level partition (``topdown_ms``, ``bottomup_ms``), the idle after
the loop's reads (``sync_idle_ms``), device times drifting from the
host's, a read's copy cut off by the window, a level that mixes
directions, a program without the spans, and ``bottomup_read_ratio``'s
call lists."""
from __future__ import annotations

import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch

from bench import devtrace, spans
from bench.spans import READ
from bench.run import load_reader
from bench.tiny import REPO

Ev = namedtuple("Ev", "name time_range device_type thread is_user_annotation")
Rng = namedtuple("Rng", "start end")


class _Prof:
    def __init__(self, evs):
        self._evs = evs

    def events(self):
        return self._evs


def _trace(host, ops, searches=1):
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [Ev("bench.window", Rng(0, 1000), cpu, 1, False),
           Ev("bench.call", Rng(0, 900), cpu, 1, False),
           Ev("bench.sync", Rng(900, 1000), cpu, 1, False)]
    evs += [Ev(n, Rng(s, e), cpu, 1, False) for n, s, e in host]
    # a span's annotation on the device's timeline is no operation
    evs += [Ev(n, Rng(s, e), gpu, 1, True) for n, s, e in host]
    evs += [Ev(n, Rng(s, e), gpu, 0, False) for n, s, e in ops]
    return devtrace.DeviceTrace(_Prof(evs), searches)


# one search: the start and its read, a top-down, a bottom-up and a
# top-down level, each a step and a read; the last read ends the search.
# Each read is a reduction and a device-to-host copy on the card.
HOST = [("bfs.search", 10, 890), ("bfs.start", 20, 100),
        ("bfs.tail", 60, 100),
        ("bfs.td", 110, 200), ("bfs.expand", 110, 150),
        ("bfs.tail", 200, 260),
        ("bfs.bu", 270, 500), ("bfs.discover", 300, 480),
        ("bfs.tail", 500, 560),
        ("bfs.td", 570, 700), ("bfs.tail", 700, 800)]
D2H = "Memcpy DtoH (Device -> Pageable)"
OPS = [("fill", 30, 50), ("reduce", 65, 85), (D2H, 85, 90),
       ("spmsv_walk", 120, 180), ("reduce", 210, 235), (D2H, 235, 240),
       ("bottomup_substep_kernel", 280, 450), ("reduce", 505, 545),
       (D2H, 545, 550),
       ("copy", 575, 690), ("copy", 600, 650), ("reduce", 710, 785),
       (D2H, 785, 790), ("fill", 905, 950)]


def _run(trace=None, **records):
    return SimpleNamespace(trace=trace, records=dict(records))


def _read(name, run):
    return load_reader(REPO, name).read(run)


def _shift(ops, dt):
    return [(n, s + dt, e + dt) for n, s, e in ops]


def test_levels_partition_the_device_work():
    t = _trace(HOST, OPS)
    assert t.seconds() == pytest.approx(sum(e - s for _, s, e in OPS) * 1e-6)
    # each level's ops after the read before it, through its own read,
    # as a union: 60 + 25 + 5; 170 + 40 + 5; 115 + 75 + 5 (the copy at
    # 600 lies inside the one at 575)
    assert spans.Window(t).level_busy() == pytest.approx({"td": 285.0,
                                                          "bu": 215.0})
    assert _read("topdown_ms", _run(t)) == pytest.approx(0.285)
    assert _read("bottomup_ms", _run(t)) == pytest.approx(0.215)
    assert 0.285 + 0.215 < t.busy_s * 1e3   # bfs.start's and the harness's


def test_levels_divide_by_the_searches():
    t = _trace(HOST, OPS, searches=5)
    assert _read("topdown_ms", _run(t)) == pytest.approx(0.285 / 5)


def test_idle_after_each_read_that_the_search_goes_on_from():
    t = _trace(HOST, OPS)
    # from the start's copy (90 -> 120), level 0's (240 -> 280) and
    # level 1's (550 -> 575); the last read ends the search
    assert spans.Window(t).tail_gaps() == pytest.approx([30, 40, 25])
    assert _read("sync_idle_ms", _run(t)) == pytest.approx(0.095)


@pytest.mark.parametrize("dt", [-55, -7, 3, 45])
def test_device_times_drifting_from_the_host_move_nothing(dt):
    """The device ops are placed by the reads' copies, not by comparing
    their times with the host spans'."""
    t = _trace(HOST, _shift(OPS, dt))
    w = spans.Window(t)
    assert w.level_busy() == pytest.approx({"td": 285.0, "bu": 215.0})
    assert w.tail_gaps() == pytest.approx([30, 40, 25])


def test_a_first_copy_cut_off_by_the_window_skips_its_level():
    # device times 100 us early: the start's ops and its read's copy fall
    # before the window and are cut; the reads pair from the window's end
    t = _trace(HOST, _shift(OPS, -100))
    assert sum(READ in n for n, _, _ in t.ops) == 3
    w = spans.Window(t)
    assert w.level_busy() == pytest.approx({"td": 195.0, "bu": 215.0})
    assert w.tail_gaps() == pytest.approx([40, 25])


def test_a_last_copy_cut_off_pairs_the_reads_from_the_start():
    # device times late: the last read's copy falls past the window's end
    t = _trace(HOST, [op for op in OPS if op[1] != 785])
    w = spans.Window(t)
    assert w.copy == {0: 2, 1: 5, 2: 8}
    assert w.level_busy() == pytest.approx({"td": 90.0, "bu": 215.0})
    assert w.tail_gaps() == pytest.approx([30, 40, 25])


def test_more_copies_than_reads_read_nothing():
    t = _trace(HOST, OPS + [(D2H, 960, 965)])
    for name in ("topdown_ms", "bottomup_ms", "sync_idle_ms"):
        assert _read(name, _run(t)) is None


def test_two_pods_in_one_level():
    host = [("bfs.search", 10, 890), ("bfs.start", 20, 100),
            ("bfs.tail", 60, 80), ("bfs.tail", 80, 100),
            ("bfs.bu", 110, 200), ("bfs.bu", 200, 300),
            ("bfs.tail", 300, 350), ("bfs.tail", 350, 400),
            ("bfs.td", 410, 500), ("bfs.td", 500, 600),
            ("bfs.tail", 600, 650), ("bfs.tail", 650, 700)]
    ops = [(D2H, 70, 75), (D2H, 90, 95),
           ("a", 120, 190), ("b", 210, 290), ("r", 310, 335),
           (D2H, 335, 340), ("r", 360, 385), (D2H, 385, 390),
           ("c", 420, 480), ("r", 610, 635), (D2H, 635, 640),
           ("r", 660, 685), (D2H, 685, 690)]
    t = _trace(host, ops, searches=2)
    # bu: 70 + 80 + 30 + 30; td: 60 + 30 + 30
    assert _read("bottomup_ms", _run(t)) == pytest.approx(0.210 / 2)
    assert _read("topdown_ms", _run(t)) == pytest.approx(0.120 / 2)
    # pod 0's read is followed by pod 1's reduction; the last read ends
    # the search
    assert spans.Window(t).tail_gaps() == pytest.approx([15, 25, 20, 30,
                                                         20])


def test_a_level_mixing_directions_reads_nothing():
    host = [("bfs.search", 10, 890), ("bfs.start", 20, 100),
            ("bfs.tail", 60, 100), ("bfs.td", 110, 200),
            ("bfs.bu", 200, 300), ("bfs.tail", 300, 350),
            ("bfs.tail", 350, 400)]
    ops = [(D2H, 85, 90), ("a", 120, 190), (D2H, 335, 340),
           (D2H, 385, 390)]
    t = _trace(host, ops)
    assert spans.Window(t).level_busy() is None
    assert _read("topdown_ms", _run(t)) is None
    assert _read("bottomup_ms", _run(t)) is None


@pytest.mark.parametrize("name", ["topdown_ms", "bottomup_ms",
                                  "sync_idle_ms"])
def test_a_program_without_the_spans_reads_nothing(name):
    t = _trace([], [op for op in OPS if READ not in op[0]])
    assert _read(name, _run(t)) is None
    assert _read(name, _run(None)) is None
    assert _read(name, _run(_trace(HOST, []))) is None


@pytest.mark.parametrize("need,loaded,want", [
    ([10, 20], [15, 30], 1.5), ([10, 20], [15], None), ([], [], None),
    ([10, 20], [], None), ([0], [0], None)])
def test_read_ratio_over_equal_call_lists(need, loaded, want):
    run = _run(**{"bottomup_read_ratio": need,
                  "bottomup_read_ratio.loaded": loaded})
    assert _read("bottomup_read_ratio", run) == want


def _tiny_search(run, reader):
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.engine import plan_bfs
    from repro_torch.graph.formats import build_blocked
    from repro_torch.graph.rmat import rmat_graph
    from repro_torch.launch.mesh import make_local_mesh
    g = build_blocked(rmat_graph(8, 16, seed=2, device="cpu"), 1, 1,
                      align=32, cap_pad=32)
    eng = plan_bfs(g, BFSConfig(decomposition="2d", instrument=False),
                   make_local_mesh(1, 1, device="cpu"),
                   local_mode="kernel").compile()
    with reader.wrap(run):
        eng.search(int(torch.argmax(g.deg_A.reshape(-1))))


def test_read_ratio_records_the_need_and_no_load_on_the_cpu():
    reader = load_reader(REPO, "bottomup_read_ratio")
    run = _run()
    _tiny_search(run, reader)
    assert run.records["bottomup_read_ratio"]     # the entry's calls
    assert run.records["bottomup_read_ratio.loaded"] == []   # no kernel
    assert reader.read(run) is None


def test_read_ratio_without_the_recorder_reads_nothing(monkeypatch):
    import repro_torch.kernels.bottomup.ops  # noqa: F401  (the entry)
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    reader = load_reader(REPO, "bottomup_read_ratio")
    run = _run()
    with reader.wrap(run):
        pass
    assert reader.read(run) is None
