"""The readers of the 2D grid's cell: ``grid_exchange_ms`` on hand-built
traces (the expand and the stack and fold of each top-down level, placed
by device order; nothing without the kernels that delimit them or without
the spans) and ``wire_mb_per_search`` on the port's ``wire_bytes``
counter, against a ``ScheduleRecorder`` over the same searches."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from bench.run import load_reader
from bench.test_port_bench_spans import D2H, _shift, _trace
from bench.tiny import REPO, make_root, result_of, run_command

PREP = "void walk::prep_kernel<(anonymous namespace)::FrontierWords>(int)"
WALK = "void (anonymous namespace)::spmsv_walk<(anonymous namespace)::Dcsc>(int)"
EPI = "(anonymous namespace)::level_epilogue_kernel((anonymous namespace)::Slots)"

# one search: the start and its read, then two top-down levels, each a
# step and a read
HOST = [("bfs.search", 10, 890), ("bfs.start", 20, 100),
        ("bfs.tail", 60, 100),
        ("bfs.td", 110, 400), ("bfs.tail", 400, 460),
        ("bfs.td", 470, 700), ("bfs.tail", 700, 800)]
# level 0: expand 10 + 8; two blocks' prep and walk; stack 30, ring 20
# and 10 past its overlap; level 1: expand 10; one block; stack and ring
# 20.  The epilogue and the read's copy count in neither part.
OPS = [("fill", 30, 50), (EPI, 55, 80), (D2H, 85, 90),
       ("index_elementwise_kernel", 100, 110), ("copy", 112, 120),
       (PREP, 120, 125), (WALK, 125, 160), (PREP, 162, 165), (WALK, 165, 200),
       ("CatArrayBatchedCopy", 200, 230), ("roll_cuda_kernel", 230, 250),
       ("minimum_kernel", 245, 260), (EPI, 260, 280), (D2H, 280, 285),
       ("index_elementwise_kernel", 480, 490), (PREP, 490, 495),
       (WALK, 495, 600), ("CatArrayBatchedCopy", 600, 610),
       ("roll_cuda_kernel", 610, 620), (EPI, 620, 640), (D2H, 640, 645)]


def _read(name, run):
    return load_reader(REPO, name).read(run)


def _run(trace=None, **records):
    return SimpleNamespace(trace=trace, records=dict(records))


@pytest.mark.parametrize("dt", [-55, 0, 37, 300])
def test_grid_exchange_parts_by_device_order(dt):
    """(18 + 60) + (10 + 20) us over one search, wherever the device
    times lie against the host spans."""
    t = _trace(HOST, _shift(OPS, dt))
    assert _read("grid_exchange_ms", _run(t)) == pytest.approx(0.108)


def test_grid_exchange_divides_by_the_searches():
    t = _trace(HOST, OPS, searches=4)
    assert _read("grid_exchange_ms", _run(t)) == pytest.approx(0.108 / 4)


def test_grid_exchange_leaves_out_bottom_up_levels():
    host = [(("bfs.bu" if s == 470 else n), s, e) for n, s, e in HOST]
    t = _trace(host, OPS)
    assert _read("grid_exchange_ms", _run(t)) == pytest.approx(0.078)


@pytest.mark.parametrize("gone", [PREP, WALK, EPI])
def test_grid_exchange_reads_nothing_without_its_kernels(gone):
    ops = [op for op in OPS if op[0] != gone]
    assert _read("grid_exchange_ms", _run(_trace(HOST, ops))) is None


def test_grid_exchange_reads_nothing_without_the_spans():
    t = _trace([("bfs.search", 10, 890)], OPS)
    assert _read("grid_exchange_ms", _run(t)) is None
    assert _read("grid_exchange_ms", _run(None)) is None


def test_wire_mb_reads_the_port_counter():
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core import collectives
    from repro_torch.core.engine import plan_bfs
    from repro_torch.graph.formats import build_blocked
    from repro_torch.graph.rmat import rmat_graph
    from repro_torch.launch.mesh import make_local_mesh
    g = build_blocked(rmat_graph(9, 16, seed=5, device="cpu"), 4, 4,
                      align=32, cap_pad=32)
    eng = plan_bfs(g, BFSConfig(decomposition="2d", storage="dcsc",
                                direction_optimizing=False, instrument=False),
                   make_local_mesh(4, 4, device="cpu")).compile()
    deg = g.deg_A.reshape(-1)
    roots = [int(torch.argmax(deg)), int(torch.nonzero(deg).reshape(-1)[0])]
    mod = load_reader(REPO, "wire_mb_per_search")
    run = _run()
    with mod.wrap(run):
        for r in roots:
            eng.search(r)
    with collectives.ScheduleRecorder() as sched:
        for r in roots:
            eng.search(r)
    want = sum(r.nbytes for r in sched.records) / len(roots) * 1e-6
    assert want > 0
    assert mod.read(run) == pytest.approx(want, rel=1e-12)
    # the same searches in another order: the same mean
    again = _run()
    with mod.wrap(again):
        for r in reversed(roots):
            eng.search(r)
    assert mod.read(again) == mod.read(run)
    # nothing recorded, or a program without the counter: no value
    assert mod.read(_run()) is None
    assert mod.read(_run(wire_mb_per_search=[None, None])) is None


def test_grid_cell_traced_on_cpu_reports_its_counter(tmp_path):
    """The cell's traced run through the plain versions: the set-up
    readers and the counter read, the device readers find nothing."""
    root = make_root(tmp_path, traffic={"keys": 8, "checked_calls": 2})
    args = ["--workload", "kron-s24-4x4-dcsc-td", "--seed", "2718281829",
            "--seconds", "0.5", "--trace", "1", "--device", "cpu"]
    proc = run_command(root, args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result_of(proc)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"build_s", "compile_s",
                                   "wire_mb_per_search"}
    wire = res["metrics"]["wire_mb_per_search"]
    assert wire["unit"] == "MB/search" and wire["value"] > 0
