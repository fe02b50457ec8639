"""``level_epilogue_roofline``: its frozen bytes against the port's
``level_bytes`` on the epilogue's cases, its reading of a hand-built
trace, and nothing read where the launch is gone or never ran."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.costs import HBM_BYTES_PER_S
from bench.run import load_reader
from bench.test_port_bench_spans import _trace
from bench.tiny import REPO

NAME = "level_epilogue_roofline"
INF = 2**31 - 1


def _slot_reads(pi, cand, recv) -> int:
    """The later slots each unvisited vertex reads up to its first find,
    vertex by vertex."""
    if recv is None:
        return 0
    pi, cand, recv = pi.numpy(), cand.numpy(), recv.numpy()
    pr, pc, chunk = pi.shape
    reads = 0
    for i in range(pr):
        for q in range(pc):
            for v in range(chunk):
                if pi[i, q, v] != -1 or cand[i, q, v] != INF:
                    continue
                for s in range(1, pc):
                    reads += 1
                    if recv[i, q, (q + s) % pc, v] != INF:
                        break
    return reads


@pytest.mark.parametrize("grid", [(1, 1, 64), (2, 2, 64), (1, 4, 96)])
def test_bytes_equal_the_ports(grid):
    from repro_torch.kernels import edge_cases
    from repro_torch.kernels.epilogue import ops
    reader = load_reader(REPO, NAME)
    for name, (pi, deg, cand, recv, root) in edge_cases.epilogue_cases(
            *grid).items():
        un, newly, reads = reader.counts(pi, cand, recv, root).tolist()
        got = reader.launch_bytes(pi.numel(), un, newly, reads, cand is None)
        pi0 = pi.clone()
        n_f = int(ops.level_epilogue_plain(pi, deg, cand, recv, root)
                  .masses[0])
        want = ops.level_bytes(pi0.numel(), int((pi0 == -1).sum()), n_f,
                               0 if cand is None else
                               _slot_reads(pi0, cand, recv),
                               start=cand is None)[1]
        assert (newly, got) == (n_f, want), name


def _launch_run(n_launches):
    ops = [("level_epilogue_kernel", 100 * k, 100 * k + 40)
           for k in range(n_launches)] + [("reduce", 500, 560)]
    c = torch.tensor([1000, 10, 0])
    return SimpleNamespace(trace=_trace([], ops),
                           records={NAME: [(4096, False, c), (4096, True,
                                                              c)]})


def test_reads_the_bytes_over_the_kernels_time():
    reader = load_reader(REPO, NAME)
    nbytes = sum(reader.launch_bytes(4096, 1000, 10, 0, start)
                 for start in (False, True))
    want = 100.0 * nbytes / HBM_BYTES_PER_S / 80e-6
    assert reader.read(_launch_run(2)) == pytest.approx(want)
    assert reader.read(_launch_run(3)) is None      # the counts disagree


def test_without_the_launch_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.kernels.epilogue.ops",
                        None)
    reader = load_reader(REPO, NAME)
    run = SimpleNamespace(trace=None, records={})
    with reader.wrap(run):
        pass
    assert run.records[NAME] == [] and reader.read(run) is None


def test_a_cpu_search_launches_nothing():
    from bench.test_port_bench_spans import _run, _tiny_search
    reader = load_reader(REPO, NAME)
    run = _run()
    _tiny_search(run, reader)
    assert run.records[NAME] == []              # the plain twin ran
    assert reader.read(run) is None


def test_counts_at_a_start():
    reader = load_reader(REPO, NAME)
    pi = torch.full((1, 1, 64), -1, dtype=torch.int32)
    assert reader.counts(pi, root=5).tolist() == [64, 1, 0]
    assert np.array_equal(pi.numpy(), np.full((1, 1, 64), -1))
