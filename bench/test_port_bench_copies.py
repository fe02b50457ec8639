"""The yardstick's frozen copies read what their originals read, at small
sizes: the counter R-MAT stream, kernel 1's ``forward_cost``, kernel
2's ``bottomup_bytes``, the TEPS arithmetic; the reference's parents
against an independent search and the port's tree checks; the trace
reduction on a made-up profile."""
from __future__ import annotations

import importlib.util
import random
from collections import namedtuple

import numpy as np
import pytest
import torch

from bench import costs, devtrace, graphs, reference
from bench.tiny import REPO


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale, ef, seed, start, count", [
    (8, 4, 1, 0, None), (10, 16, 4294967311, 0, None), (9, 8, 7, 123, 777)])
def test_counter_stream_equals_the_ports(monkeypatch, scale, ef, seed, start,
                                         count):
    from repro_torch.graph.rmat import rmat_edges_counter_plain
    monkeypatch.setattr(graphs, "CHUNK", 1000)      # several chunks
    got = graphs.rmat_counter(scale, ef, 0.57, 0.19, 0.19, seed, "cpu",
                              start, count)
    want = rmat_edges_counter_plain(scale, ef, 0.57, 0.19, 0.19, seed,
                                    start, count)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kron_relabels_by_a_permutation():
    cfg = {"graph": "kron", "instance_seed": 5, "scale": 9,
           "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
    plain = graphs.edges(dict(cfg, relabel=False), "cpu")
    moved = graphs.edges(dict(cfg, relabel=True), "cpu")
    deg = [torch.bincount(torch.cat(e), minlength=512).sort().values
           for e in (plain, moved)]
    assert torch.equal(deg[0], deg[1])
    assert not torch.equal(plain[0], moved[0])
    assert torch.equal(graphs.edges(cfg, "cpu")[0],
                       graphs.edges(cfg, "cpu")[0])


def test_urand_is_uniform_and_seeded():
    cfg = {"graph": "urand", "instance_seed": 3, "scale": 10,
           "edge_factor": 16}
    src, dst = graphs.edges(cfg, "cpu")
    assert src.shape[0] == 16 << 10 and src.dtype == torch.int32
    assert 0 <= int(src.min()) and int(dst.max()) < 1 << 10
    assert torch.equal(src, graphs.edges(cfg, "cpu")[0])
    counts = torch.bincount(torch.cat([src, dst]), minlength=1 << 10)
    assert abs(float(counts.float().mean()) - 32.0) < 1e-6
    assert float(counts.float().std()) < 10.0


def test_keys_have_edges_and_the_seed_orders_them():
    cfg = {"graph": "kron", "instance_seed": 2, "scale": 10,
           "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
    src, dst = graphs.edges(cfg, "cpu")
    keys = graphs.search_keys(src, dst, 1 << 10, 64, 2)
    assert len(set(keys)) == 64
    keep = src != dst
    touched = set(src[keep].tolist()) | set(dst[keep].tolist())
    assert set(keys) <= touched
    a, b = graphs.order(keys, 1), graphs.order(keys, 2)
    assert sorted(a) == sorted(b) == sorted(keys) and a != b


@pytest.mark.parametrize("addressing", ["csr", "dcsc", "strips"])
def test_forward_cost_equals_the_ports(addressing):
    from repro_torch.kernels.spmsv.ops import forward_cost
    rng = random.Random(addressing)
    for _ in range(20):
        args = (addressing, rng.randrange(10**6), rng.randrange(10**9),
                rng.randrange(1, 10**7))
        kw = {"p": rng.randrange(1, 17), "n_words": rng.randrange(10**6)}
        assert costs.forward_cost(*args, **kw) == forward_cost(*args, **kw)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bottomup_bytes_equals_chip_smokes():
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    chunk = 300
    lens = torch.randint(0, 9, (chunk,), generator=g)
    rp = torch.zeros(chunk + 1, dtype=torch.int32)
    rp[1:] = torch.cumsum(lens, 0)
    uew = torch.randint(0, 2048, (int(rp[-1]) + 5,), generator=g,
                        dtype=torch.int32)
    fw = torch.randint(-2**31, 2**31 - 1, (64,), generator=g,
                       dtype=torch.int32)
    cv = (torch.rand(chunk, generator=g) < 0.3).to(torch.int32)
    assert costs.bottomup_bytes(rp, uew, fw, cv) == \
        smoke.bottomup_bytes(rp, uew, fw, cv)


def test_teps_equals_the_ports_and_the_harmonic_mean():
    from repro_torch.core.metrics import harmonic_mean, teps
    times = [0.012, 0.0135, 0.0141, 0.011]
    m = 1 << 28
    assert costs.teps(m, 0.25) == teps(m, 0.25)
    # all the work over all the time is the harmonic mean of the TEPS
    per = [teps(m, t) for t in times]
    assert costs.teps(m * len(times), sum(times)) == \
        pytest.approx(harmonic_mean(per), rel=1e-12)


def _min_parent_bfs(n, src, dst, root):
    adj = [[] for _ in range(n)]
    for u, v in zip(src, dst):
        if u != v:
            adj[u].append(v)
            adj[v].append(u)
    level = [-1] * n
    level[root] = 0
    front = [root]
    while front:
        nxt = []
        for u in front:
            for v in adj[u]:
                if level[v] < 0:
                    level[v] = level[u] + 1
                    nxt.append(v)
        front = nxt
    par = [-1] * n
    for v in range(n):
        if level[v] > 0:
            par[v] = min(u for u in adj[v] if level[u] == level[v] - 1)
    par[root] = root
    return par


@pytest.mark.parametrize("graph", ["kron", "urand"])
def test_reference_parents(graph):
    from repro_torch.core.ref import validate_parents
    cfg = {"graph": graph, "instance_seed": 9, "scale": 8, "edge_factor": 4,
           "a": 0.57, "b": 0.19, "c": 0.19}
    src, dst = graphs.edges(cfg, "cpu")
    n = 1 << 8
    rs, rd = reference.build(src, dst)
    keys = graphs.search_keys(src, dst, n, 8, 9)
    for root in keys:
        got = reference.parents(n, rs, rd, root)
        want = _min_parent_bfs(n, src.tolist(), dst.tolist(), root)
        assert got.tolist() == want
        ctl = reference.parents(n, rs, rd, root, rule="max")
        s, d = rs.numpy(), rd.numpy()
        assert validate_parents(n, s, d, root, ctl.numpy())[0]
        assert validate_parents(n, s, d, root, got.numpy())[0]
        assert reference.wrong_parents(got, got) == 0


def test_kernel_names_and_matcher():
    from repro_torch.kernels.build import CSRC
    names = devtrace.kernel_names(CSRC)
    assert {"spmsv_walk", "prep_kernel", "bottomup_substep_kernel"} <= \
        set(names)
    port = devtrace.matcher(names)
    assert port("void (anonymous namespace)::spmsv_walk<(anonymous "
                "namespace)::Csr>((anonymous namespace)::Csr, int)")
    assert port("(anonymous namespace)::bottomup_substep_kernel(int const*)")
    assert not port("void at::native::reduce_kernel<512, 1>(int)")
    assert not port("Memcpy DtoD (Device -> Device)")


Ev = namedtuple("Ev", "name time_range device_type thread")
Rng = namedtuple("Rng", "start end")


class _Prof:
    def __init__(self, evs):
        self._evs = evs

    def events(self):
        return self._evs


def test_trace_reduction_on_a_made_up_profile():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    evs = [Ev("bench.window", Rng(0, 100), cpu, 1),
           Ev("bench.call", Rng(0, 70), cpu, 1),
           Ev("aten::nonzero", Rng(10, 40), cpu, 1),
           Ev("cudaStreamSynchronize", Rng(20, 40), cpu, 1),
           Ev("bench.sync", Rng(70, 100), cpu, 1),
           Ev("bench.call", Rng(0, 70), gpu, 1),      # an annotation
           Ev("spmsv_walk<Csr>(int)", Rng(5, 20), gpu, 0),
           Ev("reduce_kernel<1>(int)", Rng(15, 25), gpu, 0),
           Ev("reduce_kernel<1>(int)", Rng(50, 90), gpu, 0)]
    t = devtrace.DeviceTrace(_Prof(evs), searches=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(60e-6)
    assert t.seconds(devtrace.matcher(["spmsv_walk"])) == pytest.approx(15e-6)
    assert t.seconds() == pytest.approx(65e-6)
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"bench.call": 5e-6,
                                  "aten::nonzero > cudaStreamSynchronize":
                                  25e-6, "bench.sync": 10e-6})
    assert t.device_ops()[0] == ["reduce_kernel<1>(int)",
                                 pytest.approx(50e-6)]
    assert np.isclose(t.busy_s / t.window_s, 0.6)
