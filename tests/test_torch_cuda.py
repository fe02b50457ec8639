"""On a CUDA card: each of the port's CUDA kernels against its plain
PyTorch version, tolerance 0 (the outputs are integers).  Imports no
JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode)."""
import pytest
import torch

from repro_torch.core.frontier import pack_bits
from repro_torch.graph import rmat
from repro_torch.graph.formats import build_blocked
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.spmsv import ops as sp_ops

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph(dev):
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    return build_blocked(e, 2, 2, align=32, cap_pad=32)


def test_spmsv_kernel_matches_plain(graph, dev):
    part = graph.part
    cp, ri = graph.col_ptr[1, 0], graph.row_idx[1, 0]
    lens = cp[1:] - cp[:-1]
    g = torch.Generator(device=dev).manual_seed(0)
    top = torch.zeros(part.nc, dtype=torch.bool, device=dev)
    top[torch.argmax(lens)] = True
    fronts = [torch.zeros(part.nc, dtype=torch.bool, device=dev), top]
    for frac in (0.01, 0.3, 1.0):
        fronts.append(torch.rand(part.nc, generator=g, device=dev) < frac)
    for mask in fronts:
        got = sp_ops.spmsv_csr_min(mask, cp, ri, part.nr, part.nc)
        ids, offs, total = sp_ops.prepare(mask, cp)
        want = sp_ops.spmsv_csr_min_plain(ids, offs, total, cp, ri, part.nr,
                                          part.nc)
        assert torch.equal(got, want)


def test_bottomup_kernel_matches_plain(graph, dev):
    part, chunk = graph.part, graph.part.chunk
    seg = 1
    e0, e1 = (int(x) for x in graph.seg_ptr[1, 0, seg:seg + 2])
    rp = graph.row_ptr[1, 0, seg * chunk:(seg + 1) * chunk + 1] - e0
    ue = graph.col_idx[1, 0, e0:e0 + graph.cap_seg]
    g = torch.Generator(device=dev).manual_seed(1)
    for ff in (0.0, 0.5, 1.0):
        fw = pack_bits(torch.rand(part.nc, generator=g, device=dev) < ff)
        for df in (0.0, 0.5, 1.0):
            cv = (torch.rand(chunk, generator=g, device=dev) < df).to(
                torch.int32)
            got = bu_ops.bottomup_substep(rp, ue, fw, cv, part.nc, e1 - e0)
            want = bu_ops.bottomup_substep_plain(rp, ue, fw, cv, part.nc,
                                                 e1 - e0)
            assert torch.equal(got, want)


@pytest.mark.parametrize("start,count", [(0, 16 << 12), (12345, 777),
                                         ((16 << 12) - 1000, 1000)])
def test_rmat_counter_kernel_matches_plain(dev, start, count):
    got = rmat.rmat_edges_counter(12, 16, seed=3, start=start, count=count,
                                  device=dev)
    want = rmat.rmat_edges_counter_plain(12, 16, seed=3, start=start,
                                         count=count, device=dev)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_launch_counts_grow(graph, dev):
    kernels = (sp_ops.KERNEL, bu_ops.KERNEL, rmat.RMAT_COUNTER)
    before = [k.launches for k in kernels]
    mask = torch.arange(graph.part.nc, device=dev) < 8
    sp_ops.spmsv_csr_min(mask, graph.col_ptr[0, 0], graph.row_idx[0, 0],
                         graph.part.nr, 0)
    chunk = graph.part.chunk
    bu_ops.bottomup_substep(
        graph.row_ptr[0, 0, :chunk + 1].contiguous(),
        graph.col_idx[0, 0, :graph.cap_seg],
        torch.full((graph.part.nc // 32,), -1, dtype=torch.int32, device=dev),
        torch.zeros(chunk, dtype=torch.int32, device=dev), 0,
        int(graph.seg_ptr[0, 0, 1]))
    rmat.rmat_edges_counter(8, 16, count=64, device=dev)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
