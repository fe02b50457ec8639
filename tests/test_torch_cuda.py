"""On a CUDA card: each of the port's CUDA kernels against its plain
PyTorch version: tolerance 0 for the graph kernels (integer outputs)
and for the EmbeddingBag and its gradient (the same float32 operations
in the same order); the attention kernel within ``fa_ref.tolerance``
and its gradient within ``fa_ref.backward_tolerance``.  Imports no JAX, so
it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips (the kernels have no CPU mode)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core.engine import plan_bfs
from repro_torch.core.frontier import pack_bits, unpack_bits
from repro_torch.graph import rmat
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.kernels import edge_cases as ec
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.epilogue import ops as ep_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.frontier_codec import ops as codec_ops
from repro_torch.kernels.frontier_codec import ref as codec_ref
from repro_torch.kernels.spmsv import ops as sp_ops
from repro_torch.kernels.spmsv import strip
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d

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


@pytest.mark.parametrize("scale", range(1, 31))
def test_rmat_counter_kernel_at_every_scale(dev, scale):
    """Each scale's instantiation, bit for bit against the plain version,
    on slices at the start, middle and end of the stream, and across the
    counter's 2**32 wrap where the stream passes it (scales 29, 30)."""
    m = 16 << scale
    n = min(m, 4096)
    slices = [(0, n), (m // 2 - n // 2, n), (m - n, n)]
    if m > 1 << 32:
        slices.append(((1 << 32) - 2000, 4000))
    for start, count in slices:
        got = rmat.rmat_edges_counter(scale, 16, seed=scale, start=start,
                                      count=count, device=dev)
        want = rmat.rmat_edges_counter_plain(scale, 16, seed=scale,
                                             start=start, count=count,
                                             device=dev)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), start


@pytest.mark.parametrize("scale", [0, 31])
def test_rmat_counter_kernel_rejects_scales_it_lacks(dev, scale):
    with pytest.raises(ValueError):
        rmat.rmat_edges_counter(scale, 1, count=1, device=dev)


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


@pytest.fixture(scope="module")
def graph_1d(dev):
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    return build_blocked_1d(e, 16, align=32, cap_pad=32)


def _strip_fronts(n, dev):
    g = torch.Generator(device=dev).manual_seed(2)
    fronts = [torch.zeros(n, dtype=torch.bool, device=dev),
              torch.arange(n, device=dev) == 0]
    for frac in (0.01, 0.3, 1.0):
        fronts.append(torch.rand(n, generator=g, device=dev) < frac)
    return fronts


def test_strip_kernels_match_plain(graph_1d, dev):
    g, part = graph_1d, graph_1d.part
    for mask in _strip_fronts(part.n, dev):
        fw = pack_bits(mask)
        got = strip.spmsv_strip_dcsc(g.jc, g.cp, g.nzc, g.row_idx, fw,
                                     part.chunk)
        want = strip.spmsv_strip_dcsc_plain(g.jc, g.cp, g.nzc, g.row_idx,
                                            fw, part.chunk)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        words = fw.reshape(part.p, -1)
        for c in (2, 4):
            for k in range(c):
                sub = words.reshape(part.p, c, -1)[:, k].reshape(-1)
                sub = sub.contiguous()
                got = strip.spmsv_strip_dcsc_chunk(
                    g.jc, g.cp, g.nzc, g.row_idx, sub, part.chunk,
                    n=part.n, k=k, n_chunks=c)
                want = strip.spmsv_strip_dcsc_chunk_plain(
                    g.jc, g.cp, g.nzc, g.row_idx, sub, part.chunk, part.n,
                    k, c)
                assert torch.equal(got[0], want[0])
                assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("chunk,cap", [(2, 33), (1000, 40), (1 << 20, 97)])
def test_codec_kernels_match_plain(dev, chunk, cap):
    g = torch.Generator(device=dev).manual_seed(chunk)
    p = 5
    off = torch.randint(0, chunk, (p, cap), generator=g, device=dev,
                        dtype=torch.int32)
    count = torch.tensor([0, 1, cap // 2, cap, cap + 9], dtype=torch.int32,
                         device=dev)
    got = codec_ops.encode_offsets(off, count, chunk)
    want = codec_ref.encode_offsets(off, count, chunk)
    assert torch.equal(got, want)
    n = p * chunk
    got = codec_ops.decode_buckets(want.reshape(-1), chunk, cap, n, p)
    assert torch.equal(got, codec_ref.decode_buckets(want.reshape(-1), chunk,
                                                     cap, n))


def _encode_counts(cap):
    """Counts 0, 1, cap, past cap (clamped), negative (clamped as
    uint32) and one in a block's last thread."""
    return [0, 1, cap, cap + 9, -1, max(1, cap - 3)]


@pytest.mark.parametrize("bits", [1, 7, 18, 20, 31, 32])
@pytest.mark.parametrize("cap", [5, 100, 4097])
@pytest.mark.parametrize("p", [1, 16])
def test_codec_encode_kernel_on_edge_cases(dev, bits, cap, p):
    """The encode kernel at tolerance 0 against the plain encode: caps
    below 32, not a multiple of 32 and one slot past a block; each count
    of ``_encode_counts`` (one launch each at p = 1, all in one at
    p = 16); offsets with bits above ``bits`` set (masked)."""
    chunk = (1 << bits) - 3 if bits > 2 else 1 << bits
    g = torch.Generator(device=dev).manual_seed(bits * 1000 + cap + p)
    off = torch.randint(-2**31, 2**31 - 1, (p, cap), generator=g,
                        device=dev, dtype=torch.int32)
    counts = _encode_counts(cap)
    for c in ([[x] for x in counts] if p == 1
              else [[counts[k % len(counts)] for k in range(p)]]):
        count = torch.tensor(c, dtype=torch.int32, device=dev)
        got = codec_ops.encode_offsets(off, count, chunk)
        assert got.shape == (p, 1 + codec_ops.encode_shape(p, cap, chunk)[1])
        assert torch.equal(got, codec_ref.encode_offsets(off, count, chunk))


@pytest.mark.parametrize("cap,chunk", [(52448, 1 << 20), (13112, 1 << 18)])
def test_codec_encode_kernel_at_the_path_shapes(dev, cap, chunk):
    """The scale-24 1ds path's two encode shapes, 16 buckets of 52,448
    slots at 20 bits (expand_chunks 1) and of 13,112 at 18 (4): counts of
    a few thousand as on the path, and 0, cap and past cap; offsets below
    the chunk, then with high bits set."""
    g = torch.Generator(device=dev).manual_seed(cap)
    p = 16
    off = torch.randint(0, chunk, (p, cap), generator=g, device=dev,
                        dtype=torch.int32)
    count = torch.randint(0, 5000, (p,), generator=g, device=dev,
                          dtype=torch.int32)
    count[:4] = torch.tensor([0, cap, cap + 1, 2**31 - 1])
    for o in (off, off | (1 << 30)):
        got = codec_ops.encode_offsets(o, count, chunk)
        assert torch.equal(got, codec_ref.encode_offsets(o, count, chunk))


@pytest.mark.parametrize("bits", [1, 20, 32])
@pytest.mark.parametrize("cap", [2048, 2049, 2050, 2051, 5])
def test_codec_decode_kernel_on_edge_cases(dev, bits, cap):
    """The decode kernel at tolerance 0 on rows that start and end inside
    a 16-byte vector (cap % 4 of 0 to 3), offsets of 1, 20 (slots that
    span two words) and 32 bits, counts 0, 1, cap and past a block's
    1024 slots, a negative count word, and the sentinel past each
    count."""
    chunk = (1 << bits) - 3 if bits > 2 else 1 << bits
    g = torch.Generator(device=dev).manual_seed(bits * 10 + cap)
    p = 5
    off = torch.randint(-2**31, 2**31 - 1, (p, cap), generator=g,
                        device=dev, dtype=torch.int32)
    if bits < 32:
        off = off.remainder(chunk)
    count = torch.tensor([0, 1, cap, min(cap, 1029), 3], dtype=torch.int32,
                         device=dev)
    recv = codec_ref.encode_offsets(off, count, chunk).reshape(-1).clone()
    recv[4 * (recv.numel() // p)] = -1            # a negative count word
    for n in (12345, 2**31 - 1):
        got = codec_ops.decode_buckets(recv, chunk, cap, n, p)
        assert torch.equal(got, codec_ref.decode_buckets(recv, chunk, cap,
                                                         n))


def test_strip_and_codec_launch_counts_grow(graph_1d, dev):
    """One launch a call, the stacked bottom-up entry's for all p strips
    too; and in a 1ds session one bottom-up launch a bottom-up level."""
    kernels = (strip.KERNEL, strip.KERNEL_CHUNK, codec_ops.ENCODE,
               codec_ops.DECODE, bu_ops.KERNEL)
    before = [k.launches for k in kernels]
    g, part = graph_1d, graph_1d.part
    fw = torch.zeros(part.n // 32, dtype=torch.int32, device=dev)
    strip.spmsv_strip_dcsc(g.jc, g.cp, g.nzc, g.row_idx, fw, part.chunk)
    strip.spmsv_strip_dcsc_chunk(g.jc, g.cp, g.nzc, g.row_idx,
                                 fw[: part.n // 64], part.chunk, n=part.n,
                                 k=1, n_chunks=2)
    off = torch.zeros((part.p, 32), dtype=torch.int32, device=dev)
    cnt = torch.ones(part.p, dtype=torch.int32, device=dev)
    buf = codec_ops.encode_offsets(off, cnt, part.chunk)
    codec_ops.decode_buckets(buf.reshape(-1), part.chunk, 32, part.n, part.p)
    bu_ops.bottomup_substep_strips(
        g.row_ptr, g.col_idx, fw,
        torch.zeros((part.p, part.chunk), dtype=torch.int32, device=dev),
        g.nnz)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    eng = plan_bfs(g, BFSConfig(decomposition="1ds", storage="dcsc"),
                   make_local_mesh_1d(part.p, device=dev),
                   local_mode="kernel").compile()
    root = int(torch.nonzero(g.deg_A.reshape(-1))[0])
    n = bu_ops.KERNEL.launches
    res = eng.run(root)
    n_bu = int((res.level_stats[:res.n_levels, 2] == 1).sum())
    assert n_bu > 0 and bu_ops.KERNEL.launches == n + n_bu


def test_stacked_bottomup_kernel_matches_plain(graph_1d, dev):
    g, part = graph_1d, graph_1d.part
    gen = torch.Generator(device=dev).manual_seed(4)
    for ff in (0.0, 0.05, 0.5, 1.0):
        fw = pack_bits(torch.rand(part.n, generator=gen, device=dev) < ff)
        for df in (0.0, 0.5, 1.0):
            cv = (torch.rand(part.p, part.chunk, generator=gen, device=dev)
                  < df).to(torch.int32)
            got = bu_ops.launch_strips(g.row_ptr, g.col_idx, fw, cv, g.nnz)
            want = bu_ops.bottomup_substep_strips_plain(
                g.row_ptr, g.col_idx, fw, cv, g.nnz)
            assert torch.equal(got, want), (ff, df)


def test_bottomup_kernel_on_edge_cases(dev):
    """Rows of 0-1,100 edges with first hits past edge 32, an edge count
    cutting a row, all rows completed, the frontier in the last word:
    the stacked launch and the single-segment launch of each strip."""
    for name, (rp, ci, fw, cv, ne) in ec.bottomup_cases(
            2, 1 << 15, device=dev).items():
        got = bu_ops.launch_strips(rp, ci, fw, cv, ne)
        want = bu_ops.bottomup_substep_strips_plain(rp, ci, fw, cv, ne)
        assert torch.equal(got, want), name
        for i in range(rp.shape[0]):
            one = bu_ops.launch(rp[i], ci[i], fw, cv[i], 777, int(ne[i]))
            assert torch.equal(one, bu_ops.bottomup_substep_plain(
                rp[i], ci[i], fw, cv[i], 777, int(ne[i]))), (name, i)


def test_bottomup_kernel_counts_the_edges_it_loads(graph_1d, dev):
    """Inside a Recorder kernel 2 adds the edges it loads to a device word
    a launch: the count equals ``loaded_edges_plain``'s re-count of its
    rule (4 head loads a lane, then 32-wide steps up to the first hit
    step) and covers what the inputs need (``bench.costs``'s frozen
    ``bottomup_bytes``); the output is bit for bit the uncounted one's."""
    from bench.costs import bottomup_bytes
    from repro_torch.core import trace
    g, part = graph_1d, graph_1d.part
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = dict(ec.bottomup_cases(2, 1 << 15, device=dev))
    for ff in (0.001, 0.05, 0.5):
        fw = pack_bits(torch.rand(part.n, generator=gen, device=dev) < ff)
        cv = (torch.rand(part.p, part.chunk, generator=gen, device=dev)
              < 0.3).to(torch.int32)
        cases[f"rmat f={ff}"] = (g.row_ptr, g.col_idx, fw, cv, g.nnz)
    for name, (rp, ci, fw, cv, ne) in cases.items():
        plain = []
        for i in range(rp.shape[0]):
            n_i = int(ne[i])
            want = bu_ops.launch(rp[i], ci[i], fw, cv[i], 777, n_i)
            with trace.Recorder() as rec:
                got = bu_ops.launch(rp[i], ci[i], fw, cv[i], 777, n_i)
            assert torch.equal(got, want), (name, i)
            (loaded,) = rec.calls[trace.BOTTOMUP_LOADED]
            plain.append(bu_ops.loaded_edges_plain(rp[i], ci[i], fw, cv[i],
                                                   n_i))
            assert loaded == plain[-1], (name, i)
            if n_i >= int(rp[i, -1]):       # the need counts every edge
                assert loaded >= bottomup_bytes(rp[i], ci[i], fw,
                                                cv[i])[2], (name, i)
        want = bu_ops.launch_strips(rp, ci, fw, cv, ne)
        with trace.Recorder() as rec:
            got = bu_ops.launch_strips(rp, ci, fw, cv, ne)
        assert torch.equal(got, want), name
        assert rec.calls[trace.BOTTOMUP_LOADED] == [sum(plain)], name
    assert trace._ACTIVE is None


def test_search_counts_kernel_2_once_a_call(graph, dev):
    """A traced 2D search keeps one loaded-edge count a kernel-2 call,
    under its search id, and the same parents as an untraced one."""
    from repro_torch.core import trace
    eng = plan_bfs(graph, BFSConfig(decomposition="2d", instrument=False),
                   make_local_mesh(2, 2, device=dev),
                   local_mode="kernel").compile()
    root = int(torch.argmax(graph.deg_A.reshape(-1)))
    want = eng.search(root)[0]
    n = bu_ops.KERNEL.launches
    with trace.Recorder() as rec:
        got = eng.search(root)[0]
    assert torch.equal(got, want)
    calls = rec.calls[trace.BOTTOMUP_LOADED]
    assert len(calls) == bu_ops.KERNEL.launches - n > 0
    assert rec.counters[0][trace.BOTTOMUP_LOADED] == sum(calls) > 0
    assert rec.counters[0]["bu_levels"] > 0


# (pr, pc, chunk): 1x1, 2x2, 1x4 (chunks off the kernel's 32 groups a
# block step), and one 2^22-vertex block, whose grid strides
EPILOGUE_GRIDS = [(1, 1, 96), (2, 2, 64), (1, 4, 32 * 37), (1, 1, 1 << 22)]


@pytest.mark.parametrize("grid", EPILOGUE_GRIDS)
def test_level_epilogue_kernel_matches_plain(dev, grid):
    """Kernel and twin on every case of ``edge_cases.epilogue_cases``,
    one launch after another (each must find the scratch at 0): the same
    parents, words and masses, bit for bit, and no host read."""
    n = ep_ops.KERNEL.launches
    for name, (pi, deg, cand, recv, root) in ec.epilogue_cases(
            *grid, device=dev).items():
        pi_k = pi.clone()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ep_ops.level_epilogue(pi_k, deg, cand, recv, root)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = ep_ops.level_epilogue_plain(pi, deg, cand, recv, root)
        assert torch.equal(pi_k, pi), name
        assert torch.equal(got.words, want.words), name
        assert got.masses.tolist() == want.masses.tolist(), name
    assert ep_ops.KERNEL.launches - n == len(ec.epilogue_cases(1, 1, 32))


def test_level_epilogue_keeps_a_scratch_a_stream(dev):
    """Two launches on two streams, queued before either ends: each
    stream sums into a scratch of its own, so each reports the twin's
    masses."""
    pi, deg, cand, recv, root = ec.epilogue_cases(1, 1, 1 << 22,
                                                  device=dev)["random"]
    want = ep_ops.level_epilogue_plain(pi.clone(), deg, cand, recv, root)
    pis = [pi.clone(), pi.clone()]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    outs = []
    for st, p in zip(streams, pis):
        with torch.cuda.stream(st):
            outs.append(ep_ops.level_epilogue(p, deg, cand, recv, root))
    torch.cuda.synchronize()
    for p, got in zip(pis, outs):
        assert torch.equal(got.words, want.words)
        assert got.masses.tolist() == want.masses.tolist()
    assert {(str(pi.device), st.cuda_stream) for st in streams} <= \
        set(ep_ops._SCRATCH)


def test_search_launches_the_epilogue_each_level(graph, dev):
    """A 2D search on the 2x2 grid and a batch over 2 pods on 1x1: one
    launch a level and pod and one a root at the start, and the
    instrumented run's parents and levels; the instrumented run's
    frontier sizes, masses and modes are the CPU run's (the twin's) bit
    for bit."""
    root = int(torch.argmax(graph.deg_A.reshape(-1)))
    fast = plan_bfs(graph, BFSConfig(decomposition="2d", instrument=False),
                    make_local_mesh(2, 2, device=dev),
                    local_mode="kernel").compile()
    slow = plan_bfs(graph, BFSConfig(decomposition="2d"),
                    make_local_mesh(2, 2, device=dev),
                    local_mode="kernel").compile()
    n = ep_ops.KERNEL.launches
    got = fast.run(root)
    assert ep_ops.KERNEL.launches - n == got.n_levels + 1
    want = slow.run(root)
    assert np.array_equal(got.parents, want.parents)
    assert got.n_levels == want.n_levels
    e_cpu = rmat.rmat_graph(12, 16, seed=1, generator="counter",
                            device="cpu")
    cpu = plan_bfs(build_blocked(e_cpu, 2, 2, align=32, cap_pad=32),
                   BFSConfig(decomposition="2d"),
                   make_local_mesh(2, 2, device="cpu"),
                   local_mode="kernel").compile().run(root)
    assert np.array_equal(cpu.parents, want.parents)
    assert np.array_equal(cpu.level_stats[:, :3], want.level_stats[:, :3])
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    g1 = build_blocked(e, 1, 1, align=32, cap_pad=32)
    batch = plan_bfs(g1, BFSConfig(decomposition="2d", instrument=False),
                     make_local_mesh(1, 1, device=dev, pods=2),
                     local_mode="kernel").compile()
    roots = [int(r) for r in torch.nonzero(g1.deg_A.reshape(-1) > 0)
             .reshape(-1)[[0, 40]]]
    n = ep_ops.KERNEL.launches
    res = batch.run_batch(roots)
    assert ep_ops.KERNEL.launches - n == 2 * (int(res.n_levels[0]) + 1)
    for i, r in enumerate(roots):
        assert np.array_equal(res.parents[i], batch.run(r).parents)


def test_strip_chunk_kernel_walks_match_plain(dev):
    """Both walks (the threshold at its default, at 0 ids and at every
    id) on an empty strip, a 10^4-edge column, sub-range ends, the last
    word and the empty frontier, for 1, 2 and 4 steps."""
    p, chunk = 4, 1 << 14
    g, hub, _ = ec.strip_graph(p, chunk, device=dev)
    n = g.part.n
    walks = set()
    for name, fw in ec.strip_frontiers(p, chunk, hub, device=dev).items():
        for c in (1, 2, 4):
            words = fw.reshape(p, c, -1)
            for k in range(c):
                sub = words[:, k].reshape(-1).contiguous()
                want = strip.spmsv_strip_dcsc_chunk_plain(
                    g.jc, g.cp, g.nzc, g.row_idx, sub, chunk, n, k, c)
                for cap in (strip.list_capacity(g.cap_nzc, c), 0, n // c):
                    cand, ex, walk = strip.launch_chunk(
                        g.jc, g.cp, g.nzc, g.row_idx, sub, chunk, n, k, c,
                        list_cap=cap)
                    assert torch.equal(cand, want[0]), (name, c, k, cap)
                    assert int(ex) == int(want[1]), (name, c, k, cap)
                    assert int(walk) == strip.chunk_walk(sub, cap)
                    walks.add(int(walk))
    assert walks == {strip.WALK_FRONTIER, strip.WALK_COLUMNS}


def _strip_walks_match_plain(g, fronts, chunk):
    """Kernel 3 against its plain version on every frontier with the
    walk threshold at its default, at 0 ids and at every id; returns
    the walks taken."""
    n = g.part.n
    walks = set()
    for name, fw in fronts.items():
        want = strip.spmsv_strip_dcsc_plain(g.jc, g.cp, g.nzc, g.row_idx, fw,
                                            chunk)
        for cap in (None, 0, n):
            cand, ex, walk = strip.launch(g.jc, g.cp, g.nzc, g.row_idx, fw,
                                          chunk, list_cap=cap)
            assert torch.equal(cand, want[0]), (name, cap)
            assert int(ex) == int(want[1]), (name, cap)
            lc = strip.list_capacity(g.cap_nzc, 1) if cap is None else cap
            assert int(walk) == strip.chunk_walk(fw, lc), (name, cap)
            walks.add(int(walk))
    return walks


def test_strip_kernel_walks_match_plain(dev):
    """Kernel 3, both walks, on an empty strip, a 10^4-edge column,
    sub-range ends, the last word and the empty frontier."""
    p, chunk = 4, 1 << 14
    g, hub, _ = ec.strip_graph(p, chunk, device=dev)
    walks = _strip_walks_match_plain(
        g, ec.strip_frontiers(p, chunk, hub, device=dev), chunk)
    assert walks == {strip.WALK_FRONTIER, strip.WALK_COLUMNS}


def test_strip_kernel_takes_40_strips(dev):
    """Kernel 3 has no cap on the strips (kernel 4 takes 32 at most)."""
    p, chunk = 40, 1 << 14
    assert p > strip.MAX_CHUNK_STRIPS
    g, hub, _ = ec.strip_graph(p, chunk, device=dev, edge_factor=1)
    fronts = ec.strip_frontiers(p, chunk, hub, device=dev)
    walks = _strip_walks_match_plain(
        g, {k: fronts[k] for k in ("hub", "sub-range ends", "30%")}, chunk)
    assert walks == {strip.WALK_FRONTIER, strip.WALK_COLUMNS}


def test_strip_kernel_walks_on_a_real_graph(graph_1d, dev):
    g, part = graph_1d, graph_1d.part
    fronts = {i: pack_bits(m) for i, m in enumerate(_strip_fronts(part.n,
                                                                  dev))}
    walks = _strip_walks_match_plain(g, fronts, part.chunk)
    assert walks == {strip.WALK_FRONTIER, strip.WALK_COLUMNS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("n_bags,width,weighted", [
    (300, 1, False), (257, 7, True), (64, 32, False), (1000, 3, True)])
def test_embedding_bag_kernel_matches_plain(dev, dtype, mode, n_bags, width,
                                            weighted):
    g = torch.Generator(device=dev).manual_seed(n_bags + width)
    v, d = 500, 16
    table = torch.randn(v, d, generator=g, device=dev).to(dtype)
    ids = torch.randint(-1, v + 3, (n_bags, width), generator=g, device=dev,
                        dtype=torch.int32)      # padding and ids >= V
    ids[::5] = -1
    w = torch.rand(n_bags, width, generator=g, device=dev) \
        if weighted else None
    got = eb_ops.embedding_bag(table, ids, w, mode=mode)
    want = eb_ref.embedding_bag(table, ids, w, mode=mode)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [16, 8, 32, 17, 3, 1100])
@pytest.mark.parametrize("offset", [0, 1])
def test_embedding_bag_kernel_layouts_match_plain(dev, dtype, dim, offset):
    """Every layout of kernel 8: 16-byte lanes (float32 D 8, 16, 32; bf16
    D 16, 32), one element a lane (an odd D, or a table that starts off
    16 bytes, a view at row ``offset``), and rows wider than a block of
    lanes (D 1,100); bags of one and of 5, sum and weighted mean."""
    g = torch.Generator(device=dev).manual_seed(dim + offset)
    base = torch.randn(301, dim, generator=g, device=dev).to(dtype)
    table = base[offset:]
    aligned = table.data_ptr() % eb_ops.VECTOR_BYTES == 0
    vec, lanes = eb_ops.layout(dim, table.element_size(), aligned)
    if offset == 0 and dim * table.element_size() % 16 == 0:
        assert vec * table.element_size() == 16
    for n_bags, width in ((1000, 1), (257, 5)):
        ids = torch.randint(-1, 305, (n_bags, width), generator=g, device=dev,
                            dtype=torch.int32)
        w = torch.rand(n_bags, width, generator=g, device=dev)
        for ww, mode in ((None, "sum"), (w, "mean")):
            got = eb_ops.embedding_bag(table, ids, ww, mode=mode)
            want = eb_ref.embedding_bag(table, ids, ww, mode=mode)
            assert torch.equal(got, want), (n_bags, width, mode, vec, lanes)


def assert_attention_close(got, q, k, v, **kw):
    """Kernel 9 within ``fa_ref.tolerance`` of its plain version: float32
    (rtol, atol) (2e-5, 2e-5); bfloat16 2**-7 |want| + 2**-7 A + 2e-5,
    A the plain version over |v| (P rounded to bf16 before P V)."""
    want = fa_ref.attention_gqa(q, k, v, **kw).float()
    d = (got.float() - want).abs()
    bound = fa_ref.tolerance(q, k, v, **kw)
    assert bool(torch.isfinite(got.float()).all())
    assert bool((d <= bound).all()), \
        f"off by {float(d.max())} at {int((d > bound).sum())} elements"


# bf16 cases at the head dims 16-128 on both sides of the boundary
# between the key-split path (rep * Sq <= 16) and the tensor cores
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,dh,causal,window,q_off", [
    (128, 128, 64, True, None, 0), (64, 64, 32, False, None, 0),
    (128, 256, 64, True, 64, 0), (1, 256, 64, True, None, 255),
    (64, 192, 128, True, None, 128), (96, 100, 64, True, None, 4),
    (5, 77, 16, False, 9, 70), (16, 300, 16, True, None, 284),
    (17, 300, 16, True, None, 283), (16, 130, 32, True, 40, 114),
    (17, 130, 32, True, 40, 113), (16, 500, 64, True, None, 484),
    (17, 500, 64, False, None, 0), (16, 700, 128, True, 100, 684),
    (17, 700, 128, True, None, 683), (70, 90, 64, False, 20, 5)])
def test_flash_attention_kernel_matches_plain(dev, dtype, sq, sk, dh, causal,
                                              window, q_off):
    g = torch.Generator(device=dev).manual_seed(sq + sk + dh)
    q, k, v = (torch.randn(3, s, 1, dh, generator=g, device=dev).to(dtype)
               for s in (sq, sk, sk))
    kw = dict(causal=causal, window=window, q_offset=q_off)
    got = fa_ops.flash_attention_gqa(q, k, v, **kw)
    assert_attention_close(got, q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_on_a_cache_slice(dev, dtype):
    """The serving call: strided views of the first kv_len keys of a
    longer (B, max_len, Hkv, dh) cache, 9 query heads over 3 kv heads:
    decode (Sq 1, the key splits in bf16), Sq 33 and 70 (the tensor
    cores in bf16)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(2, 70, 9, 64, generator=g, device=dev).to(dtype)
    ck, cv = (torch.randn(2, 200, 3, 64, generator=g, device=dev).to(dtype)
              for _ in range(2))
    for q_off, sq in ((0, 33), (100, 1), (150, 33), (0, 70), (130, 70),
                      (199, 1)):
        kv_len = q_off + sq
        args = (q[:, :sq], ck[:, :kv_len], cv[:, :kv_len])
        got = fa_ops.flash_attention_gqa(*args, q_offset=q_off)
        assert_attention_close(got, *args, q_offset=q_off)


def test_flash_attention_one_kv_head_decode_on_the_tensor_cores(dev):
    """32 query heads over one kv head: a decode row is 32 rows of one kv
    head, more than a key split takes, so it runs on the tensor cores
    with one live row in each 64-row tile."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(2, 1, 32, 64, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2, 300, 1, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    assert fa_ops.plan(2, 1, 32, 1, 300, torch.bfloat16, True, None,
                       299)[0] == "wgmma"
    got = fa_ops.flash_attention_gqa(q, k, v, q_offset=299)
    assert_attention_close(got, q, k, v, q_offset=299)


@pytest.mark.parametrize("window", [1, 3, 20])
def test_flash_attention_window_narrower_than_a_split(dev, window,
                                                      monkeypatch):
    """Decode of 5 rows a query head (15 a kv head) under a window, the
    live keys cut into splits of one key or more: a split outside a
    row's window carries m = -inf for that row and must merge with
    weight 0 (the planner's 32-key floor is lifted here, so that such
    splits occur at all)."""
    monkeypatch.setattr(fa_ops, "MIN_SPLIT_KEYS", 1)
    g = torch.Generator(device=dev).manual_seed(window)
    q = torch.randn(4, 5, 9, 64, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(4, 1500, 3, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(window=window, q_offset=1495)
    path, n = fa_ops.plan(4, 3, 3, 5, 1500, torch.bfloat16, True, **kw)
    lo, hi, span = fa_ops.split_ranges(5, 1500, True, window, 1495, n)
    # the first split lies before the last row's window
    assert path == "split" and n > 1 and lo + span <= 1499 - window
    got = fa_ops.flash_attention_gqa(q, k, v, **kw)
    assert_attention_close(got, q, k, v, **kw)


@pytest.mark.parametrize("dtype,sq,sk,q_off,window", [
    (torch.bfloat16, 96, 160, 64, None),     # prefill: the tensor cores
    (torch.bfloat16, 1, 700, 699, None),     # decode: the key splits
    (torch.bfloat16, 1, 700, 699, 100),
    (torch.float32, 40, 90, 50, 30),         # float32: the CUDA cores
    (torch.float32, 1, 300, 299, None)])
@pytest.mark.parametrize("dh", [80, 48, 8])
def test_flash_attention_kernel_at_head_dims_it_pads(dev, dtype, sq, sk,
                                                     q_off, window, dh):
    """Head dims outside 16/32/64/128 run zero-padded to the next width
    on every path, within ``fa_ref.tolerance``, with the real dh's
    scale; GQA over strided cache slices, as the model calls it."""
    g = torch.Generator(device=dev).manual_seed(dh + sq)
    q = torch.randn(2, sq, 6, dh, generator=g, device=dev).to(dtype)
    ck, cv = (torch.randn(2, sk + 20, 2, dh, generator=g, device=dev)
              .to(dtype) for _ in range(2))
    k, v = ck[:, :sk], cv[:, :sk]
    kw = dict(causal=True, window=window, q_offset=q_off)
    path = fa_ops.plan(2, 2, 3, sq, sk, dtype, **kw)[0]
    assert path == {(torch.float32, True): "cuda_cores",
                    (torch.float32, False): "cuda_cores",
                    (torch.bfloat16, True): "split",
                    (torch.bfloat16, False): "wgmma"}[(dtype, sq == 1)]
    got = fa_ops.flash_attention_gqa(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == dtype
    assert_attention_close(got, q, k, v, **kw)


@pytest.mark.parametrize("dtype,sq,sk,q_off,window,causal", [
    (torch.bfloat16, 96, 160, 64, None, True),     # prefill
    (torch.bfloat16, 1, 700, 699, None, True),     # decode
    (torch.bfloat16, 1, 700, 699, 100, True),
    (torch.float32, 40, 90, 50, 30, True),         # float32
    (torch.float32, 1, 300, 299, None, True),
    (torch.bfloat16, 17, 40, 3, 8, False)])        # no causality
@pytest.mark.parametrize("dh", [129, 160, 256, 320, 1024])
def test_flash_attention_kernel_past_128_on_the_wide_kernel(dev, dtype, sq,
                                                            sk, q_off,
                                                            window, causal,
                                                            dh):
    """Head dims past 128 run the wide kernel (the head dim a runtime
    argument) on each path's shapes, within ``fa_ref.tolerance``, with
    the real dh's scale; GQA over strided cache slices.  Past
    WIDE_MAX_DH the call raises before any launch."""
    assert fa_ops.padded_dim(dh) == dh
    g = torch.Generator(device=dev).manual_seed(dh + sq)
    q = torch.randn(2, sq, 6, dh, generator=g, device=dev).to(dtype)
    ck, cv = (torch.randn(2, sk + 20, 2, dh, generator=g, device=dev)
              .to(dtype) for _ in range(2))
    k, v = ck[:, :sk], cv[:, :sk]
    kw = dict(causal=causal, window=window, q_offset=q_off)
    n = fa_ops.KERNEL.launches
    got = fa_ops.flash_attention_gqa(q, k, v, **kw)
    assert fa_ops.KERNEL.launches == n + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert_attention_close(got, q, k, v, **kw)
    wide = torch.zeros(1, 4, 2, fa_ops.WIDE_MAX_DH + 1, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_gqa(wide, wide, wide)
    assert fa_ops.KERNEL.launches == n + 1


def test_nn_launch_counts_grow(dev):
    """One launch a call on every path of kernel 9 (the key-split path's
    C entry launches the splits and the merge)."""
    before = (eb_ops.KERNEL.launches, fa_ops.KERNEL.launches)
    eb_ops.embedding_bag(torch.ones(4, 8, device=dev),
                         torch.zeros(3, 1, dtype=torch.int32, device=dev))
    x = torch.ones(1, 4, 1, 16, device=dev)
    fa_ops.flash_attention_gqa(x, x, x)
    assert (eb_ops.KERNEL.launches, fa_ops.KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    q = torch.ones(2, 1, 9, 64, device=dev).bfloat16()
    kv = torch.ones(2, 600, 3, 64, device=dev).bfloat16()
    for sq in (1, 600):
        n = fa_ops.KERNEL.launches
        fa_ops.flash_attention_gqa(q.expand(2, sq, 9, 64).contiguous(), kv,
                                   kv, q_offset=600 - sq)
        assert fa_ops.KERNEL.launches == n + 1


def test_spmsv_dcsc_kernel_matches_plain_and_csr(graph, dev):
    """Kernel 1 through the block DCSC against its plain version and
    against the col_ptr addressing on the same frontiers."""
    part = graph.part
    for i, j in ((0, 0), (1, 0), (1, 1)):
        jc, cp, nzc = graph.jc[i, j], graph.cp[i, j], graph.nzc[i, j]
        ri = graph.row_idx[i, j]
        for mask in _strip_fronts(part.nc, dev):
            n = sp_ops.KERNEL_DCSC.launches
            got = sp_ops.spmsv_dcsc_min(mask, jc, cp, nzc, ri, part.nr,
                                        j * part.nc)
            prep = sp_ops.prepare_dcsc(mask, jc, cp, nzc)
            # every call launches, an empty frontier's too
            assert sp_ops.KERNEL_DCSC.launches == n + 1
            want = sp_ops.spmsv_dcsc_min_plain(*prep, cp, ri, part.nr,
                                               j * part.nc)
            assert torch.equal(got, want)
            assert torch.equal(got, sp_ops.spmsv_csr_min(
                mask, graph.col_ptr[i, j], ri, part.nr, j * part.nc))


def test_spmsv_strips_csr_kernel_matches_plain_and_dcsc(dev):
    """Kernel 1 over the (p, n+1) strip col_ptr against its plain
    version and against kernel 3 (the strip DCSC) on the same frontiers,
    with the edges examined."""
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    g = build_blocked_1d(e, 16, align=32, cap_pad=32, with_col_ptr=True)
    part = g.part
    for mask in _strip_fronts(part.n, dev):
        fw = pack_bits(mask)
        n = sp_ops.KERNEL_STRIPS.launches
        got, ex = sp_ops.spmsv_strips_csr_min(fw, g.col_ptr, g.row_idx,
                                              part.chunk)
        prep = sp_ops.prepare_strips(fw, g.col_ptr)
        assert sp_ops.KERNEL_STRIPS.launches == n + 1
        want = sp_ops.spmsv_strips_csr_min_plain(*prep, g.col_ptr, g.row_idx,
                                                 part.chunk)
        assert torch.equal(got, want)
        cand, ex_dcsc = strip.spmsv_strip_dcsc(g.jc, g.cp, g.nzc, g.row_idx,
                                               fw, part.chunk)
        assert torch.equal(got, cand) and int(ex) == int(ex_dcsc)


def _kernel1_cases(dev):
    """Kernel 1's synthetic cases on the card: (name, Segments, nr,
    frontiers) of the block through csr and dcsc and of 4 strips."""
    b = ec.spmsv_block(1 << 17, 1 << 17, device=dev, seed=3)
    col_ptr, row_idx, jc, cp, nzc, hub = b
    out = []
    for seg in (sp_ops.csr(col_ptr, row_idx),
                sp_ops.dcsc(jc, cp, nzc, row_idx)):
        fronts = ec.spmsv_frontiers(col_ptr, hub, (sp_ops.list_capacity(
            seg),), device=dev, seed=3)
        out.append((seg.addressing, seg, 1 << 17, fronts))
    s_ptr, s_ridx, s_hub = ec.spmsv_strips(4, 1 << 19, device=dev, seed=5)
    seg = sp_ops.strips(s_ptr, s_ridx)
    out.append(("strips", seg, (1 << 19) // 4, ec.spmsv_frontiers(
        s_ptr, s_hub, (sp_ops.list_capacity(seg),), device=dev, seed=5)))
    return out


def _kernel1_plain(seg, words, nr, coff):
    """The plain version of ``seg``'s addressing on the card's tensors,
    and its edge total."""
    if seg.addressing == "strips":
        prep = sp_ops.prepare_strips(words, seg.ptr)
        return sp_ops.spmsv_strips_csr_min_plain(*prep, seg.ptr, seg.row_idx,
                                                 nr), prep[-1]
    mask = unpack_bits(words)
    if seg.addressing == "csr":
        prep = sp_ops.prepare(mask, seg.ptr)
        return sp_ops.spmsv_csr_min_plain(*prep, seg.ptr, seg.row_idx, nr,
                                          coff), prep[-1]
    prep = sp_ops.prepare_dcsc(mask, seg.jc, seg.ptr, seg.nzc)
    return sp_ops.spmsv_dcsc_min_plain(*prep, seg.ptr, seg.row_idx, nr,
                                       coff), prep[-1]


def test_spmsv_kernel_on_edge_cases(dev):
    """Kernel 1's three addressings on the synthetic cases (a 10^5-edge
    hub, the last word, ids absent from ``jc``, ``nzc < cap_nzc``, a
    frontier at and one past the walk threshold, all), each walk forced
    as well: the candidates equal the plain version, the edges examined
    its total, the count and the walk the device prep's twin's."""
    walks = set()
    for kind, seg, nr, fronts in _kernel1_cases(dev):
        cap0 = sp_ops.list_capacity(seg)
        n_cols = next(iter(fronts.values())).shape[0] * 32
        for name, words in fronts.items():
            want, total = _kernel1_plain(seg, words, nr, 11)
            for cap in (cap0, 1, n_cols):
                cand, out = sp_ops.launch(seg, words, nr, 11, list_cap=cap)
                _, count, walk = sp_ops.prep_plain(words, cap)
                assert torch.equal(cand, want), (kind, name, cap)
                assert out.tolist() == [total, int(count), walk], \
                    (kind, name, cap)
                walks.add(walk)
            got, ex = sp_ops.spmsv_min(seg, words, nr, 11)
            assert torch.equal(got, want) and int(ex) == total
    assert walks == {sp_ops.WALK_FRONTIER, sp_ops.WALK_COLUMNS}


def test_spmsv_strips_kernel_past_2_31_edges(dev):
    """The strip addressing over 16 strips whose edges pass 2^31
    together (2^20 columns of 130 edges each): both walks count every
    edge exactly in int64 and give each strip the plain version's
    candidates (the plain version run strip by strip)."""
    p, n, nr, degree = 16, 1 << 20, 1 << 16, 130
    if torch.cuda.mem_get_info(dev)[0] < 24 << 30:
        pytest.skip("needs 24 GiB free on the card for 2^31 row ids")
    col_ptr, row_idx = ec.spmsv_strips_uniform(p, n, nr, degree, dev)
    seg = sp_ops.strips(col_ptr, row_idx)
    g = torch.Generator(device=dev).manual_seed(6)
    for frac in (1.0, 0.3):
        words = pack_bits(torch.rand(n, generator=g, device=dev) < frac)
        count = int(unpack_bits(words).sum())
        for cap in (sp_ops.list_capacity(seg), n):
            cand, out = sp_ops.launch(seg, words, nr, list_cap=cap)
            assert int(out[0]) == p * count * degree, (frac, cap)
            assert p * count * degree > 2**31 or frac < 1
            for s in range(p):
                want = sp_ops.spmsv_csr_min(words, col_ptr[s],
                                            row_idx[s], nr, 0)
                assert torch.equal(cand[s], want), (frac, cap, s)
            del cand


def test_cap_f_overflow_raises_through_a_search(graph, dev):
    """With ``cap_f`` below a frontier a search raises at the level's
    read on the 2D csr and dcsc entries and on the strips (``compile``
    searches from the hub); a call outside a level loop raises at once;
    at ``cap_f`` 0 a search's kernel-1 calls read nothing to the host
    (sync debug mode "error" around each)."""
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    g1 = build_blocked_1d(e, 4, align=32, cap_pad=32, with_col_ptr=True)
    sessions = [(graph, BFSConfig(), make_local_mesh(2, 2, device=dev)),
                (graph, BFSConfig(storage="dcsc"),
                 make_local_mesh(2, 2, device=dev)),
                (g1, BFSConfig(decomposition="1d", storage="csr"),
                 make_local_mesh_1d(4, device=dev))]
    for g_, cfg, mesh in sessions:
        with pytest.raises(ValueError, match="exceeds cap_f=1"):
            plan_bfs(g_, dataclasses.replace(cfg, direction_optimizing=False),
                     mesh, local_mode="kernel", cap_f=1).compile()
        eng = plan_bfs(g_, cfg, mesh, local_mode="kernel").compile()
        guarded = sp_ops.spmsv_min

        def no_read(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return guarded(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n = sum(k.launches for k in sp_ops._KERNELS.values())
        sp_ops.spmsv_min = no_read
        try:
            eng.search(int(torch.argmax(g_.deg_A.reshape(-1))))
        finally:
            sp_ops.spmsv_min = guarded
        assert sum(k.launches for k in sp_ops._KERNELS.values()) > n
    mask = torch.arange(graph.part.nc, device=dev) < 5
    with pytest.raises(ValueError, match="frontier of 5 columns exceeds "
                                         "cap_f=2"):
        sp_ops.spmsv_csr_min(mask, graph.col_ptr[0, 0], graph.row_idx[0, 0],
                             graph.part.nr, 0, cap_f=2)


@pytest.mark.parametrize("instrument", [True, False])
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("dec", ["1d", "1ds"])
def test_strip_csr_sessions_match_dcsc(dev, dec, chunks, instrument):
    """The ("1d"|"1ds", "kernel", "csr") sessions give the strip DCSC
    sessions' parents and levels, each kernel launched: at
    expand_chunks 4 the csr entry runs kernel 1 on each sub-chunk's
    partial bitmap, the dcsc one kernel 4."""
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    g = build_blocked_1d(e, 16, align=32, cap_pad=32, with_col_ptr=True)
    mesh = make_local_mesh_1d(16, device=dev)
    out = {}
    for storage in ("csr", "dcsc"):
        eng = plan_bfs(g, BFSConfig(decomposition=dec, storage=storage,
                                    direction_optimizing=False,
                                    expand_chunks=chunks,
                                    instrument=instrument), mesh,
                       local_mode="kernel").compile()
        n = sp_ops.KERNEL_STRIPS.launches
        out[storage] = eng.run(int(torch.argmax(g.deg_A.reshape(-1))))
        if storage == "csr":
            assert sp_ops.KERNEL_STRIPS.launches > n
    assert (out["csr"].parents == out["dcsc"].parents).all()
    assert out["csr"].n_levels == out["dcsc"].n_levels


@pytest.mark.parametrize("dec,storage", [("2d", "dcsc"), ("1d", "csr"),
                                         ("1ds", "dcsc")])
def test_run_batch_matches_run_many_with_kernels(dev, dec, storage):
    """``run_batch`` over 2 pods on the card, kernels launched, gives
    ``run_many``'s parents on every root, the lockstep trip count of each
    scan position, and (1d/1ds, which switch per pod) each root's own
    stats rows."""
    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    if dec == "2d":
        g = build_blocked(e, 1, 1, align=32, cap_pad=32)
        mesh = make_local_mesh(1, 1, device=dev, pods=2)
    else:
        g = build_blocked_1d(e, 16, align=32, cap_pad=32,
                             with_col_ptr=True)
        mesh = make_local_mesh_1d(16, device=dev, pods=2)
    deg = e.out_degrees().cpu().numpy()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 9, 40, 200]]]
    eng = plan_bfs(g, BFSConfig(decomposition=dec, storage=storage), mesh,
                   local_mode="kernel").compile()
    singles = eng.run_many(roots)
    n = bu_ops.KERNEL.launches
    batch = eng.run_batch(roots)
    assert bu_ops.KERNEL.launches > n
    own = np.array([s.n_levels for s in singles])
    assert np.array_equal(batch.n_levels, np.tile(np.maximum(own[:2],
                                                             own[2:]), 2))
    for i, s in enumerate(singles):
        assert np.array_equal(batch.parents[i], s.parents), i
        if dec != "2d":
            assert np.array_equal(batch.level_stats[i, :s.n_levels, :3],
                                  s.level_stats[:s.n_levels, :3])


@pytest.mark.parametrize("dec", ["2d", "1d", "1ds"])
def test_validator_on_card_gives_the_cpu_counts(dev, dec):
    """The Graph500 validator on the card (the engine's own shards) gives
    the CPU run's (6,) counts on a clean tree and on each seeded parent
    fault, whose injection reads the edge list on the card."""
    from repro_torch.core import validate as V
    from repro_torch.runtime.faultinject import PARENT_FAULTS, inject_parents

    e = rmat.rmat_graph(12, 16, seed=1, generator="counter", device=dev)
    e_cpu = rmat.rmat_graph(12, 16, seed=1, generator="counter",
                            device="cpu")
    engines = []
    for edges, where in ((e, dev), (e_cpu, "cpu")):
        if dec == "2d":
            g = build_blocked(edges, 2, 2, align=32, cap_pad=32)
            mesh = make_local_mesh(2, 2, device=where)
        else:
            g = build_blocked_1d(edges, 16, align=32, cap_pad=32,
                                 with_col_ptr=True)
            mesh = make_local_mesh_1d(16, device=where)
        engines.append(plan_bfs(g, BFSConfig(decomposition=dec), mesh,
                                local_mode="kernel").compile())
    card, host = engines
    root = int(torch.argmax(e.out_degrees()))
    res = card.run(root, validate=True)
    assert res.validation.ok
    assert res.validation == V.validate_parents(host, root, res.parents)
    for kind in PARENT_FAULTS:
        bad, _ = inject_parents(kind, res.parents, root, 0, n=e.n,
                                src=e.src, dst=e.dst,
                                chunk=card.plan.part.chunk)
        got = V.validate_parents(card, root, bad)
        assert not got.ok and got == V.validate_parents(host, root, bad)


def test_healed_run_on_card_gives_the_cpu_log(dev):
    """``run_bfs_healed`` on 16 strips from a squeezed ``cap_x``: the same
    retry log and parents on the card as on the CPU."""
    from repro_torch.core.engine import run_bfs_healed
    from repro_torch.runtime.faultinject import undersize_cap

    out = []
    for where in (dev, "cpu"):
        e = rmat.rmat_graph(12, 16, seed=1, generator="counter",
                            device=where)
        g = build_blocked_1d(e, 16, align=32, cap_pad=32)
        cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                        direction_optimizing=False)
        cap = undersize_cap(g.part.chunk, 0)
        out.append(run_bfs_healed(g, cfg, make_local_mesh_1d(16, device=where),
                                  int(torch.argmax(e.out_degrees())),
                                  cap_x=cap, max_attempts=8, validate=True,
                                  local_mode="kernel"))
    assert out[0].retry_log == out[1].retry_log and out[0].retry_log
    assert np.array_equal(out[0].result.parents, out[1].result.parents)


def test_registry_lint_with_kernel_entries_is_clean_and_fixture_flagged(dev):
    """The schedule linter on the card: the registry sweep over the kernel
    LocalOps entries (R1-R3 on every combo's pod-batched search, R4 over
    the 18 budget cases) is clean, and R1 flags the unsynced 2D fixture's
    permutes in both instrument modes."""
    from repro_torch.analysis.fixtures import lint_fixture
    from repro_torch.analysis.registry import lint_registry
    report = lint_registry(device=dev, local_mode="kernel")
    assert report["clean"], report["findings"][:3]
    assert len(report["budget_cases"]) == 18
    assert any("/kernel/dcsc/" in c["name"] for c in report["combos"])
    for instrument in (False, True):
        r1 = [f for f in lint_fixture(instrument, device=dev)
              if f.rule == "R1" and f.detail["collective"] == "ppermute"]
        assert r1 and r1[0].detail["divergent_axes"] == ["pod"]


def _bags(dev, n_bags, width, n_rows, seed, pads=0.0, past=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, n_rows + past, (n_bags, width), generator=g,
                        device=dev, dtype=torch.int32)
    if pads:
        ids[torch.rand(n_bags, width, generator=g, device=dev) < pads] = -1
    w = torch.rand(n_bags, width, generator=g, device=dev) + 0.5
    return ids, w


@pytest.mark.parametrize(
    "dtype,n_bags,width,dim,weighted,mode,past,n_rows,pads,hot", [
        (torch.float32, 65536, 1, 16, False, "sum", 0, 50_000, 0.0, None),
        (torch.float32, 4096, 8, 16, True, "mean", 3, 50_000, 0.2, None),
        (torch.bfloat16, 4096, 12, 64, True, "mean", 0, 50_000, 0.2, None),
        # 8 bf16 don't fit
        (torch.bfloat16, 2048, 5, 24, False, "sum", 2, 50_000, 0.2, None),
        (torch.float32, 1000, 3, 7, True, "sum", 0, 50_000, 0.2, None),
        # all pads: the kernel writes an all-zero output
        (torch.float32, 512, 6, 16, True, "mean", 0, 3000, 1.0, None),
        (torch.bfloat16, 512, 6, 16, False, "sum", 0, 3000, 1.0, None),
        # n_rows not a multiple of the tile (256 rows, 512 in bf16)
        (torch.float32, 3000, 4, 16, True, "sum", 5, 1001, 0.2, None),
        (torch.bfloat16, 3000, 4, 16, False, "mean", 0, 777, 0.2, None),
        # V = 1: every live id, and those past it, land on row 0
        (torch.float32, 2048, 3, 16, True, "mean", 4, 1, 0.2, None),
        (torch.bfloat16, 2048, 3, 16, False, "sum", 0, 1, 0.0, None),
        # one row takes every term
        (torch.float32, 4096, 8, 16, True, "sum", 0, 3000, 0.0, 1234),
        (torch.bfloat16, 4096, 8, 64, False, "mean", 0, 3000, 0.1, 2999),
    ])
def test_embedding_bag_backward_kernel_matches_plain(dev, dtype, n_bags,
                                                     width, dim, weighted,
                                                     mode, past, n_rows,
                                                     pads, hot):
    """Kernel 8b against its plain version on CPU copies, tolerance 0
    (the same float32 operations in the same order a row)."""
    ids, w = _bags(dev, n_bags, width, n_rows, 11,
                   pads=pads if width > 1 else 0.0, past=past)
    if hot is not None:
        ids[ids >= 0] = hot
    wt = w if weighted else None
    g = torch.Generator(device=dev).manual_seed(12)
    gout = torch.randn(n_bags, dim, generator=g, device=dev).to(dtype)
    before = eb_ops.KERNEL_BWD.launches, eb_ops.KERNEL_BWD_KEYS.launches
    got = eb_ops.embedding_bag_backward(gout, ids, n_rows, wt, mode)
    torch.cuda.synchronize()
    assert (eb_ops.KERNEL_BWD.launches,
            eb_ops.KERNEL_BWD_KEYS.launches) == (before[0] + 1,
                                                 before[1] + 1)
    want = eb_ref.embedding_bag_backward(
        gout.cpu(), ids.cpu(), n_rows, None if wt is None else wt.cpu(), mode)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    if pads == 1.0:
        assert not got.any()


@pytest.mark.parametrize("weighted,mode", [(False, "sum"), (True, "mean")])
def test_embedding_bag_backward_prep_matches_plain_twin(dev, weighted, mode):
    """The key kernel and the sort against the plain twin on CPU copies:
    the sorted keys with the pads' sentinel, the flat positions, the
    "mean" divisors bit for bit; the tile kernel against the twin's
    searches at 1, 3, 512 and 1024 places a tile, on all pads, on one row
    taking every term and on no terms."""
    n_rows = 5000
    ids, w = _bags(dev, 3000, 7, n_rows, 13, pads=0.2, past=4)
    wt = w if weighted else None
    before = eb_ops.KERNEL_BWD_KEYS.launches
    prep = eb_ops.prepare_backward(ids, wt, mode, n_rows)
    torch.cuda.synchronize()
    assert eb_ops.KERNEL_BWD_KEYS.launches == before + 1
    twin = eb_ops.prepare_backward(ids.cpu(), None if wt is None
                                   else wt.cpu(), mode, n_rows)
    assert torch.equal(prep.keys.cpu(), twin.keys)
    assert torch.equal(prep.pos.cpu(), twin.pos)
    assert (prep.den is None) == (twin.den is None)
    if twin.den is not None:
        assert torch.equal(prep.den.cpu(), twin.den)
    for items in (1, 3, 512, 1024):
        before = eb_ops.KERNEL_BWD_TILES.launches
        got = eb_ops.tile_bounds(prep.keys, n_rows, items)
        torch.cuda.synchronize()
        assert eb_ops.KERNEL_BWD_TILES.launches == before + 1
        assert torch.equal(got.cpu(),
                           eb_ops.tile_bounds_plain(twin.keys, n_rows, items))
    for keys in (torch.full((1000,), n_rows, dtype=torch.int32),  # pads
                 torch.full((3000,), 17, dtype=torch.int32),      # one row
                 torch.zeros(0, dtype=torch.int32)):
        assert torch.equal(eb_ops.tile_bounds(keys.to(dev), n_rows, 7).cpu(),
                           eb_ops.tile_bounds_plain(keys, n_rows, 7))


@pytest.mark.parametrize("n,n_rows,kind", [
    (2_555_904, 11_238_400, "random"),      # AutoInt's lookup: 3 passes
    (5000, 1, "random"),                    # 1 bit
    (4096, 300, "random"),                  # one block's keys exactly
    (4097, 2 ** 24, "random"),              # 25 bits: 4 passes
    (10_000, 255, "random"),                # 1 pass
    (70_000, 50_000, "equal"),              # one key
    (70_000, 50_000, "sorted"),
    (0, 100, "random"),
])
def test_embedding_bag_backward_sort_matches_plain_twin(dev, n, n_rows,
                                                        kind):
    """Kernel 8b's radix sort against ``torch.sort(stable=True)`` on CPU
    copies: the keys and the permutation equal, the input untouched."""
    g = torch.Generator(device=dev).manual_seed(17)
    keys = torch.randint(0, n_rows + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    if kind == "equal":
        keys.fill_(n_rows // 2)
    elif kind == "sorted":
        keys = torch.sort(keys).values
    copy = keys.clone()
    before = eb_ops.KERNEL_BWD_SORT.launches
    got_k, got_p = eb_ops.sort_keys(keys, n_rows)
    torch.cuda.synchronize()
    assert eb_ops.KERNEL_BWD_SORT.launches == before + 1
    want_k, want_p = eb_ops.sort_keys_plain(keys.cpu())
    assert torch.equal(keys, copy)
    assert got_p.dtype == torch.int32
    assert torch.equal(got_k.cpu(), want_k) and torch.equal(got_p.cpu(),
                                                            want_p)


def _autoint_lookup(dev):
    """AutoInt's training lookup: 65,536 x 39 bags of one into the
    registered table's rows, float32 D 16."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.models import embedding
    cfg = get_config("autoint")
    _, n_rows = embedding.table_meta(cfg)
    idx = torch.from_numpy(recsys_batch(cfg, 65536, 0)["idx"]).to(dev)
    ids = embedding.flat_indices(cfg, idx).reshape(-1, 1).to(
        torch.int32).contiguous()
    g = torch.Generator(device=dev).manual_seed(14)
    gout = torch.randn(ids.shape[0], cfg.embed_dim, generator=g, device=dev)
    return gout, ids, n_rows


def _all_kernels():
    """Every CudaKernel of the port's kernel modules, by C entry."""
    from repro_torch.kernels.build import CudaKernel
    mods = (sp_ops, bu_ops, strip, codec_ops, eb_ops, fa_ops, rmat)
    return {k.name: k for m in mods for k in vars(m).values()
            if isinstance(k, CudaKernel)}


def test_embedding_bag_backward_at_autoint_makes_no_host_sync(dev):
    """The public entry at AutoInt's shape under sync debug mode "error":
    no call in it waits for the card (no host read); it launches its key
    kernel, sort, tile and gradient kernels once each and no other kernel
    of the port; two calls agree bit for bit."""
    gout, ids, n_rows = _autoint_lookup(dev)
    eb_ops.embedding_bag_backward(gout, ids, n_rows)    # builds, warms up
    torch.cuda.synchronize()
    kernels = _all_kernels()
    before = {k: v.launches for k, v in kernels.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eb_ops.embedding_bag_backward(gout, ids, n_rows)
        again = eb_ops.embedding_bag_backward(gout, ids, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    moved = {k: v.launches - before[k] for k, v in kernels.items()
             if v.launches != before[k]}
    assert moved == {"embedding_bag_bwd_keys": 2, "embedding_bag_bwd_sort": 2,
                     "embedding_bag_bwd_tiles": 2, "embedding_bag_bwd": 2}
    assert torch.equal(got, again)
    want = eb_ref.embedding_bag_backward(gout.cpu(), ids.cpu(), n_rows)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype,weighted,mode", [
    (torch.float32, False, "sum"), (torch.bfloat16, True, "mean")])
def test_embedding_bag_backward_fills_a_poisoned_output(dev, dtype,
                                                        weighted, mode):
    """The gradient kernel writes every row of its output: launched into
    a NaN-filled tensor it leaves no NaN, and equals the plain version."""
    n_rows = 20_011
    ids, w = _bags(dev, 2000, 4, n_rows, 15, pads=0.3)
    wt = w if weighted else None
    g = torch.Generator(device=dev).manual_seed(16)
    gout = torch.randn(2000, 16, generator=g, device=dev).to(dtype)
    out = torch.full((n_rows, 16), float("nan"), dtype=dtype, device=dev)
    prep = eb_ops.prepare_backward(ids, wt, mode, n_rows)
    got = eb_ops.launch_backward(gout, prep, n_rows, out=out)
    torch.cuda.synchronize()
    assert got is out and not torch.isnan(out).any()
    want = eb_ref.embedding_bag_backward(
        gout.cpu(), ids.cpu(), n_rows, None if wt is None else wt.cpu(), mode)
    assert torch.equal(out.cpu(), want)


def test_embedding_bag_autograd_launches_both_kernels(dev):
    table = torch.randn(1000, 16, device=dev, requires_grad=True)
    ids = torch.randint(0, 1000, (64, 1), device=dev, dtype=torch.int32)
    f0, b0 = eb_ops.KERNEL.launches, eb_ops.KERNEL_BWD.launches
    k0 = eb_ops.KERNEL_BWD_KEYS.launches
    out = eb_ops.embedding_bag_trainable(table, ids)
    (gt,) = torch.autograd.grad(out.sum(), table)
    assert eb_ops.KERNEL.launches == f0 + 1
    assert eb_ops.KERNEL_BWD.launches == b0 + 1
    assert eb_ops.KERNEL_BWD_KEYS.launches == k0 + 1
    want = eb_ref.embedding_bag_backward(torch.ones(64, 16), ids.cpu(), 1000)
    assert torch.equal(gt.cpu(), want)


def _bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, dh, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, dh, generator=g, device=dev).to(dtype)
    do = torch.randn(b, sq, hq, dh, generator=g, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype,b,sq,sk,hq,hkv,dh,causal,window,q_off", [
    (torch.bfloat16, 2, 256, 256, 9, 3, 64, True, None, 0),   # smollm's
    (torch.float32, 1, 200, 200, 4, 2, 32, True, None, 0),
    (torch.bfloat16, 2, 192, 192, 6, 2, 64, True, 70, 0),     # window
    (torch.bfloat16, 1, 64, 192, 4, 1, 128, True, None, 128),  # q_offset
    (torch.float32, 1, 100, 130, 2, 2, 16, False, None, 0),   # no mask
    (torch.bfloat16, 1, 96, 96, 4, 2, 80, True, 40, 0),       # dh padded
    (torch.float32, 1, 40, 90, 3, 3, 64, True, 8, 60),        # dead rows
    (torch.bfloat16, 1, 40, 90, 3, 3, 64, True, 8, 60),       # dead rows
    (torch.bfloat16, 2, 200, 200, 4, 2, 64, True, None, 0),   # ragged Sq
    (torch.bfloat16, 1, 130, 130, 4, 2, 16, True, None, 0),   # dh 16
    (torch.bfloat16, 1, 130, 150, 4, 4, 32, False, None, 0),  # dh 32
    (torch.bfloat16, 2, 160, 160, 4, 2, 128, True, None, 0),  # dh 128
    (torch.bfloat16, 1, 100, 300, 6, 3, 64, True, 50, 200),   # window, offset
])
def test_flash_attention_backward_kernel_matches_plain(dev, dtype, b, sq,
                                                       sk, hq, hkv, dh,
                                                       causal, window,
                                                       q_off):
    """Kernel 9b against its plain version on the same inputs (o from
    kernel 9), within ``fa_ref.backward_tolerance``: with the log-sum-exp
    kernel 9 saved where its path saves one (the first pass not run), and
    without it (the first pass run)."""
    q, k, v, do = _bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, dh, dh + sq)
    o, lse = fa_ops.attention_with_lse(q, k, v, causal=causal,
                                       window=window, q_offset=q_off)
    assert (lse is not None) == fa_ops.saves_lse(q, k, causal, window,
                                                 q_off)
    want = fa_ref.attention_gqa_backward(q, k, v, o, do, causal=causal,
                                         window=window, q_offset=q_off)
    bounds = fa_ref.backward_tolerance(q, k, v, o, do, causal=causal,
                                       window=window, q_offset=q_off)
    for saved in ((lse, None) if lse is not None else (None,)):
        before = (fa_ops.KERNEL_BWD.launches, fa_ops.KERNEL_BWD_LSE.launches)
        got = fa_ops.flash_attention_gqa_backward(q, k, v, o, do, causal,
                                                  window, q_off, lse=saved)
        torch.cuda.synchronize()
        first = int(saved is None or dtype == torch.float32)
        assert (fa_ops.KERNEL_BWD.launches,
                fa_ops.KERNEL_BWD_LSE.launches) == (before[0] + 1,
                                                    before[1] + first)
        for x, y, bound, name in zip(got, want, bounds, "qkv"):
            assert x.dtype == dtype and x.shape == y.shape
            err = (x.float() - y.float()).abs()
            assert bool((err <= bound).all()), \
                (name, saved is None, float(err.max()),
                 float((err / bound).max()))


def test_flash_attention_backward_is_deterministic(dev):
    """Two calls on the same inputs give the same bits (no atomics: each
    output element has one owner that sums in a fixed order)."""
    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 2, 512, 512, 9, 3, 64, 5)
    o, lse = fa_ops.attention_with_lse(q, k, v)
    first = fa_ops.flash_attention_gqa_backward(q, k, v, o, do, lse=lse)
    second = fa_ops.flash_attention_gqa_backward(q, k, v, o, do, lse=lse)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dh,window,q_off", [(64, None, 64), (128, 48, 32),
                                             (16, None, 64), (80, None, 0)])
def test_flash_attention_lse_store(dev, dh, window, q_off):
    """Kernel 9's prefill path gives the same output bits with and without
    the log-sum-exp store, and the stored log-sum-exp sits within 2**-12
    of ``fa_ref.attention_lse``: the scores are float32 sums of exact bf16
    products (at most dh 2**-24 sum |q k| c2, about 5e-5 here), l is a
    float32 sum of at most 256 terms (256 2**-24 relative, 2.2e-5 in
    log2), ex2.approx about 2**-22 relative."""
    q, k, v, _ = _bwd_inputs(dev, torch.bfloat16, 2, 192, 256, 6, 2, dh, 3)
    n = fa_ops.KERNEL.launches
    o, lse = fa_ops.attention_with_lse(q, k, v, window=window,
                                       q_offset=q_off)
    plain = fa_ops.flash_attention_gqa(q, k, v, window=window,
                                       q_offset=q_off)
    assert fa_ops.KERNEL.launches == n + 2
    assert torch.equal(o, plain)
    want = fa_ref.attention_lse(q, k, window=window, q_offset=q_off)
    assert lse.shape == want.shape == (2, 6, 192)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    assert float((lse[fin] - want[fin]).abs().max()) <= 2.0 ** -12


def test_flash_attention_backward_refuses_past_128(dev):
    q = torch.zeros(1, 8, 2, 160, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128"):
        fa_ops.flash_attention_gqa_backward(q, q, q, q, q)


def test_attention_autograd_launches_both_kernels(dev):
    """``attention`` runs kernel 9 forward and 9b backward, the latter from
    the log-sum-exp the forward saved: its first pass never runs."""
    q = torch.randn(1, 128, 4, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    f0, b0 = fa_ops.KERNEL.launches, fa_ops.KERNEL_BWD.launches
    l0 = fa_ops.KERNEL_BWD_LSE.launches
    out = fa_ops.attention(q, k, k)
    torch.autograd.grad(out.float().sum(), (q, k))
    assert fa_ops.KERNEL.launches == f0 + 1
    assert fa_ops.KERNEL_BWD.launches == b0 + 1
    assert fa_ops.KERNEL_BWD_LSE.launches == l0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_loss_bf16_logits_on_the_card_match_the_cpu(dev, dtype):
    """``lm_loss``'s ``loss_bf16`` logits (bf16 operands on the tensor
    cores with a float32 output) and their gradients against the same
    function on CPU copies: the same exact products in another summation
    order: the logits within 1e-5 of their largest element, the
    gradients within that (float32) or one bf16 step, 2**-7 (bf16)."""
    from repro_torch.models.transformer import _LogitsF32Out
    g = torch.Generator().manual_seed(0)
    h = torch.randn(512, 576, generator=g).to(dtype)
    emb = torch.randn(4096, 576, generator=g).to(dtype)
    dl = torch.randn(512, 4096, generator=g)
    outs = []
    for d in ("cpu", dev):
        hh, ee = (x.to(d).requires_grad_(True) for x in (h, emb))
        out = _LogitsF32Out.apply(hh, ee)
        gh, ge = torch.autograd.grad(out, (hh, ee), dl.to(d))
        assert out.dtype == torch.float32
        assert gh.dtype == dtype and ge.dtype == dtype
        outs.append([x.detach().float().cpu() for x in (out, gh, ge)])
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        tol = 1e-5 if i == 0 or dtype == torch.float32 else 2 ** -7
        assert (got - want).abs().max() <= tol * want.abs().max(), i


def _fill_ids(tree, gen):
    """Seeded values in a cell's non-parameter arguments (ids 0)."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                x.copy_(torch.rand(x.shape, generator=gen, device=x.device))
            else:
                x.zero_()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


@pytest.mark.parametrize("family", ["lm", "recsys"])
def test_meta_counts_equal_the_card_through_the_kernels(dev, family):
    """A small LM training cell (kernels 9, 9b) and a small AutoInt
    training cell (8, 8b) count the same FLOPs, bytes and kernel costs on
    ``meta`` (where the kernel entries allocate and launch nothing) as on
    the card, and the card launches every kernel."""
    from repro_torch.configs.base import (LMShape, RecsysShape, get_config,
                                          reduced)
    from repro_torch.launch import cells, roofline
    from repro_torch.launch.mesh import make_mesh
    if family == "lm":
        cfg = reduced(get_config("smollm-135m"), n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)

        def build(mesh):
            return cells.build_lm_cell(cfg, LMShape("t", 64, 2, "train"), mesh)
        kernels = (fa_ops.KERNEL, fa_ops.KERNEL_BWD)
    else:
        cfg = reduced(get_config("autoint"), vocab_sizes=(40,) * 39)

        def build(mesh):
            return cells.build_recsys_cell(
                cfg, RecsysShape("t", 32, kind="train"), mesh)
        kernels = (eb_ops.KERNEL, eb_ops.KERNEL_BWD)
    counts = {}
    for where in ("meta", dev):
        cell = build(make_mesh(1, 1, device=where))
        _fill_ids(cell.args[2:], torch.Generator(device=where if where !=
                                                 "meta" else "cpu"))
        before = [k.launches for k in kernels]
        with roofline.StepCounter() as c:
            cell.fn(*cell.args)
        s = c.summary()
        counts[str(where)] = {k: s[k] for k in ("flops", "bytes_read",
                                                "bytes_written", "kernels")}
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert all(launched) == (where != "meta"), launched
    assert counts["meta"] == counts[str(dev)]
