"""The port's graph inputs against the JAX package's, array for array:
both R-MAT streams, preprocessing, and every ``build_blocked`` array on
grids 1x1, 2x2 and 4x4 (tolerance 0: all integers)."""
import numpy as np
import pytest
import torch

from repro.graph import formats as rformats
from repro.graph import rmat as rrmat
from repro_torch.graph import formats as tformats
from repro_torch.graph import rmat as trmat
from _torch_threads import one_thread  # noqa: F401


def test_level_salts_and_thresholds_match():
    for seed in (1, 7):
        for lv in range(31):
            assert trmat.level_salt(seed, lv) == rrmat.level_salt(seed, lv)
    assert trmat.rmat_thresholds(0.57, 0.19, 0.19) == \
        rrmat.rmat_thresholds(0.57, 0.19, 0.19)


def test_rmat_edges_host_stream_matches():
    s, d = trmat.rmat_edges(9, 8, seed=3)
    rs, rd = rrmat.rmat_edges(9, 8, seed=3)
    assert np.array_equal(s, rs) and np.array_equal(d, rd)


def test_counter_stream_full_matches_numpy():
    s, d = trmat.rmat_edges_counter(10, 16, seed=1, device="cpu")
    rs, rd = rrmat.rmat_edges_counter(10, 16, seed=1)
    assert s.dtype == torch.int32
    assert np.array_equal(s.numpy(), rs) and np.array_equal(d.numpy(), rd)


@pytest.mark.parametrize("start,count", [(0, 1), (5, 700), (1000, 4096),
                                         (16 * 1024 - 333, 333)])
def test_counter_stream_slices_match_numpy(start, count):
    s, d = trmat.rmat_edges_counter(10, 16, a=0.6, b=0.15, c=0.15, seed=5,
                                    start=start, count=count, device="cpu")
    rs, rd = rrmat.rmat_edges_counter(10, 16, a=0.6, b=0.15, c=0.15,
                                      seed=5, start=start, count=count)
    assert np.array_equal(s.numpy(), rs) and np.array_equal(d.numpy(), rd)


@pytest.mark.parametrize("scale,start,count", [
    (1, 0, 32),                        # the whole stream of scale 1
    (10, 0, 16 << 10),
    (17, (16 << 17) // 2 - 500, 1000),  # the middle of the stream
    (24, (16 << 24) - 777, 777),        # its end
    (29, (1 << 32) - 1000, 2500),       # across the counter's 2**32 wrap
    (30, (16 << 30) - 300, 300),
])
def test_kernel_salts_give_the_same_stream(scale, start, count):
    """The kernel's launch prep, as identities on the plain version's
    values: for every counter hash h of the slice (mod 2**32, across its
    wrap) and every level's ``level_salt`` s, the plain level's first
    xor-shift (h^s) ^ ((h^s) >> 16) is B ^ S_l, with B = h ^ (h >> 16)
    once an edge and S_l the folded salt of ``kernel_salts``; and with
    t1 <= t2 <= t3 the dst bit is (x>=t1) ^ (x>=t2) ^ (x>=t3), at and
    around every threshold.  The plain stream of the slice equals the
    JAX package's numpy generator's, which the card test holds the
    kernel to."""
    idx = (np.arange(count, dtype=np.uint64) + start) % 2**32
    h = (idx * 0x9E3779B9) % 2**32
    base = h ^ (h >> 16)
    salts = trmat.kernel_salts(7, scale)
    assert len(salts) == scale
    for lv, folded in enumerate(salts):
        x = h ^ np.uint64(trmat.level_salt(7, lv))
        assert np.array_equal(x ^ (x >> 16), base ^ np.uint64(folded))
    for abc in ((0.57, 0.19, 0.19), (0.6, 0.15, 0.15), (0.25, 0.25, 0.25),
                (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)):
        t1, t2, t3 = trmat.rmat_thresholds(*abc)
        assert t1 <= t2 <= t3
        x = np.array(sorted({min(max(t + d, 0), 2**32 - 1)
                             for t in (0, t1, t2, t3, 2**32 - 1)
                             for d in (-1, 0, 1)}), dtype=np.uint64)
        assert np.array_equal(((x >= t1) & (x < t2)) | (x >= t3),
                              (x >= t1) ^ (x >= t2) ^ (x >= t3))
    got = trmat.rmat_edges_counter_plain(scale, 16, seed=7, start=start,
                                         count=count)
    rs, rd = rrmat.rmat_edges_counter(scale, 16, seed=7, start=start,
                                      count=count)
    assert np.array_equal(got[0].numpy(), rs)
    assert np.array_equal(got[1].numpy(), rd)


@pytest.mark.parametrize("scale", [0, 31])
def test_kernel_scale_dispatch_rejects_scales_it_lacks(scale):
    """The kernel is instantiated for scales 1..30: the launch prep
    raises for 0 and 31; the CPU's plain version takes scale 0."""
    with pytest.raises(ValueError, match="scales 1...30"):
        trmat.kernel_salts(1, scale)
    assert list(trmat.KERNEL_SCALES) == list(range(1, 31))
    if scale == 0:
        s, d = trmat.rmat_edges_counter(0, 16, device="cpu")
        assert not s.any() and not d.any()


def test_counter_stream_rejects_bad_slices():
    with pytest.raises(ValueError, match="outside"):
        trmat.rmat_edges_counter(8, 16, start=4000, count=200, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        trmat.rmat_edges_counter(31, 1, count=1, device="cpu")


@pytest.mark.parametrize("generator", ["numpy", "counter"])
def test_rmat_graph_preprocess_matches(generator):
    e = trmat.rmat_graph(10, 8, seed=2, generator=generator, device="cpu")
    r = rrmat.rmat_graph(10, 8, seed=2, generator=generator)
    assert (e.n, e.m, e.m_input) == (r.n, r.m, r.m_input)
    assert np.array_equal(e.src.numpy(), r.src)
    assert np.array_equal(e.dst.numpy(), r.dst)
    assert np.array_equal(e.out_degrees().numpy(), r.out_degrees())
    rng_t, rng_r = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(5):
        assert trmat.random_source(e, rng_t) == rrmat.random_source(r, rng_r)


def test_preprocess_without_symmetrize_matches():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    e = trmat.preprocess(torch.from_numpy(src.astype(np.int32)),
                         torch.from_numpy(dst.astype(np.int32)), 50,
                         symmetrize=False)
    r = rrmat.preprocess(src, dst, 50, symmetrize=False)
    assert np.array_equal(e.src.numpy(), r.src)
    assert np.array_equal(e.dst.numpy(), r.dst)


@pytest.fixture(scope="module")
def edges_pair():
    return (trmat.rmat_graph(10, 16, seed=1, device="cpu"),
            rrmat.rmat_graph(10, 16, seed=1))


@pytest.mark.parametrize("grid,align,cap_pad", [((1, 1), 128, 128),
                                                ((2, 2), 32, 32),
                                                ((4, 4), 32, 32),
                                                ((2, 4), 32, 64)])
def test_build_blocked_every_array_matches(edges_pair, grid, align, cap_pad):
    e, r = edges_pair
    got = tformats.build_blocked(e, *grid, align=align, cap_pad=cap_pad)
    want = rformats.build_blocked(r, *grid, align=align, cap_pad=cap_pad)
    assert got.part.n == want.part.n and got.part.pr == want.part.pr
    for f in ("m_input", "m", "cap", "cap_seg", "maxdeg_col"):
        assert getattr(got, f) == getattr(want, f), f
    arrays = got.device_arrays()
    assert set(arrays) == set(want.device_arrays())
    for k, v in arrays.items():
        w = np.asarray(getattr(want, k))
        assert v.dtype == torch.int32, k
        assert v.shape == w.shape, k
        assert np.array_equal(v.numpy(), w), k
