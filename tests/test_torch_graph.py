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
