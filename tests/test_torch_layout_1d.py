"""The 1D strip layout of the port against the JAX package's: the
partition, the compaction helpers ``pack_ids``/``unpack_ids``, the port's
copy of the comm model (wire closed forms, codec widths, ``plan_cap_x``)
and every array of ``build_blocked_1d`` (tolerance 0: integers, and
float64 closed forms compared exactly)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_model as r_cm
from repro.core import frontier as r_frontier
from repro.core.partition import make_partition_1d as r_make_partition_1d
from repro.graph import formats as r_formats
from repro.graph import rmat as r_rmat
from repro_torch.core import comm_model as t_cm
from repro_torch.core import frontier as t_frontier
from repro_torch.core.partition import make_partition, make_partition_1d
from repro_torch.graph import formats as t_formats
from repro_torch.graph import rmat as t_rmat
from repro_torch.launch.mesh import make_local_mesh_1d
from _torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("n_orig,p,align", [(2048, 16, 128), (1000, 16, 32),
                                            (2**11, 4, 32), (7, 1, 32)])
def test_partition_1d_matches(n_orig, p, align):
    got, want = make_partition_1d(n_orig, p, align), \
        r_make_partition_1d(n_orig, p, align)
    assert (got.n, got.n_orig, got.p, got.chunk, got.nr, got.nc) == \
        (want.n, want.n_orig, want.p, want.chunk, want.nr, want.nc)
    # the same padding as the 2D partition with pr*pc == p
    assert got.n == make_partition(n_orig, p, 1, align).n
    with pytest.raises(ValueError, match="align"):
        make_partition_1d(n_orig, p, align=48)


def test_mesh_1d_is_a_p_by_1_grid():
    mesh = make_local_mesh_1d(16, device="cpu")
    assert (mesh.pr, mesh.pc, mesh.device.type) == (16, 1, "cpu")


@pytest.mark.parametrize("density", [0.0, 0.05, 0.4, 1.0])
@pytest.mark.parametrize("cap", [1, 7, 32, 64])
def test_pack_ids_matches_per_strip(density, cap):
    rng = np.random.default_rng(int(density * 100) + cap)
    p, chunk = 4, 64
    mask = rng.random((p, chunk)) < density
    offs = np.arange(p, dtype=np.int32)[:, None] * chunk
    got = t_frontier.pack_ids(torch.from_numpy(mask), cap,
                              torch.from_numpy(offs), p * chunk)
    got0 = t_frontier.pack_ids(torch.from_numpy(mask), cap, 0, chunk)
    assert got.shape == (p, cap) and got.dtype == torch.int32
    for i in range(p):
        want = np.asarray(r_frontier.pack_ids(jnp.asarray(mask[i]), cap,
                                              i * chunk, p * chunk))
        assert np.array_equal(got[i].numpy(), want), i
        want0 = np.asarray(r_frontier.pack_ids(jnp.asarray(mask[i]), cap, 0,
                                               chunk))
        assert np.array_equal(got0[i].numpy(), want0), i
    # unpack_ids drops the sentinels and rebuilds the bitmap
    words = t_frontier.unpack_ids(got, p * chunk)
    want = np.asarray(r_frontier.unpack_ids(jnp.asarray(got.numpy()),
                                            p * chunk))
    assert np.array_equal(words.numpy().view(np.uint32), want)
    if cap >= chunk:
        assert np.array_equal(t_frontier.unpack_bits(words).numpy(),
                              mask.reshape(-1))


def test_unpack_ids_drops_out_of_range_ids():
    ids = torch.tensor([0, 5, 5, 63, 64, 1000, -3], dtype=torch.int32)
    want = np.asarray(r_frontier.unpack_ids(jnp.asarray(ids[:6].numpy()),
                                            64))
    assert np.array_equal(t_frontier.unpack_ids(ids, 64).numpy()
                          .view(np.uint32), want)


@pytest.mark.parametrize("n,p", [(2048, 16), (2**24, 16), (2**14, 4),
                                 (4096, 1)])
def test_comm_model_copies_match(n, p):
    chunk = n // p
    for n_f in (0.0, 1.0, 77.0, 5000.0, np.float32(123.0)):
        assert t_cm.sparse_expand_1d_words(n_f, p) == \
            r_cm.sparse_expand_1d_words(n_f, p)
        for bits in (1, 7, 20):
            for c in (1, 2, 4):
                assert t_cm.compressed_expand_1d_words(n_f, p, bits, c) == \
                    r_cm.compressed_expand_1d_words(n_f, p, bits, c)
    assert t_cm.expand_1d_level_words(n, p) == \
        r_cm.expand_1d_level_words(n, p)
    assert t_cm.expand_1d_words(n, p, 7) == r_cm.expand_1d_words(n, p, 7)
    for c in (1, 2, 4):
        if (chunk // 32) % c == 0:
            assert t_cm.chunked_expand_1d_level_words(n, p, c) == \
                r_cm.chunked_expand_1d_level_words(n, p, c)
    for chunk_ in (2, 3, 128, 1000, 2**18, 2**20):
        bits = t_cm.codec_bits(chunk_)
        assert bits == r_cm.codec_bits(chunk_)
        for cap in (1, 33, 52448, 13112):
            assert t_cm.codec_packed_words(cap, bits) == \
                r_cm.codec_packed_words(cap, bits)
            assert t_cm.codec_bucket_words(cap, bits) == \
                r_cm.codec_bucket_words(cap, bits)
    for m in (1, 10**4, 5 * 10**8):
        for bits in (64, t_cm.codec_bits(chunk)):
            assert t_cm.plan_cap_x(n, p, m, bits=bits) == \
                r_cm.plan_cap_x(n, p, m, bits=bits)
        assert t_cm.topdown_1d_words(m, p) == r_cm.topdown_1d_words(m, p)
    assert t_cm.rmat_strip_skew(p) == r_cm.rmat_strip_skew(p)


@pytest.mark.parametrize("n_f", [3.0, 699051.0, 1048573.0, 16777213.0])
def test_comm_model_float32_counts_round_as_the_reference(n_f):
    """A float32 count keeps every step in float32, as the JAX package's
    in-program counters (jnp float32 with weakly typed constants) do;
    past 2**24 that differs from float64 arithmetic rounded at the end."""
    f = np.float32(n_f)
    for p in (4, 16):
        got = t_cm.sparse_expand_1d_words(f, p)
        want = np.asarray(r_cm.sparse_expand_1d_words(jnp.float32(f), p))
        assert type(got) is np.float32 and want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        for bits, c in ((20, 1), (18, 4), (7, 2)):
            got = t_cm.compressed_expand_1d_words(f, p, bits, c)
            want = np.asarray(r_cm.compressed_expand_1d_words(
                jnp.float32(f), p, bits, c))
            assert type(got) is np.float32 and want.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (p, bits, c)


def test_comm_model_scale_24_figures():
    """The bucket sizes of the scale-24, 16-strip main path."""
    n, p = 2**24, 16
    bits = t_cm.codec_bits(n // p)
    assert bits == 20 and t_cm.codec_bits(n // p // 4) == 18
    cap = t_cm.plan_cap_x(n, p, 5 * 10**8, bits=bits)
    assert cap == 52448
    assert t_cm.codec_bucket_words(cap, bits) == 1 + 32780
    assert t_cm.codec_bucket_words(cap // 4, 18) == 1 + 7376
    with pytest.raises(ValueError, match="real edge count"):
        t_cm.plan_cap_x(n, p, 0)
    with pytest.raises(ValueError, match="does not divide"):
        t_cm.chunked_expand_1d_level_words(2048, 16, 3)


@pytest.fixture(scope="module")
def edges_pair():
    return (t_rmat.rmat_graph(11, 16, seed=1, device="cpu"),
            r_rmat.rmat_graph(11, 16, seed=1))


@pytest.mark.parametrize("p,align,cap_pad", [(16, 32, 32), (16, 128, 128),
                                             (4, 32, 64), (1, 32, 32)])
def test_build_blocked_1d_every_array_matches(edges_pair, p, align,
                                              cap_pad):
    e, r = edges_pair
    got = t_formats.build_blocked_1d(e, p, align=align, cap_pad=cap_pad)
    want = r_formats.build_blocked_1d(r, p, align=align, cap_pad=cap_pad)
    assert (got.part.n, got.part.p) == (want.part.n, want.part.p)
    for f in ("m_input", "m", "cap", "cap_nzc", "maxdeg_col"):
        assert getattr(got, f) == getattr(want, f), f
    arrays = got.device_arrays()
    assert set(arrays) == set(want.device_arrays())
    for k, v in arrays.items():
        w = np.asarray(getattr(want, k))
        assert v.dtype == torch.int32 and v.shape == w.shape, k
        assert np.array_equal(v.numpy(), w), k


def test_build_blocked_1d_without_edge_lists(edges_pair):
    e, _ = edges_pair
    full = t_formats.build_blocked_1d(e, 16, align=32, cap_pad=32)
    lean = t_formats.build_blocked_1d(e, 16, align=32, cap_pad=32,
                                      with_edge_lists=False)
    assert lean.edge_src is None and lean.edge_dst is None
    lean_arrays = lean.device_arrays()
    assert set(full.device_arrays()) - set(lean_arrays) == \
        {"edge_src", "edge_dst"}
    for k, v in lean_arrays.items():
        assert torch.equal(v, full.device_arrays()[k]), k
