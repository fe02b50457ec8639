"""Kernel 8's plain version (``repro_torch.kernels.embedding_bag``, what
the wrapper runs on CPU tensors) against the JAX package's Pallas kernel
in interpret mode and against its jnp ``ref.py``, on numpy inputs made
from a seed.

Tolerances: bags of one are exact (0 + row * 1.0 is the row); multi-hot
bags use the JAX test's own, rtol = atol = 1e-6 in float32 and 2e-2 in
bfloat16 (``tests/test_kernels_nn.py``): the plain loop and the Pallas
kernel sum in the same order but XLA may contract a multiply and an add.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jax_eb
from repro.kernels.embedding_bag import ref as jax_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from _torch_threads import one_thread  # noqa: F401

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(v, d, b, l, dtype, seed, lo=-1):
    rng = np.random.default_rng(seed)
    table = np.array(jnp.asarray(rng.normal(size=(v, d)), dtype)
                     .astype(jnp.float32))     # values exact in dtype
    ids = rng.integers(lo, v, (b, l)).astype(np.int32)
    w = rng.random((b, l)).astype(np.float32)
    return table, ids, w


def _port(table, ids, w, mode, dtype):
    t = torch.from_numpy(table).to(_TORCH[dtype])
    out = eb_ops.embedding_bag(t, torch.from_numpy(ids),
                               None if w is None else torch.from_numpy(w),
                               mode=mode)
    assert out.dtype == t.dtype
    return out.float().numpy()


def _pallas(table, ids, w, mode, dtype, bt):
    return np.asarray(jax_eb.embedding_bag(
        jnp.asarray(table, dtype), jnp.asarray(ids),
        None if w is None else jnp.asarray(w), mode=mode, bt=bt),
        np.float32)


@pytest.mark.parametrize("V,D,B,L,bt", [
    (64, 16, 32, 1, 32), (128, 32, 64, 4, 32), (1000, 16, 128, 8, 32),
    (32, 8, 256, 2, 32), (100, 16, 200, 3, 40), (50, 8, 77, 5, 77),
])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_pallas_and_ref(V, D, B, L, bt, mode, dtype):
    table, ids, w = _inputs(V, D, B, L, dtype, V + B + L)
    got = _port(table, ids, w, mode, dtype)
    tol = 1e-6 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got, _pallas(table, ids, w, mode, dtype, bt),
                               rtol=tol, atol=tol)
    want_ref = np.asarray(jax_ref.embedding_bag(
        jnp.asarray(table, dtype), jnp.asarray(ids), jnp.asarray(w),
        mode=mode), np.float32)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_bags_of_one_are_exact(dtype, weighted):
    """The AutoInt lookup's case: one id a bag, no padding."""
    table, ids, w = _inputs(500, 16, 300, 1, dtype, 7, lo=0)
    w = np.ones_like(w) if weighted else None
    got = _port(table, ids, w, "sum", dtype)
    want = np.asarray(jnp.asarray(table, dtype).astype(jnp.float32))[
        ids[:, 0]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pallas(table, ids, w, "sum", dtype,
                                               60))
    np.testing.assert_array_equal(got, np.asarray(jax_ref.embedding_bag(
        jnp.asarray(table, dtype), jnp.asarray(ids)), np.float32))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_padding_and_all_padded_bags(mode):
    table, ids, w = _inputs(40, 8, 64, 6, jnp.float32, 3)
    ids[::4] = -1                         # every 4th bag all padding
    ids[1::4, :3] = -1                    # others part padding
    for weights in (w, None):
        got = _port(table, ids, weights, mode, jnp.float32)
        np.testing.assert_array_equal(got[::4], 0.0)
        np.testing.assert_allclose(
            got, _pallas(table, ids, weights, mode, jnp.float32, 32),
            rtol=1e-6, atol=1e-6)


def test_mean_with_zero_weights_is_zero():
    table, ids, _ = _inputs(40, 8, 32, 4, jnp.float32, 4, lo=0)
    w = np.zeros(ids.shape, np.float32)
    got = _port(table, ids, w, "mean", jnp.float32)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(
        got, _pallas(table, ids, w, "mean", jnp.float32, 32))


def test_ids_past_the_table_clamp_as_the_pallas_kernel_does():
    """An id >= V reads row V-1, as the Pallas kernel's gather does (the
    jnp ref.py gives NaN there)."""
    table, ids, w = _inputs(8, 4, 32, 2, jnp.float32, 5, lo=0)
    ids[:, 0] = 9
    ids[::2, 1] = 1000
    got = _port(table, ids, w, "sum", jnp.float32)
    np.testing.assert_allclose(got, _pallas(table, ids, w, "sum",
                                            jnp.float32, 32),
                               rtol=1e-6, atol=1e-6)
    one = _port(table, np.ascontiguousarray(ids[:, :1]), None, "sum",
                jnp.float32)
    np.testing.assert_array_equal(one, np.broadcast_to(table[7], one.shape))


@pytest.mark.parametrize("bad", ["ids64", "ids1d", "wshape", "mode",
                                 "table_int"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = torch.zeros(8, 4)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    w = None
    mode = "sum"
    if bad == "ids64":
        ids = ids.long()
    elif bad == "ids1d":
        ids = ids[:, 0]
    elif bad == "wshape":
        w = torch.ones(4, 3)
    elif bad == "mode":
        mode = "max"
    else:
        t = t.int()
    with pytest.raises(ValueError):
        eb_ops.embedding_bag(t, ids, w, mode=mode)


# the launch's layout: (D, element bytes, table 16-byte aligned) ->
# (elements a lane, lanes a bag)
@pytest.mark.parametrize("dim,elt,aligned,want", [
    (16, 4, True, (4, 4)),        # the AutoInt table: 4 lanes of float4
    (16, 2, True, (8, 2)),        # bf16: 2 lanes of 8
    (8, 4, True, (4, 2)),
    (32, 4, True, (4, 8)),
    (32, 2, True, (8, 4)),
    (17, 4, True, (1, 17)),       # an odd D: one element a lane
    (12, 2, True, (1, 12)),       # 24 bytes: not whole vectors
    (16, 4, False, (1, 16)),      # a table view off 16 bytes
    (1100, 4, True, (4, 256)),    # wider than a block of lanes
    (3000, 4, False, (1, 256)),
])
def test_layout(dim, elt, aligned, want):
    assert eb_ops.layout(dim, elt, aligned) == want


@pytest.mark.parametrize("n_bags,dim,vec,lanes,want", [
    (10_223_616, 16, 4, 4, (39_936, 1)),   # serve_bulk: 256 bags a block
    (19_968, 16, 4, 4, (78, 1)),           # serve_p99
    (257, 16, 8, 2, (1, 1)),               # bf16: 512 bags a block
    (1, 17, 1, 17, (1, 1)),
    (61, 17, 1, 17, (2, 1)),               # 15 bags side by side, 60 a block
    (1000, 1100, 4, 256, (250, 2)),        # 275 vectors: 2 slices of 256
    (0, 16, 4, 4, (0, 1)),
])
def test_grid_covers_every_bag_and_vector(n_bags, dim, vec, lanes, want):
    gx, gy = eb_ops.grid(n_bags, dim, vec, lanes)
    assert (gx, gy) == want
    per_block = eb_ops.BLOCK // lanes * eb_ops.BAGS_PER_THREAD
    assert gx * per_block >= n_bags > (gx - 1) * per_block or n_bags == 0
    assert gy * lanes >= dim // vec

