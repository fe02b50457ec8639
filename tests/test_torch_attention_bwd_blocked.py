"""Kernel 9b's bf16 schedule on the CPU: its plain blocked twin
(``ops.backward_blocked_plain``: the kernel's tiles and walk over the live
tiles, P and dS rounded to bf16 where the kernel rounds them before its
tensor-core products, float32 sums) held within the derived bf16 bound
``ref.backward_tolerance`` of ``ref.attention_gqa_backward`` and of
``jax.vjp`` of the JAX package's ``chunked_attention`` on the same numpy
inputs; ``ref.attention_lse`` (what kernel 9's forward saves) against
``jax.nn.logsumexp`` of the masked, scaled scores; the tile walks against
a brute-force count of live pairs; the bound shown to reject a window
off by one.  Small shapes (Sq <= 64, dh <= 64) and tiles of 16, so that
each case spans several tiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import chunked_attention as r_chunked_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from _torch_threads import one_thread  # noqa: F401

TILE = 16

# (B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset)
CASES = [
    (2, 48, 48, 4, 2, 16, True, None, 0),      # GQA, causal, 3 tiles
    (1, 24, 44, 2, 2, 16, True, 8, 40),        # rows 51.. reach no key
    (1, 37, 53, 6, 2, 32, True, 20, 9),        # ragged, window and offset
    (1, 30, 30, 2, 1, 64, False, None, 0),     # no mask, dh 64
    (2, 64, 64, 4, 4, 16, True, 16, 0),        # a window of one tile
]
IDS = [f"c{i}" for i in range(len(CASES))]


def _numpy_inputs(case):
    """q, k, v, do as float32 numpy arrays whose values are bf16's."""
    b, sq, sk, hq, hkv, dh = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    shapes = ((b, sq, hq, dh), (b, sk, hkv, dh), (b, sk, hkv, dh),
              (b, sq, hq, dh))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for s in shapes]


def _masks(case):
    causal, window, off = case[6:]
    return dict(causal=causal, window=window, q_offset=off)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_twin_within_bound_of_plain(case):
    """bf16 inputs, o from the plain forward in bf16: the twin (the
    kernel's roundings, lse as the forward saves it) sits within
    ``backward_tolerance`` of the plain gradient, element by element."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _numpy_inputs(case))
    m = _masks(case)
    o = fa_ref.attention_gqa(q, k, v, **m)
    lse = fa_ref.attention_lse(q, k, **m)
    got = fa_ops.backward_blocked_plain(q, k, v, o, do, lse=lse, tile=TILE,
                                        **m)
    want = fa_ref.attention_gqa_backward(q, k, v, o, do, **m)
    bounds = fa_ref.backward_tolerance(q, k, v, o, do, **m)
    for x, y, bound, name in zip(got, want, bounds, "qkv"):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape
        err = (x.float() - y.float()).abs()
        assert bool((err <= bound).all()), (name, float((err / bound).max()))


def _live_rows(case) -> int:
    """How many query rows reach a key; they come first in every case."""
    sq, sk = case[1], case[2]
    causal, window, off = case[6:]
    qpos = off + np.arange(sq)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, int)
    hi = np.minimum(sk, qpos + 1) if causal else np.full(sq, sk)
    live = hi > lo
    n = int(live.sum())
    assert live[:n].all()
    return n


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_twin_within_bound_of_jax(case):
    """The same numpy inputs through ``jax.vjp`` of the JAX package's
    ``chunked_attention`` (float32): the twin in float32, rounding P and
    dS to bf16 as the kernel does, with o the JAX forward's, sits within
    the bf16 row of ``backward_tolerance``: the rounding term covers the
    rounding.  ``chunked_attention`` gives NaN on a row that no key
    reaches (where the port, as the JAX package's ``ref.py``, gives 0),
    so JAX takes the rows that reach a key (a prefix, same q_offset):
    such rows add nothing to dK and dV, and get dQ = 0 from the twin."""
    qn, kn, vn, don = _numpy_inputs(case)
    m = _masks(case)
    n = _live_rows(case)
    out, vjp = jax.vjp(lambda a, c, d: r_chunked_attention(
        a, c, d, q_offset=m["q_offset"], causal=m["causal"],
        window=m["window"], kv_chunk=1024), jnp.asarray(qn[:, :n]),
        jnp.asarray(kn), jnp.asarray(vn))
    want = [torch.from_numpy(np.array(w))
            for w in vjp(jnp.asarray(don[:, :n]))]
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn, vn, don))
    o = torch.zeros_like(q)
    o[:, :n] = torch.from_numpy(np.array(out))
    got = fa_ops.backward_blocked_plain(q, k, v, o, do, tile=TILE, **m)
    bounds = fa_ref.backward_tolerance(q, k, v, o, do, dtype=torch.bfloat16,
                                       **m)
    assert torch.equal(got[0][:, n:], torch.zeros_like(got[0][:, n:]))
    got, bounds = [got[0][:, :n], *got[1:]], [bounds[0][:, :n], *bounds[1:]]
    for x, w, bound, name in zip(got, want, bounds, "qkv"):
        err = (x - w).abs()
        assert bool((err <= bound).all()), (name, float((err / bound).max()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_lse_matches_jax_logsumexp(case):
    """``ref.attention_lse`` is log2 of the sum of exp of the masked,
    scaled scores: ``jax.nn.logsumexp`` times log2(e), within float32's
    rounding; a row that no key reaches is +inf (JAX: -inf)."""
    qn, kn = _numpy_inputs(case)[:2]
    b, sq, sk, hq, hkv, dh, causal, window, off = case
    kr = np.repeat(kn, hq // hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", qn, kr) * dh ** -0.5
    qpos = off + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1)) * np.log2(np.e)
    got = fa_ref.attention_lse(torch.from_numpy(qn), torch.from_numpy(kn),
                               **_masks(case)).numpy()
    assert got.shape == (b, hq, sq) and got.dtype == np.float32
    dead = ~mask.any(1)
    assert np.array_equal(np.isinf(got), np.broadcast_to(dead, got.shape))
    assert (got[..., dead] > 0).all() and (want[..., dead] < 0).all()
    np.testing.assert_allclose(got[..., ~dead], want[..., ~dead],
                               rtol=1e-6, atol=1e-5)
    if case[1] == 24:
        assert dead.any()


@pytest.mark.parametrize("sq,sk,causal,window,off", [
    (64, 64, True, None, 0), (40, 100, True, 24, 60), (37, 53, False, 20, 9),
    (50, 30, False, None, 0), (24, 44, True, 8, 40), (16, 16, True, 1, 0)])
def test_tile_walks_cover_exactly_the_live_tiles(sq, sk, causal, window,
                                                 off):
    """The query tiles ``dkdv_wgmma`` walks for a key tile, and the key
    tiles ``dq_wgmma`` walks for a query tile, are exactly the tiles with
    a live (query, key) pair."""
    qpos = off + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= qpos - kpos < window
    tiles = {(q0, k0) for q0 in range(0, sq, TILE)
             for k0 in range(0, sk, TILE)
             if live[q0:q0 + TILE, k0:k0 + TILE].any()}
    by_key = {(q0, k0) for k0 in range(0, sk, TILE)
              for q0 in fa_ops._live_queries(k0, TILE, sq, sk, causal,
                                             window, off)}
    by_query = {(q0, k0) for q0 in range(0, sq, TILE)
                for k0 in fa_ops._live_key_tiles(q0, TILE, sq, sk, causal,
                                                 window, off)}
    assert by_key == tiles and by_query == tiles


def test_bound_rejects_a_window_off_by_one():
    """The derived bound is tight enough to see a mask error: the twin
    with the window one key wider leaves the bound of the right gradient."""
    case = CASES[4]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _numpy_inputs(case))
    m = _masks(case)
    o = fa_ref.attention_gqa(q, k, v, **m)
    wrong = dict(m, window=m["window"] + 1)
    got = fa_ops.backward_blocked_plain(q, k, v, o, do, tile=TILE, **wrong)
    want = fa_ref.attention_gqa_backward(q, k, v, o, do, **m)
    bounds = fa_ref.backward_tolerance(q, k, v, o, do, **m)
    assert any(bool(((x.float() - y.float()).abs() > bd).any())
               for x, y, bd in zip(got, want, bounds))


def test_saved_lse_gives_the_plain_gradient():
    """On the CPU ``attention_with_lse`` gives the plain forward and
    ``ref.attention_lse``; the gradient from that saved log-sum-exp
    (exp2 of the base-2 scores less it) equals the softmax's within
    float32 rounding, and ``attention``'s autograd takes it."""
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(x) for x in _numpy_inputs(case))
    m = _masks(case)
    o, lse = fa_ops.attention_with_lse(q, k, v, **m)
    assert torch.equal(o, fa_ref.attention_gqa(q, k, v, **m))
    assert torch.equal(lse, fa_ref.attention_lse(q, k, **m))
    with_lse = fa_ops.flash_attention_gqa_backward(q, k, v, o, do, lse=lse,
                                                   **m)
    without = fa_ops.flash_attention_gqa_backward(q, k, v, o, do, **m)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    auto = torch.autograd.grad(fa_ops.attention(qq, kk, vv, **m), (qq, kk, vv),
                               do)
    for x, y, z in zip(with_lse, without, auto):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
        assert torch.equal(x, z)


def test_backward_checks_the_lse():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention_gqa_backward(q, k, k, q, q,
                                            lse=torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention_gqa_backward(
            q, k, k, q, q, lse=torch.zeros(1, 2, 4, dtype=torch.float64))


def test_float32_bound_is_unchanged():
    """The float32 row keeps its terms and adds no rounding term: the
    bound is rtol |want| + atol max|want|, as ``backward_bound``."""
    assert fa_ref.TOL_BWD[torch.float32] == (1e-4, 1e-5, 0.0)
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(x) for x in _numpy_inputs(case))
    o = fa_ref.attention_gqa(q, k, v)
    want = fa_ref.attention_gqa_backward(q, k, v, o, do)
    for w, bound in zip(want, fa_ref.backward_tolerance(q, k, v, o, do)):
        assert torch.equal(bound, fa_ref.backward_bound(w))
