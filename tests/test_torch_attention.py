"""Kernel 9's plain version (``repro_torch.kernels.flash_attention``, what
its wrappers run on CPU tensors) and the port's ``chunked_attention``
against the JAX package's ``flash_attention/ref.py::attention`` and
``models/common.py::chunked_attention``, on numpy inputs made from a
seed.  (The JAX Pallas kernel itself calls ``pl.load``, which the
installed jax lacks, so the JAX side is its jnp twins.)

Tolerances: the JAX kernel test's own, 2e-5 in float32 (the same
softmax, summed in another order) and 3e-2 in bfloat16 (the output is
rounded to bf16 on both sides, one bf16 ulp near 1 is 7.8e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.models import common as jax_common
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import common

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dtype):
    return 2e-5 if dtype == jnp.float32 else 3e-2


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor."""
    x = jnp.asarray(rng.normal(size=shape), dtype)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        _TORCH[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("Sq,Sk,dh,causal,window,q_off", [
    (128, 128, 64, True, None, 0),
    (64, 64, 32, False, None, 0),
    (128, 256, 64, True, 64, 0),      # sliding window
    (1, 256, 64, True, None, 255),    # decode: 1 query over long KV
    (64, 192, 128, True, None, 128),  # chunked-prefill continuation
    (96, 100, 64, True, None, 4),     # ragged Sk
    (17, 40, 16, False, 8, 3),        # window without causality
    # head dims the CUDA kernel runs zero-padded: the plain version
    # takes any dh
    (40, 40, 8, True, None, 0),
    (33, 70, 48, True, 16, 37),
    (64, 96, 80, True, None, 32),
    (1, 130, 80, True, 50, 129),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_ref(Sq, Sk, dh, causal, window, q_off, dtype):
    rng = np.random.default_rng(Sq + Sk + dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (3, s, dh), dtype)
                                    for s in (Sq, Sk, Sk))
    want = jax_fa_ref.attention(qj, kj, vj, causal=causal, window=window,
                                q_offset=q_off)
    got = fa_ops.flash_attention_gqa(
        qt[:, :, None], kt[:, :, None], vt[:, :, None], causal=causal,
        window=window, q_offset=q_off)[:, :, 0]
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dtype)


# (B, Sq, Hq, Hkv, dh, cache length, q_offset, window, kv_chunk)
_CASES = [
    (2, 128, 4, 2, 32, 128, 0, None, 32),     # prefill, GQA
    (2, 40, 9, 3, 16, 64, 0, None, 1024),     # prefill into a longer cache
    (3, 1, 6, 2, 16, 64, 37, None, 16),       # decode at position 37
    (2, 24, 4, 1, 16, 96, 48, None, 32),      # prefill continuation
    (2, 64, 4, 2, 16, 64, 0, 16, 1024),       # window, one chunk
    (1, 1, 4, 2, 32, 80, 70, 8, 2048),        # decode under a window
    (2, 24, 4, 2, 80, 64, 30, None, 32),      # stablelm-3b's head dim
    (3, 1, 6, 2, 48, 64, 37, 16, 2048),       # decode, dh 48, window
    (2, 16, 4, 4, 8, 32, 0, None, 1024),      # dh 8
]


@pytest.mark.parametrize("b,sq,hq,hkv,dh,cache,q_off,window,chunk", _CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gqa_plain_matches_jax_chunked_attention(b, sq, hq, hkv, dh, cache,
                                                 q_off, window, chunk,
                                                 dtype):
    """The serving path's call, kernel 9 over the cache's first kv_len
    keys, against the JAX model's call, chunked attention over the
    whole cache with kv_valid_len = q_offset + Sq."""
    rng = np.random.default_rng(b * sq + cache)
    qj, qt = _pair(rng, (b, sq, hq, dh), dtype)
    kj, kt = _pair(rng, (b, cache, hkv, dh), dtype)
    vj, vt = _pair(rng, (b, cache, hkv, dh), dtype)
    kv_len = q_off + sq
    want = jax_common.chunked_attention(qj, kj, vj, q_offset=q_off,
                                        causal=True, window=window,
                                        kv_chunk=chunk, kv_valid_len=kv_len)
    got = fa_ops.flash_attention_gqa(qt, kt[:, :kv_len], vt[:, :kv_len],
                                     causal=True, window=window,
                                     q_offset=q_off)
    _close(got, want, dtype)
    port = common.chunked_attention(qt, kt, vt, q_offset=q_off,
                                    causal=True, window=window,
                                    kv_chunk=chunk, kv_valid_len=kv_len)
    _close(port, want, dtype)


def test_chunked_attention_window_over_chunks_is_finite():
    """Under a window spanning several chunks a row's first chunks can
    hold no live key; the JAX twin then returns NaN for that row
    (exp(-inf - -inf)), the port adds nothing and agrees with the plain
    softmax."""
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (1, 128, 2, 16), jnp.float32)
    kj, kt = _pair(rng, (1, 128, 1, 16), jnp.float32)
    jax_out = np.asarray(jax_common.chunked_attention(
        qj, kj, kj, q_offset=0, causal=True, window=16, kv_chunk=32))
    assert np.isnan(jax_out).any()
    port = common.chunked_attention(qt, kt, kt, q_offset=0, causal=True,
                                    window=16, kv_chunk=32)
    assert torch.isfinite(port).all()
    want = fa_ref.attention_gqa(qt, kt, kt, causal=True, window=16)
    np.testing.assert_allclose(port.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    finite = ~np.isnan(jax_out)
    np.testing.assert_allclose(port.numpy()[finite], jax_out[finite],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 5, 3, 16), dtype)
    pos = np.arange(7, 12)
    _close(common.rope(xt, torch.from_numpy(pos)),
           jax_common.rope(xj, jnp.asarray(pos)), dtype)
    gamma = rng.random(16).astype(np.float32)
    _close(common.rms_norm(xt, torch.from_numpy(gamma)),
           jax_common.rms_norm(xj, jnp.asarray(gamma)), dtype)


@pytest.mark.parametrize("bad", ["dh", "dtype", "heads", "stride",
                                 "window", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 6, 2, 16)
    v = torch.zeros(1, 6, 2, 16)
    kw = {}
    if bad == "dh":
        # past 128 the kernel has no width: raised for tensors off the
        # CPU before the library is loaded (meta tensors stand in for
        # CUDA ones); the CPU's plain version takes it
        meta = dict(device="meta")
        q, k, v = (torch.zeros(1, s, h, 160, **meta)
                   for s, h in ((4, 4), (6, 2), (6, 2)))
        assert fa_ops.flash_attention_gqa(*(torch.ones(x.shape)
                                            for x in (q, k, v))).shape \
            == q.shape
    elif bad == "dtype":
        k = k.double()
    elif bad == "heads":
        k, v = torch.zeros(1, 6, 3, 16), torch.zeros(1, 6, 3, 16)
    elif bad == "stride":
        q = torch.zeros(1, 4, 4, 32)[..., ::2]
    elif bad == "window":
        kw["window"] = 0
    else:
        k, v = k[:, :0], v[:, :0]
    with pytest.raises(ValueError):
        fa_ops.flash_attention_gqa(q, k, v, **kw)


def test_query_tile():
    assert [fa_ops.query_tile(s) for s in (1, 2, 3, 17, 64, 65, 1024)] \
        == [1, 2, 4, 32, 64, 64, 64]


def test_padded_dim_is_the_next_kernel_width():
    assert [fa_ops.padded_dim(d) for d in (1, 8, 16, 17, 32, 48, 64, 80,
                                           96, 127, 128)] \
        == [16, 16, 16, 32, 32, 64, 64, 128, 128, 128, 128]
    for dh in (129, 160, 256):
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.padded_dim(dh)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_gqa(*(torch.zeros(1, 4, 2, 0)
                                     for _ in range(3)))


def test_pad_head_dim_adds_zero_columns():
    x = torch.randn(2, 5, 3, 80)[:, 1:4]                 # a strided view
    y = fa_ops.pad_head_dim(x, 128)
    assert y.shape == (2, 3, 3, 128) and y.is_contiguous()
    assert torch.equal(y[..., :80], x) and not y[..., 80:].any()


def _plain_at_width(q, k, v, causal, window, q_offset, scale):
    """The plain version on the padded tensors with the softmax scale the
    kernel is given: q scaled by ``scale`` / width^-0.5, so that the
    plain version's own width^-0.5 gives ``scale``."""
    q = (q.double() * (scale / q.shape[3] ** -0.5)).to(q.dtype)
    return fa_ref.attention_gqa(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)


@pytest.mark.parametrize("dh", [8, 48, 80])
def test_kernel_width_call_pads_scales_by_the_real_dh_and_slices(dh):
    """The wrapper's padding around the launch, with the plain version in
    the kernel's place: the result is the attention at the real dh; with
    the padded width's scale it would not be."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 4, dh)).astype(
        np.float32)) for s in (24, 40, 40))
    args = (True, 16, 16)
    got = fa_ops.at_kernel_width(_plain_at_width, q, k, v, *args)
    want = fa_ref.attention_gqa(q, k, v, causal=True, window=16,
                                q_offset=16)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    width = fa_ops.padded_dim(dh)
    wrong = fa_ops.at_kernel_width(
        lambda *a: _plain_at_width(*a[:-1], width ** -0.5), q, k, v, *args)
    assert not np.allclose(wrong.numpy(), want.numpy(), rtol=2e-5,
                           atol=2e-5)
