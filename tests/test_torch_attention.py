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
from _torch_threads import one_thread  # noqa: F401

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
        # past WIDE_MAX_DH the wide kernel's tiles do not fit a block:
        # raised for tensors off the CPU before the library is loaded
        # (meta tensors stand in for CUDA ones); the CPU's plain version
        # takes it
        meta = dict(device="meta")
        dh = fa_ops.WIDE_MAX_DH + 1
        q, k, v = (torch.zeros(1, s, h, dh, **meta)
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
    # past 128 the head dim is the wide kernel's runtime argument
    for dh in (129, 160, 256):
        assert fa_ops.padded_dim(dh) == dh
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


class _Recorder:
    """Stands in for the kernel's C entry: records each launch's
    arguments."""

    def __init__(self):
        self.calls = []

    def launch(self, *args):
        self.calls.append(args)

    def launch_on(self, device, *args):
        self.calls.append(args)


@pytest.mark.parametrize("dh", [48, 80, 128, 129, 160, 256, 1024])
@pytest.mark.parametrize("dtype,sq", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 1),
                                      (torch.float32, 40)])
def test_launch_routes_by_head_dim(monkeypatch, dh, dtype, sq):
    """dh <= 128 runs plan's path at the next kernel width (the padded
    copies); 129 and up run the wide kernel at dh itself, with
    wide_tiles' tiles and the dtype flag, whatever the dtype and Sq.  Meta
    tensors stand in for CUDA ones, a recorder for the C entry."""
    rec = _Recorder()
    monkeypatch.setattr(fa_ops, "KERNEL", rec)
    monkeypatch.setattr(fa_ops, "stream_handle", lambda dev: 0)
    q = torch.zeros(2, sq, 6, dh, dtype=dtype, device="meta")
    k = v = torch.zeros(2, 70, 2, dh, dtype=dtype, device="meta")
    out = fa_ops.launch(q, k, v, True, None, 70 - sq)
    assert out.shape == q.shape
    (args,) = rec.calls
    assert args[5] is None     # no log-sum-exp asked for
    (b, hq, rep, a_sq, sk, a_dh, q_off, window, causal, path, bq, n_split,
     lo, hi, span, bf16, bk, scale, _) = args[7:]
    assert (b, hq, rep, a_sq, sk, q_off) == (2, 6, 3, sq, 70, 70 - sq)
    assert scale == pytest.approx(dh ** -0.5)
    assert bf16 == int(dtype == torch.bfloat16)
    if dh <= 128:
        assert a_dh == fa_ops.padded_dim(dh) >= dh
        want = fa_ops.plan(2, 2, 3, sq, 70, dtype, True, None, 70 - sq)[0]
        assert path == fa_ops.PATHS[want] and bk == 0
    else:
        assert a_dh == dh and path == fa_ops.PATHS["wide"]
        assert (bq, bk) == fa_ops.wide_tiles(dh, sq)


@pytest.mark.parametrize("dh", [129, 160, 256, 320, 1024, 1184])
@pytest.mark.parametrize("sq", [1, 3, 512])
def test_wide_tiles_fit_a_block(dh, sq):
    """The wide kernel's tiles: bq the power of two at or above Sq (at
    most 16), bk a power of two of at least 8, the layout within a
    block's shared memory, and two blocks an SM where any key tile
    allows it."""
    bq, bk = fa_ops.wide_tiles(dh, sq)
    assert bq == min(16, 1 << (sq - 1).bit_length())
    assert bk in fa_ops.WIDE_KEYS and bk >= 8
    smem = fa_ops.wide_smem(dh, bq, bk)
    assert smem <= fa_ops.WIDE_SMEM_MAX
    two = fa_ops.wide_smem(dh, bq, fa_ops.WIDE_KEYS[-1]) \
        <= fa_ops.WIDE_SMEM_TWO
    assert (smem <= fa_ops.WIDE_SMEM_TWO) == two
    # bq * bk * (threads a score) fills the block: every lane shuffles
    pairs = bq * bk
    ts = 1 if pairs >= fa_ops.WIDE_THREADS else min(
        32, fa_ops.WIDE_THREADS // pairs)
    assert pairs * ts % fa_ops.WIDE_THREADS == 0


def test_wide_limit_is_what_a_block_holds():
    assert fa_ops.WIDE_MAX_DH >= 1024
    assert fa_ops.wide_smem(fa_ops.WIDE_MAX_DH, 16, 8) \
        <= fa_ops.WIDE_SMEM_MAX < fa_ops.wide_smem(fa_ops.WIDE_MAX_DH + 1,
                                                   16, 8)
    with pytest.raises(ValueError, match=str(fa_ops.WIDE_MAX_DH)):
        fa_ops.padded_dim(fa_ops.WIDE_MAX_DH + 1)
    with pytest.raises(ValueError, match=str(fa_ops.WIDE_MAX_DH)):
        fa_ops.wide_tiles(fa_ops.WIDE_MAX_DH + 1, 16)


@pytest.mark.parametrize("Sq,Sk,dh,causal,window,q_off", [
    (40, 90, 160, True, 30, 50),     # window, GQA, q tiles of 16
    (1, 300, 129, True, None, 299),  # decode: one row, key tiles of 64
    (96, 160, 256, True, None, 64),  # prefill continuation
    (20, 20, 320, True, 7, 0),       # narrow window
    (5, 70, 1024, True, None, 65),   # the widest the issue asks for
    (3, 12, 200, True, 4, 40),       # rows no key reaches: zeros
    (17, 40, 136, False, 8, 3),      # window without causality
    (33, 50, 144, False, None, 0),   # every key, several key tiles
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_wide_head_dims_match_jax_ref(Sq, Sk, dh, causal, window, q_off,
                                      dtype):
    """Head dims past 128, which the card runs on the wide kernel: the
    plain version that the card tests hold that kernel to against the
    JAX package's attention, per head (causal and not, windows, rows no
    key reaches) and over GQA heads, query head h reading kv head
    h // 3."""
    assert fa_ops.padded_dim(dh) == dh
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
    qj, qt = _pair(rng, (2, Sq, 6, dh), dtype)
    kj, kt = _pair(rng, (2, Sk, 2, dh), dtype)
    vj, vt = _pair(rng, (2, Sk, 2, dh), dtype)

    def heads(x):                  # (B, S, H, dh) -> (B * 6, S, dh)
        x = jnp.repeat(x, 6 // x.shape[2], axis=2)
        return jnp.swapaxes(x, 1, 2).reshape(-1, x.shape[1], dh)
    want = jax_fa_ref.attention(heads(qj), heads(kj), heads(vj),
                                causal=causal, window=window,
                                q_offset=q_off)
    got = fa_ops.flash_attention_gqa(qt, kt, vt, causal=causal,
                                     window=window, q_offset=q_off)
    _close(got.transpose(1, 2).reshape(-1, Sq, dh), want, dtype)