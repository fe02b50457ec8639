"""The port's "1ds" frontier codec against the JAX package's: the plain
encode and decode are bit-identical to the jnp oracle (``ref.py``) for
every width from 1 to 20 bits, and to the Pallas kernels run in
interpret mode (tolerance 0: integer words).  Covered: payloads whose
``cap*bits`` is not a multiple of 32, the count clamp, empty and full
buckets.  The CUDA kernels are held against these plain versions on a
card (``test_torch_cuda.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier_codec import ops as r_ops
from repro.kernels.frontier_codec import ref as r_ref
from repro_torch.core.comm_model import codec_bits, codec_bucket_words
from repro_torch.kernels.frontier_codec import ops as t_ops
from repro_torch.kernels.frontier_codec import ref as t_ref


def _buckets(chunk, cap, seed):
    """Offsets of 5 buckets: empty, one id, half, full, and a count
    past cap (clamped)."""
    rng = np.random.default_rng(seed)
    off = rng.integers(0, chunk, (5, cap)).astype(np.int32)
    count = np.array([0, 1, cap // 2, cap, cap + 7], np.int32)
    for k, c in enumerate(count):          # sentinel past the count
        off[k, min(c, cap):] = chunk
    return off, count


def _u32(t):
    return t.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def _oracle(chunk):
    """The jnp oracle, jitted and mapped over buckets: one compile per
    shape instead of one per eager op."""
    enc = jax.jit(jax.vmap(lambda o, c: r_ref.encode_offsets(o, c, chunk)))
    dec = jax.jit(lambda r, cap, n: r_ref.decode_buckets(r, chunk, cap, n),
                  static_argnums=(1, 2))
    return enc, dec


@pytest.mark.parametrize("bits", range(1, 21))
def test_plain_codec_matches_jnp_oracle(bits):
    chunk = (1 << bits) - (bits > 2)      # not always a power of two
    assert codec_bits(chunk) == bits
    r_enc, r_dec = _oracle(chunk)
    for cap in (1, 33, 100):
        off, count = _buckets(chunk, cap, bits * 1000 + cap)
        enc = t_ops.encode_offsets(torch.from_numpy(off),
                                   torch.from_numpy(count), chunk)
        assert enc.dtype == torch.int32
        assert enc.shape == (5, codec_bucket_words(cap, bits))
        want = np.asarray(r_enc(jnp.asarray(off), jnp.asarray(count)))
        assert np.array_equal(_u32(enc), want), cap
        n = 5 * chunk
        got = t_ops.decode_buckets(enc.reshape(-1), chunk, cap, n, 5)
        want = np.asarray(r_dec(jnp.asarray(_u32(enc).reshape(-1)), cap, n))
        assert np.array_equal(got.numpy(), want), cap
        # the round trip gives back the live ids, rebased per bucket
        for k in range(5):
            live = min(int(count[k]), cap)
            ids = got.numpy()[k * cap:(k + 1) * cap]
            assert np.array_equal(ids[:live], k * chunk + off[k, :live])
            assert np.all(ids[live:] == n)


@pytest.mark.parametrize("bits,cap", [(1, 33), (7, 32), (13, 5), (20, 40)])
def test_plain_codec_matches_pallas_interpret(bits, cap):
    chunk = 1 << bits
    off, count = _buckets(chunk, cap, bits)
    enc = t_ref.encode_offsets(torch.from_numpy(off), torch.from_numpy(count),
                               chunk)
    for k in range(5):
        want = np.asarray(r_ops.encode_offsets(jnp.asarray(off[k]),
                                               int(count[k]), chunk))
        assert np.array_equal(_u32(enc[k]), want), k
    n = 5 * chunk
    got = t_ref.decode_buckets(enc.reshape(-1), chunk, cap, n)
    want = np.asarray(r_ops.decode_buckets(
        jnp.asarray(_u32(enc).reshape(-1)), chunk, cap, n, 5))
    assert np.array_equal(got.numpy(), want)


def test_codec_wrappers_check_their_inputs():
    off = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        t_ops.encode_offsets(off.to(torch.int64), torch.zeros(2,
                                                             dtype=torch.int32),
                             64)
    with pytest.raises(ValueError, match="count"):
        t_ops.encode_offsets(off, torch.zeros(3, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="words"):
        t_ops.decode_buckets(torch.zeros(5, dtype=torch.int32), 64, 8, 128, 2)
