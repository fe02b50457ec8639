"""The port's "1ds" frontier codec against the JAX package's: the plain
encode and decode are bit-identical to the jnp oracle (``ref.py``) for
every width from 1 to 20 bits, and to the Pallas kernels run in
interpret mode (tolerance 0: integer words).  Covered: payloads whose
``cap*bits`` is not a multiple of 32, the count clamp, empty and full
buckets.  The CUDA kernels are held against these plain versions on a
card (``test_torch_cuda.py``); here their launch shapes and packed
arguments are checked."""
import ctypes
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
from _torch_threads import one_thread  # noqa: F401


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


def _decode_by_blocks(recv: torch.Tensor, chunk: int, cap: int, n: int,
                      p: int) -> torch.Tensor:
    """The decode kernel's block arithmetic in plain PyTorch: for each
    (block, bucket) of ``decode_shape``'s grid, the block's slots, its
    live range below the count, the payload words it stages, and each
    slot extracted from the staged words alone; a slot written twice or
    not at all fails."""
    bits, w, gx = t_ops.decode_shape(p, cap, chunk)
    words = recv.to(torch.int64) & 0xFFFFFFFF
    out = torch.full((p * cap,), -1, dtype=torch.int64)
    writes = torch.zeros(p * cap, dtype=torch.int64)
    span = t_ops.BLOCK * t_ops.VEC
    mask = (1 << bits) - 1
    for k in range(p):
        buf = words[k * (1 + w):(k + 1) * (1 + w)]
        count = int(recv[k * (1 + w)])
        row0 = k * cap
        for bx in range(gx):
            f0 = ((row0 >> 2) + bx * t_ops.BLOCK) * t_ops.VEC
            s_block = f0 - row0
            a, e = max(s_block, 0), min(s_block + span, count, cap)
            slots = torch.arange(s_block, s_block + span)
            val = torch.full((span,), n, dtype=torch.int64)
            if a < e:
                w_lo = a * bits >> 5
                nw = ((e * bits - 1) >> 5) - w_lo + 1
                assert nw <= span + 1, f"{nw} staged words"  # kStage
                staged = torch.cat([buf[1 + w_lo:1 + w_lo + nw],
                                    torch.zeros(1, dtype=torch.int64)])
                live = (slots >= a) & (slots < e)
                b = slots[live] * bits
                wi = (b >> 5) - w_lo
                pair = staged[wi] | (staged[torch.clamp(wi + 1, max=nw)]
                                     << 32)
                off = (pair >> (b & 31)) & mask
                val[live] = (k * chunk + off) & 0xFFFFFFFF
            inrow = (slots >= 0) & (slots < cap)
            out[row0 + slots[inrow]] = val[inrow]
            writes[row0 + slots[inrow]] += 1
    assert bool((writes == 1).all()), "a slot written twice or not at all"
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _edge_buckets(bits, cap, seed):
    """4 buckets at ``bits`` (chunk the widest such): counts 0, 1, cap
    and one in the second block of slots where cap allows; the offsets
    random below chunk."""
    chunk = (1 << bits) - 3 if bits > 2 else 1 << bits
    assert codec_bits(chunk) == bits
    rng = np.random.default_rng(seed)
    off = rng.integers(0, chunk, (4, cap), dtype=np.int64)
    off = torch.from_numpy(((off + 2**31) % 2**32 - 2**31).astype(np.int32))
    count = torch.tensor([0, 1, cap, min(cap, t_ops.BLOCK * t_ops.VEC + 5)],
                         dtype=torch.int32)
    return t_ref.encode_offsets(off, count, chunk).reshape(-1), chunk


@pytest.mark.parametrize("bits", [1, 20, 32])
@pytest.mark.parametrize("cap", [2048, 2049, 2050, 2051, 5])
def test_decode_blocks_match_plain(bits, cap):
    """The decode kernel's launch shape and block arithmetic
    (``decode_shape``, ``_decode_by_blocks``): rows that start and end
    inside a 16-byte vector (cap % 4 of 0 to 3), offsets of 1, 20 (slots
    that span two words) and 32 bits, counts 0, 1, cap and past a
    block's 1024 slots; every slot written once, tolerance 0 against the
    plain decode."""
    recv, chunk = _edge_buckets(bits, cap, bits * 10 + cap)
    n = 12345
    want = t_ref.decode_buckets(recv, chunk, cap, n)
    got = _decode_by_blocks(recv, chunk, cap, n, 4)
    assert torch.equal(got, want)
    assert torch.equal(t_ops.decode_buckets(recv, chunk, cap, n, 4), want)
    bits_, w, gx = t_ops.decode_shape(4, cap, chunk)
    assert (bits_, 1 + w) == (bits, codec_bucket_words(cap, bits))
    if bits == 20:                   # some live slot spans two words
        assert any((s * bits) % 32 > 32 - bits for s in range(cap))


@pytest.mark.parametrize("bits,cap", [(1, 1027), (20, 1030)])
def test_decode_blocks_match_pallas_interpret(bits, cap):
    """The same block arithmetic against the Pallas decode kernel run in
    interpret mode, across a block boundary and with rows off the
    16-byte vectors."""
    recv, chunk = _edge_buckets(bits, cap, bits)
    n = 4 * chunk
    got = _decode_by_blocks(recv, chunk, cap, n, 4)
    want = np.asarray(r_ops.decode_buckets(
        jnp.asarray(_u32(recv)), chunk, cap, n, 4))
    assert np.array_equal(got.numpy(), want)


def test_decode_grid_covers_every_row():
    """gx blocks of BLOCK vectors cover the vectors that touch any
    bucket's row, whichever 16-byte offset the row starts at."""
    for cap in range(1, 3000, 7):
        for p in (1, 3, 16):
            gx = t_ops.decode_shape(p, cap, 1024)[2]
            for k in range(min(p, 4)):
                first, last = k * cap // 4, (k * cap + cap - 1) // 4
                assert last - first + 1 <= gx * t_ops.BLOCK, (cap, p, k)


# ---------------------------------------------------------------------------
# The encode kernel (csrc/codec_encode.cu): launch shape and packed argument
# ---------------------------------------------------------------------------

_ENC_BITS = [1, 7, 18, 20, 31, 32]


def _chunk_of(bits):
    """The widest chunk whose offsets take ``bits`` bits."""
    chunk = (1 << bits) - 3 if bits > 2 else 1 << bits
    assert codec_bits(chunk) == bits
    return chunk


@pytest.mark.parametrize("bits", _ENC_BITS)
def test_encode_shape_covers_every_word_once(bits):
    """``encode_shape``: the bits and W of the plain encode, and gx blocks
    a bucket of ENCODE_BLOCK threads, each thread 32 slots and ``bits``
    whole words: every payload word below W lies in exactly one thread,
    every block holds at least one word below W, and an empty row still
    gets the block that writes its count word.  Caps below 32, not a
    multiple of 32, one past a block, and the path's two shapes."""
    assert t_ops.ENCODE_SLOTS == t_ops.ENCODE_BLOCK * t_ops.THREAD_SLOTS
    chunk = _chunk_of(bits)
    for cap in (0, 1, 5, 31, 33, 100, 4095, 4096, 4097, 13112, 52448):
        b, w, gx = t_ops.encode_shape(16, cap, chunk)
        assert (b, w) == (bits, codec_bucket_words(cap, bits) - 1)
        assert gx == max(1, -(-cap // t_ops.ENCODE_SLOTS))
        assert gx * t_ops.ENCODE_SLOTS >= cap
        assert (gx - 1) * t_ops.ENCODE_SLOTS < max(cap, 1)
        # thread t of block x owns words [(x*BLOCK + t)*bits, +bits)
        per_block = t_ops.ENCODE_BLOCK * bits
        assert gx * per_block >= w
        assert all(x * per_block < w for x in range(gx)) or cap == 0


def test_encode_packed_argument_round_trips():
    """The C entry's one argument: 9 int64 values in the order the
    kernel's ``codec_encode(const long long*)`` reads them."""
    vals = (2**47 + 16, 2**40 + 4, 2**45 + 256, 16, 52448, 20, 32780, 13,
            2**63 - 1)
    buf = t_ops._ENCODE_ARGS.pack(*vals)
    assert len(buf) == 9 * 8
    assert t_ops._ENCODE_ARGS.unpack(buf) == vals
    assert np.array_equal(np.frombuffer(buf, np.int64), np.array(vals))
    assert t_ops.ENCODE.argtypes == [ctypes.c_char_p]


def test_encode_rejects_more_buckets_than_the_grid_holds():
    """p > 65535 raises before anything is built or launched (meta
    tensors stand in for CUDA ones); at 65535 the call gets as far as
    the device check."""
    off = torch.empty((65536, 8), dtype=torch.int32, device="meta")
    count = torch.empty(65536, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most 65535"):
        t_ops.encode_offsets(off, count, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        t_ops.encode_offsets(off[:65535], count[:65535], 64)

