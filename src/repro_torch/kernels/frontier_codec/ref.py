"""Plain PyTorch versions of the "1ds" frontier codec: count-prefixed
fixed-width bit-packing of local offsets.  Twins of the JAX package's
``kernels/frontier_codec/ref.py``, batched over buckets.

A bucket is

    word 0       the live-id count, clamped to cap
    words 1..W   the cap offsets bit-packed at ``bits = codec_bits(chunk)``
                 bits each (W = ceil(cap*bits/32)); slots at or past the
                 count are packed as 0

Packed bit b is bit (b % bits) of offset b // bits.  Words are int32
holding uint32 bits (``core/frontier.py``).  The receiver rebases the
offsets of bucket k by k*chunk, since bucket position k in the tiled
allgather names the owner.
"""
from __future__ import annotations

import torch

from repro_torch.core.comm_model import codec_bits, codec_packed_words

_M32 = 0xFFFFFFFF


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def encode_offsets(off: torch.Tensor, count: torch.Tensor, chunk: int
                   ) -> torch.Tensor:
    """``(..., cap)`` int32 local offsets + ``(...)`` live counts ->
    ``(..., 1 + W)`` int32 buckets."""
    cap = off.shape[-1]
    bits = codec_bits(chunk)
    w = codec_packed_words(cap, bits)
    dev = off.device
    o = off.reshape(-1, cap).to(torch.int64) & _M32
    cnt = torch.clamp(count.reshape(-1, 1).to(torch.int64) & _M32, max=cap)
    slot = torch.arange(cap, device=dev)
    v = torch.where(slot < cnt, o, 0)
    b = torch.arange(w * 32, device=dev)
    s = torch.div(b, bits, rounding_mode="floor")
    bit = (v[:, s.clamp(max=cap - 1)] >> (b % bits)) & 1
    bit = torch.where(s < cap, bit, 0)
    words = (bit.reshape(-1, w, 32) << torch.arange(32, device=dev)).sum(-1)
    out = torch.cat([cnt, words], dim=1)
    return _to_i32(out).reshape(*off.shape[:-1], 1 + w)


def decode_buckets(recv: torch.Tensor, chunk: int, cap: int, n: int
                   ) -> torch.Tensor:
    """``(p * (1 + W),)`` int32 allgathered buckets -> ``(p * cap,)``
    int32 global ids; slots past each bucket's count decode to the
    ``unpack_ids`` drop sentinel ``n``."""
    bits = codec_bits(chunk)
    w = codec_packed_words(cap, bits)
    dev = recv.device
    bufs = recv.reshape(-1, 1 + w)
    p = bufs.shape[0]
    counts = bufs[:, :1]                                   # int32
    packed = bufs[:, 1:].to(torch.int64) & _M32
    slot = torch.arange(cap, device=dev)
    t = torch.arange(bits, device=dev)
    b = slot[:, None] * bits + t[None, :]                  # (cap, bits)
    bit = (packed[:, b >> 5] >> (b & 31)) & 1              # (p, cap, bits)
    val = (bit << t).sum(-1)
    k = torch.arange(p, device=dev)[:, None]
    ids = torch.where(slot < counts, k * chunk + val, n)
    return ids.to(torch.int32).reshape(-1)
