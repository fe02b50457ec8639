"""The "1ds" frontier codec: wrappers of the CUDA kernels
``csrc/codec_encode.cu`` and ``csrc/codec_decode.cu``.  CPU tensors take
the plain versions of ``ref.py``; CUDA tensors launch the kernels.

The encode kernel gives a thread 32 consecutive slots of one bucket
(``bits`` whole payload words) and a block ``ENCODE_BLOCK`` threads;
``encode_shape`` is its launch shape.  The decode kernel gives a thread
4 consecutive slots of the flat output and a block ``BLOCK`` threads of
one bucket; ``decode_shape`` is its launch shape.  Both C entries take
one argument, their values packed as int64: the path calls each once an
exchange at a few microseconds of device work, where ctypes' conversion
of typed arguments one by one is a cost of its own."""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.core.comm_model import codec_bits, codec_packed_words
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.frontier_codec import ref

# (off, count, out, p, cap, bits, w, gx, stream)
ENCODE = CudaKernel("codec_encode", [ctypes.c_char_p])
_ENCODE_ARGS = struct.Struct("9q")
# (recv, out, p, cap, bits, w, chunk, n, gx, stream)
DECODE = CudaKernel("codec_decode", [ctypes.c_char_p])
_DECODE_ARGS = struct.Struct("10q")
ENCODE_BLOCK = 128    # threads of an encode block (kBlock)
THREAD_SLOTS = 32     # slots of an encode thread, bits words (kThreadSlots)
ENCODE_SLOTS = ENCODE_BLOCK * THREAD_SLOTS   # slots of an encode block
BLOCK = 256           # threads of a decode block (kBlock)
VEC = 4               # slots of a thread, one 16-byte store (kVec)
MAX_BUCKETS = 65535   # the grid's y dimension, both kernels


def _check_i32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")


@functools.lru_cache(maxsize=256)
def encode_shape(p: int, cap: int, chunk: int) -> Tuple[int, int, int]:
    """(bits, W, gx) of an encode launch: the offset width, the payload
    words of a bucket, and the blocks a bucket, one per ENCODE_SLOTS
    slots and at least one, which writes an empty row's count word.
    The path repeats its shapes, so each is worked out once."""
    bits = codec_bits(chunk)
    return (bits, codec_packed_words(cap, bits),
            max(1, -(-cap // ENCODE_SLOTS)))


def encode_offsets(off: torch.Tensor, count: torch.Tensor, chunk: int
                   ) -> torch.Tensor:
    """``(p, cap)`` int32 local offsets + ``(p,)`` int32 live counts ->
    ``(p, 1 + W)`` int32 buckets, one launch for all p."""
    if off.dtype != torch.int32 or count.dtype != torch.int32 or \
            not (off.is_contiguous() and count.is_contiguous()):
        _check_i32(off=off, count=count)
    if off.dim() != 2 or count.shape != off.shape[:1]:
        raise ValueError(f"off must be (p, cap) and count (p,), got "
                         f"{tuple(off.shape)} and {tuple(count.shape)}")
    if off.is_cpu and count.is_cpu:
        return ref.encode_offsets(off, count, chunk)
    p, cap = off.shape
    return _launch_encode(off, count, chunk, encode_shape(p, cap, chunk))


def launch_encode(off, count, chunk: int) -> torch.Tensor:
    return _launch_encode(off, count, chunk,
                          encode_shape(*off.shape, chunk))


def _launch_encode(off, count, chunk: int, shape) -> torch.Tensor:
    bits, w, gx = shape
    p = off.shape[0]
    if p > MAX_BUCKETS:
        raise ValueError(f"the encode kernel takes at most {MAX_BUCKETS} "
                         f"buckets, got {p}")
    if not (off.is_cuda and count.device == off.device):
        require_cuda(off, count)
    out = torch.empty((p, 1 + w), dtype=torch.int32, device=off.device)
    ENCODE.launch(_ENCODE_ARGS.pack(
        off.data_ptr(), count.data_ptr(), out.data_ptr(), p, off.shape[1],
        bits, w, gx, stream_handle(off.device)))
    return out


@functools.lru_cache(maxsize=256)
def decode_shape(p: int, cap: int, chunk: int) -> Tuple[int, int, int]:
    """(bits, W, gx) of a decode launch: the offset width, the payload
    words of a bucket, and the blocks a bucket, enough for the vectors
    that touch a row of ``cap`` slots (at most (cap + 2) // 4 + 1, as a
    row need not start on a vector).  The path repeats its shapes, so
    each is worked out once."""
    bits = codec_bits(chunk)
    vectors = (cap + 2) // VEC + 1
    return bits, codec_packed_words(cap, bits), -(-vectors // BLOCK)


def decode_buckets(recv: torch.Tensor, chunk: int, cap: int, n: int,
                   p: int) -> torch.Tensor:
    """``(p * (1 + W),)`` int32 buckets -> ``(p * cap,)`` int32 global
    ids (sentinel ``n`` past each count), one launch for all p."""
    if recv.dtype != torch.int32 or not recv.is_contiguous():
        _check_i32(recv=recv)
    shape = decode_shape(p, cap, chunk)
    if recv.numel() != p * (1 + shape[1]):
        raise ValueError(f"recv has {recv.numel()} words, expected "
                         f"p*(1+W) = {p}*{1 + shape[1]}")
    if recv.is_cpu:
        return ref.decode_buckets(recv, chunk, cap, n)
    if not recv.is_cuda:
        require_cuda(recv)
    return _launch_decode(recv, chunk, cap, n, p, shape)


def launch_decode(recv, chunk: int, cap: int, n: int, p: int
                  ) -> torch.Tensor:
    return _launch_decode(recv, chunk, cap, n, p, decode_shape(p, cap, chunk))


def _launch_decode(recv, chunk: int, cap: int, n: int, p: int, shape
                   ) -> torch.Tensor:
    bits, w, gx = shape
    if p > MAX_BUCKETS:
        raise ValueError(f"the decode kernel takes at most {MAX_BUCKETS} "
                         f"buckets, got {p}")
    out = torch.empty(p * cap, dtype=torch.int32, device=recv.device)
    DECODE.launch(_DECODE_ARGS.pack(
        recv.data_ptr(), out.data_ptr(), p, cap, bits, w, chunk, n, gx,
        stream_handle(recv.device)))
    return out

