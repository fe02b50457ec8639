"""The "1ds" frontier codec: wrappers of the CUDA kernels
``csrc/codec_encode.cu`` and ``csrc/codec_decode.cu``.  CPU tensors take
the plain versions of ``ref.py``; CUDA tensors launch the kernels.

The decode kernel gives a thread 4 consecutive slots of the flat output
and a block ``BLOCK`` threads of one bucket; ``decode_shape`` is its
launch shape."""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.core.comm_model import codec_bits, codec_packed_words
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.frontier_codec import ref

ENCODE = CudaKernel("codec_encode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# The decode's C entry takes one argument, its 10 values packed as int64
# (recv, out, p, cap, bits, w, chunk, n, gx, stream): the path calls it
# once an exchange at a few microseconds of device work, where ctypes'
# conversion of typed arguments one by one is a cost of its own.
DECODE = CudaKernel("codec_decode", [ctypes.c_char_p])
_DECODE_ARGS = struct.Struct("10q")
BLOCK = 256           # threads of a decode block (kBlock)
VEC = 4               # slots of a thread, one 16-byte store (kVec)
MAX_BUCKETS = 65535   # the grid's y dimension


def _check_i32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")


def encode_offsets(off: torch.Tensor, count: torch.Tensor, chunk: int
                   ) -> torch.Tensor:
    """``(p, cap)`` int32 local offsets + ``(p,)`` int32 live counts ->
    ``(p, 1 + W)`` int32 buckets, one launch for all p."""
    _check_i32(off=off, count=count)
    if off.dim() != 2 or count.shape != off.shape[:1]:
        raise ValueError(f"off must be (p, cap) and count (p,), got "
                         f"{tuple(off.shape)} and {tuple(count.shape)}")
    if all(t.device.type == "cpu" for t in (off, count)):
        return ref.encode_offsets(off, count, chunk)
    ENCODE.load()
    require_cuda(off, count)
    return launch_encode(off, count, chunk)


def launch_encode(off, count, chunk: int) -> torch.Tensor:
    p, cap = off.shape
    bits = codec_bits(chunk)
    w = codec_packed_words(cap, bits)
    out = torch.empty((p, 1 + w), dtype=torch.int32, device=off.device)
    ENCODE.launch(off.data_ptr(), count.data_ptr(), out.data_ptr(), p, cap,
                  bits, w, stream_handle(off.device))
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

