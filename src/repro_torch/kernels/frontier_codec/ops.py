"""The "1ds" frontier codec: wrappers of the CUDA kernels
``csrc/codec_encode.cu`` and ``csrc/codec_decode.cu``.  CPU tensors take
the plain versions of ``ref.py``; CUDA tensors launch the kernels."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.comm_model import codec_bits, codec_packed_words
from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.frontier_codec import ref

ENCODE = CudaKernel("codec_encode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
DECODE = CudaKernel("codec_decode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p])


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


def decode_buckets(recv: torch.Tensor, chunk: int, cap: int, n: int,
                   p: int) -> torch.Tensor:
    """``(p * (1 + W),)`` int32 buckets -> ``(p * cap,)`` int32 global
    ids (sentinel ``n`` past each count), one launch for all p."""
    _check_i32(recv=recv)
    w = codec_packed_words(cap, codec_bits(chunk))
    if recv.numel() != p * (1 + w):
        raise ValueError(f"recv has {recv.numel()} words, expected "
                         f"p*(1+W) = {p}*{1 + w}")
    if recv.device.type == "cpu":
        return ref.decode_buckets(recv, chunk, cap, n)
    DECODE.load()
    require_cuda(recv)
    return launch_decode(recv, chunk, cap, n, p)


def launch_decode(recv, chunk: int, cap: int, n: int, p: int
                  ) -> torch.Tensor:
    bits = codec_bits(chunk)
    w = codec_packed_words(cap, bits)
    out = torch.empty(p * cap, dtype=torch.int32, device=recv.device)
    DECODE.launch(recv.data_ptr(), out.data_ptr(), p, cap, bits, w, chunk,
                  n, stream_handle(recv.device))
    return out
