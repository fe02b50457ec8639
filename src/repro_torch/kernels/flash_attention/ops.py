"""Blocked online-softmax attention (kernel 9): the wrapper of the CUDA
kernel ``csrc/flash_attention.cu``; its plain PyTorch version is
``kernels/flash_attention/ref.py``.

``flash_attention_gqa`` takes the model's (B, S, H, dh) layout with
fewer kv heads than query heads, and strided views (a slice of the KV
cache) as they are; the Pallas kernel's (BH, S, dh) layout is the case
of one head, ``x[:, :, None]``.  The Pallas tiling arguments (``bq``,
``bk``, ``interpret``) have no counterpart: the query tile is chosen
from Sq here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.flash_attention import ref

KERNEL = CudaKernel("flash_attention", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)
_GROUPS = 64          # query-row groups of a block (kGroups in the source)


def _check(q, k, v, window, q_offset):
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh)."""
    b, sq, hq, dh = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh \
            or k.shape[1] < 1 or hq % k.shape[2]:
        raise ValueError(f"k and v must be (B, Sk >= 1, Hkv, dh) with Hkv "
                         f"dividing Hq, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def query_tile(sq: int) -> int:
    """Rows of the block's query tile: 64, or the power of two at or
    above Sq for short queries (whose keys the groups then split)."""
    bq = 1
    while bq < min(sq, _GROUPS):
        bq *= 2
    return bq


def launch(q, k, v, causal: bool, window: Optional[int],
           q_offset: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors in the (B, S, H, dh)
    layout: the (B, Sq, Hq, dh) result, contiguous."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, hq, dh, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *[x.stride(i) for x in (q, k, v, out) for i in (0, 2, 1)])
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  strides, b, hq, hq // hkv, sq, sk, dh, q_offset,
                  0 if window is None else window, int(causal),
                  query_tile(sq), dh ** -0.5, int(q.dtype == torch.bfloat16),
                  stream_handle(q.device))
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, dh) over k, v (B, Sk, Hkv, dh), query
    head h reading kv head h // (Hq // Hkv), query row i at absolute
    position ``q_offset + i``; -> (B, Sq, Hq, dh) in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    _check(q, k, v, window, q_offset)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention_gqa(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    KERNEL.load()
    require_cuda(q, k, v)
    return launch(q, k, v, causal, window, q_offset)
