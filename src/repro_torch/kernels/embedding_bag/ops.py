"""Table-batched EmbeddingBag (kernel 8): the wrapper of the CUDA kernel
``csrc/embedding_bag.cu``; its plain PyTorch version is
``kernels/embedding_bag/ref.py``.

The Pallas kernel's tiling arguments (``bt``, which needed ``B % bt ==
0``, and ``interpret``) have no counterpart: any number of bags runs.
``bag_weights=None`` passes a null pointer, not a tensor of ones.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.embedding_bag import ref

KERNEL = CudaKernel("embedding_bag", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

_DTYPES = (torch.float32, torch.bfloat16)


def _check(table, bag_ids, bag_weights, mode):
    if table.dim() != 2 or table.dtype not in _DTYPES \
            or not table.is_contiguous() or table.shape[0] == 0:
        raise ValueError(f"table must be a contiguous non-empty (V, D) "
                         f"float32 or bfloat16 tensor, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if bag_ids.dim() != 2 or bag_ids.dtype != torch.int32 \
            or not bag_ids.is_contiguous():
        raise ValueError(f"bag_ids must be a contiguous (B, L) int32 "
                         f"tensor, got {bag_ids.dtype} "
                         f"{tuple(bag_ids.shape)}")
    if bag_weights is not None and (
            bag_weights.shape != bag_ids.shape
            or bag_weights.dtype != torch.float32
            or not bag_weights.is_contiguous()):
        raise ValueError(f"bag_weights must be a contiguous float32 tensor "
                         f"of the ids' shape {tuple(bag_ids.shape)}, got "
                         f"{bag_weights.dtype} {tuple(bag_weights.shape)}")
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")


def launch(table: torch.Tensor, bag_ids: torch.Tensor,
           bag_weights: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors: the (B, D) result."""
    n_bags, width = bag_ids.shape
    n_rows, dim = table.shape
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    KERNEL.launch(table.data_ptr(), bag_ids.data_ptr(),
                  None if bag_weights is None else bag_weights.data_ptr(),
                  out.data_ptr(), n_bags, width, n_rows, dim,
                  int(mode == "mean"), int(table.dtype == torch.bfloat16),
                  stream_handle(table.device))
    return out


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """(B, D) in the table's dtype: per bag, the weighted sum ("sum") or
    weighted mean ("mean") of the rows ``bag_ids`` names (-1 = pad),
    accumulated in float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(table, bag_ids, bag_weights, mode)
    tensors = [table, bag_ids] + ([] if bag_weights is None
                                  else [bag_weights])
    if all(t.device.type == "cpu" for t in tensors):
        return ref.embedding_bag(table, bag_ids, bag_weights, mode)
    KERNEL.load()
    require_cuda(*tensors)
    return launch(table, bag_ids, bag_weights, mode)
