"""Table-batched EmbeddingBag (kernel 8): the wrapper of the CUDA kernel
``csrc/embedding_bag.cu``; its plain PyTorch version is
``kernels/embedding_bag/ref.py``.

The Pallas kernel's tiling arguments (``bt``, which needed ``B % bt ==
0``, and ``interpret``) have no counterpart: any number of bags runs.
``bag_weights=None`` passes a null pointer, not a tensor of ones.
``layout`` and ``grid`` are the launch's shape: a bag's row is read by
``lanes`` threads, each ``vec`` elements at a time, and every thread
carries ``BAGS_PER_THREAD`` bags.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.kernels.embedding_bag import ref

# The C entry takes one argument, the launch's 15 values packed as int64
# (table, ids, weights or 0, out, n_bags, L, n_rows, D, mean, bf16, vec,
# lanes, gx, gy, stream): ctypes converts fifteen typed arguments one by
# one on the host, where serving's small lookups spend most of their
# time, and packing them is cheaper.
KERNEL = CudaKernel("embedding_bag", [ctypes.c_char_p])
_ARGS = struct.Struct("15q")

_DTYPES = (torch.float32, torch.bfloat16)
BLOCK = 256            # threads a block (kBlock)
BAGS_PER_THREAD = 4    # bags a thread carries, its rows in flight (kBags)
VECTOR_BYTES = 16      # a lane's load where the row allows it


@functools.lru_cache(maxsize=None)
def layout(dim: int, elt_size: int, aligned: bool) -> Tuple[int, int]:
    """(vec, lanes): the elements a lane loads at once, 16 bytes' worth
    where a row of ``dim`` elements of ``elt_size`` bytes is a whole
    number of 16-byte vectors and the table is 16-byte ``aligned``, else
    1; and the lanes that read a bag's row, one vector each, at most a
    block (a wider row is cut into slices of BLOCK lanes)."""
    vec = VECTOR_BYTES // elt_size
    if not aligned or dim % vec:
        vec = 1
    return vec, max(1, min(dim // vec, BLOCK))


def grid(n_bags: int, dim: int, vec: int, lanes: int) -> Tuple[int, int]:
    """(x, y): blocks of BLOCK // lanes bags side by side times
    BAGS_PER_THREAD, and the row's slices of ``lanes`` vectors."""
    per_block = BLOCK // lanes * BAGS_PER_THREAD
    return -(-n_bags // per_block), -(-(dim // vec) // lanes)


@functools.lru_cache(maxsize=256)
def _shape(n_bags: int, dim: int, elt_size: int, aligned: bool):
    """(vec, lanes, gx, gy) of a launch; serving repeats its batch sizes,
    so the shapes are worked out once each."""
    vec, lanes = layout(dim, elt_size, aligned)
    return (vec, lanes) + grid(n_bags, dim, vec, lanes)


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
    ptr = table.data_ptr()
    vec, lanes, gx, gy = _shape(n_bags, dim, table.element_size(),
                                ptr % VECTOR_BYTES == 0)
    out = torch.empty(n_bags, dim, dtype=table.dtype, device=table.device)
    KERNEL.launch(_ARGS.pack(
        ptr, bag_ids.data_ptr(),
        0 if bag_weights is None else bag_weights.data_ptr(),
        out.data_ptr(), n_bags, width, n_rows, dim, mode == "mean",
        table.dtype == torch.bfloat16, vec, lanes, gx, gy,
        stream_handle(table.device)))
    return out


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """(B, D) in the table's dtype: per bag, the weighted sum ("sum") or
    weighted mean ("mean") of the rows ``bag_ids`` names (-1 = pad),
    accumulated in float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(table, bag_ids, bag_weights, mode)
    if table.is_cpu and bag_ids.is_cpu and (bag_weights is None
                                            or bag_weights.is_cpu):
        return ref.embedding_bag(table, bag_ids, bag_weights, mode)
    KERNEL.load()
    if bag_weights is None:
        require_cuda(table, bag_ids)
    else:
        require_cuda(table, bag_ids, bag_weights)
    return launch(table, bag_ids, bag_weights, mode)
