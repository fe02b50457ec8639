"""Table-batched EmbeddingBag (kernel 8): the wrapper of the CUDA kernel
``csrc/embedding_bag.cu``; its plain PyTorch version is
``kernels/embedding_bag/ref.py``.

The Pallas kernel's tiling arguments (``bt``, which needed ``B % bt ==
0``, and ``interpret``) have no counterpart: any number of bags runs.
``bag_weights=None`` passes a null pointer, not a tensor of ones.
``layout`` and ``grid`` are the launch's shape: a bag's row is read by
``lanes`` threads, each ``vec`` elements at a time, and every thread
carries ``BAGS_PER_THREAD`` bags.

``embedding_bag_backward`` is the table gradient, the wrapper of kernel
8b (``csrc/embedding_bag_bwd.cu``), whose plain version is
``ref.embedding_bag_backward``; ``prepare_backward`` is its launch prep
in plain torch (the live terms stable-sorted by row, one segment a
row).  ``embedding_bag_trainable`` is kernel 8 with that gradient, the
``torch.autograd.Function`` the training path calls.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Tuple

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
# kernel 8b's entry takes its 15 values the same way (dout, bags,
# weights or 0, den or 0, seg_rows, seg_off, dtable, n_seg, D, bf16, vec,
# lanes, gx, gy, stream)
KERNEL_BWD = CudaKernel("embedding_bag_bwd", [ctypes.c_char_p])

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
    _check_bags(bag_ids, bag_weights, mode)


def _check_bags(bag_ids, bag_weights, mode):
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


class BackwardPrep(NamedTuple):
    """Kernel 8b's launch prep: the live (bag, slot) terms sorted by the
    row they read (stable, so a row's terms keep their flat order), and
    one segment a live row."""
    bags: torch.Tensor       # (n_terms,) int32, each term's bag
    weights: Optional[torch.Tensor]  # (n_terms,) float32, or None (all 1)
    den: Optional[torch.Tensor]      # (B,) float32 "mean" divisors, or None
    seg_rows: torch.Tensor   # (n_seg,) int32, the row of each segment
    seg_off: torch.Tensor    # (n_seg + 1,) int32, its terms' range


def prepare_backward(bag_ids: torch.Tensor,
                     bag_weights: Optional[torch.Tensor], mode: str,
                     n_rows: int) -> BackwardPrep:
    """The live terms (id >= 0) in flat order, their rows clamped to
    n_rows - 1 as the forward reads them, stable-sorted by row; the
    segment offsets by ``unique_consecutive``.  Plain torch, on the ids'
    device (two host reads: the live count and the segment count)."""
    width = bag_ids.shape[1]
    flat = bag_ids.reshape(-1)
    if flat.numel() >= 2 ** 31:
        raise ValueError(f"{flat.numel()} (bag, slot) terms: the kernel's "
                         f"offsets are int32")
    pos = torch.nonzero(flat >= 0).squeeze(1)
    rows = flat[pos].clamp(max=n_rows - 1)
    rows, order = torch.sort(rows, stable=True)
    pos = pos[order]
    seg_rows, counts = torch.unique_consecutive(rows, return_counts=True)
    seg_off = torch.zeros(seg_rows.numel() + 1, dtype=torch.int32,
                          device=flat.device)
    seg_off[1:] = torch.cumsum(counts, 0)
    return BackwardPrep(
        bags=torch.div(pos, width, rounding_mode="floor").to(torch.int32),
        weights=None if bag_weights is None
        else bag_weights.reshape(-1)[pos].contiguous(),
        den=ref.bag_denominators(bag_ids, bag_weights) if mode == "mean"
        else None,
        seg_rows=seg_rows.to(torch.int32), seg_off=seg_off)


def launch_backward(grad_out: torch.Tensor, prep: BackwardPrep,
                    n_rows: int) -> torch.Tensor:
    """Kernel 8b on checked CUDA tensors: the (n_rows, D) table gradient,
    zero where no segment writes."""
    dim = grad_out.shape[1]
    out = torch.zeros(n_rows, dim, dtype=grad_out.dtype,
                      device=grad_out.device)
    n_seg = prep.seg_rows.numel()
    aligned = (grad_out.data_ptr() % VECTOR_BYTES == 0
               and out.data_ptr() % VECTOR_BYTES == 0)
    vec, lanes = layout(dim, grad_out.element_size(), aligned)
    per_block = BLOCK // lanes
    gx, gy = -(-n_seg // per_block), -(-(dim // vec) // lanes)
    KERNEL_BWD.launch(_ARGS.pack(
        grad_out.data_ptr(), prep.bags.data_ptr(),
        0 if prep.weights is None else prep.weights.data_ptr(),
        0 if prep.den is None else prep.den.data_ptr(),
        prep.seg_rows.data_ptr(), prep.seg_off.data_ptr(), out.data_ptr(),
        n_seg, dim, grad_out.dtype == torch.bfloat16, vec, lanes, gx, gy,
        stream_handle(grad_out.device)))
    return out


def embedding_bag_backward(grad_out: torch.Tensor, bag_ids: torch.Tensor,
                           n_rows: int,
                           bag_weights: Optional[torch.Tensor] = None,
                           mode: str = "sum") -> torch.Tensor:
    """The dense (n_rows, D) gradient of ``embedding_bag``'s table, in
    grad_out's dtype (the table's), given grad_out (B, D).  CPU tensors
    take the plain version; CUDA tensors launch kernel 8b."""
    if grad_out.dim() != 2 or grad_out.dtype not in _DTYPES \
            or grad_out.shape[0] != bag_ids.shape[0] or n_rows < 1:
        raise ValueError(f"grad_out must be a (B, D) float32 or bfloat16 "
                         f"tensor with B = {bag_ids.shape[0]} bags, and "
                         f"n_rows >= 1; got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)}, n_rows {n_rows}")
    _check_bags(bag_ids, bag_weights, mode)
    grad_out = grad_out.contiguous()
    tensors = [grad_out, bag_ids] + ([] if bag_weights is None
                                     else [bag_weights])
    if all(t.is_cpu for t in tensors):
        return ref.embedding_bag_backward(grad_out, bag_ids, n_rows,
                                          bag_weights, mode)
    KERNEL_BWD.load()
    require_cuda(*tensors)
    return launch_backward(grad_out,
                           prepare_backward(bag_ids, bag_weights, mode,
                                            n_rows), n_rows)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, bag_ids, bag_weights, mode):
        ctx.save_for_backward(bag_ids, bag_weights)
        ctx.n_rows, ctx.mode = table.shape[0], mode
        return embedding_bag(table, bag_ids, bag_weights, mode)

    @staticmethod
    def backward(ctx, grad_out):
        bag_ids, bag_weights = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = embedding_bag_backward(grad_out, bag_ids, ctx.n_rows,
                                          bag_weights, ctx.mode)
        return grad, None, None, None


def embedding_bag_trainable(table: torch.Tensor, bag_ids: torch.Tensor,
                            bag_weights: Optional[torch.Tensor] = None,
                            mode: str = "sum") -> torch.Tensor:
    """``embedding_bag`` (kernel 8) with the table's gradient by kernel
    8b (the plain versions for CPU tensors); no gradient for the
    weights."""
    return _EmbeddingBag.apply(table, bag_ids, bag_weights, mode)
