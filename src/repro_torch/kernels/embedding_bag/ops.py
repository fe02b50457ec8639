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
``ref.embedding_bag_backward``.  It runs on the device with no host
read: ``prepare_backward`` launches the key kernel (``backward_keys``:
each term's row, the pads' sentinel n_rows, the "mean" divisors) and the
radix sort (``sort_keys``); ``launch_backward`` launches the tile kernel
(``tile_bounds``: runs of rows with at most ``tile_items`` rows plus
terms) and the gradient kernel, whose blocks each write a tile's rows of
the dense output once.  ``backward_keys_plain``, ``sort_keys_plain`` and
``tile_bounds_plain`` are the plain twins of that prep, which
``prepare_backward`` and ``tile_bounds`` take for CPU tensors.  ``embedding_bag_trainable`` is kernel 8 with that
gradient, the ``torch.autograd.Function`` the training path calls.

``forward_cost`` and ``backward_cost`` are a call's FLOPs and bytes,
which the public entries report to an active ``launch/roofline.py``
counter and from which ``chip_smoke.py`` takes the kernel table's
bounds.  On PyTorch's ``meta`` device the entries allocate their outputs
and scratch (8b's keys, sort and tile buffers) there and launch nothing.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel, stream_handle
from repro_torch.kernels.embedding_bag import ref
from repro_torch.launch.roofline import kernel as count_kernel

# The C entry takes one argument, the launch's 15 values packed as int64
# (table, ids, weights or 0, out, n_bags, L, n_rows, D, mean, bf16, vec,
# lanes, gx, gy, stream): ctypes converts fifteen typed arguments one by
# one on the host, where serving's small lookups spend most of their
# time, and packing them is cheaper.
KERNEL = CudaKernel("embedding_bag", [ctypes.c_char_p])
_ARGS = struct.Struct("15q")
# kernel 8b's four C entries take their values the same way: the key
# kernel's 9 (ids, weights or 0, keys, den or 0, n, B, L, n_rows,
# stream), the sort's 10 (keys, keys_a, keys_b, pos_a, pos_b, hist,
# totals, n, bits, stream), the tile kernel's 6 (keys, bounds, n, n_rows,
# items, stream) and the gradient kernel's 16 (dout, keys, pos, bounds,
# weights or 0, den or 0, dtable, L, n_rows, D, bf16, vec, lanes, gx, gy,
# stream)
KERNEL_BWD_KEYS = CudaKernel("embedding_bag_bwd_keys", [ctypes.c_char_p],
                             stem="embedding_bag_bwd")
KERNEL_BWD_SORT = CudaKernel("embedding_bag_bwd_sort", [ctypes.c_char_p],
                             stem="embedding_bag_bwd")
KERNEL_BWD_TILES = CudaKernel("embedding_bag_bwd_tiles", [ctypes.c_char_p],
                              stem="embedding_bag_bwd")
KERNEL_BWD = CudaKernel("embedding_bag_bwd", [ctypes.c_char_p])
_KEY_ARGS = struct.Struct("9q")
_SORT_ARGS = struct.Struct("10q")
_TILE_ARGS = struct.Struct("6q")
_BWD_ARGS = struct.Struct("16q")

_DTYPES = (torch.float32, torch.bfloat16)
BLOCK = 256            # threads a block (kBlock)
BAGS_PER_THREAD = 4    # bags a thread carries, its rows in flight (kBags)
VECTOR_BYTES = 16      # a lane's load where the row allows it
SORT_TILE = 4096       # the keys a block of kernel 8b's sort holds
RADIX_BINS = 256       # its digits, 8 bits a pass
STAGE_FLOATS = 8192    # the floats of terms a block of kernel 8b stages
MAX_ITEMS = 1024       # the rows plus terms of its tile at most (kMaxTile)


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


def tile_items(vec: int, lanes: int) -> int:
    """C, the rows plus terms of a tile of kernel 8b: 15/16 of the terms
    a block stages, each ``lanes * vec`` floats of its row slice, at most
    MAX_ITEMS.  A tile's terms may pass C by its last row's, and the
    sixteenth left over keeps such a tile staged where its rows are short
    (AutoInt's 2,000-row fields, about 33 terms a row)."""
    return max(1, min(MAX_ITEMS, STAGE_FLOATS // (lanes * vec) * 15 // 16))


def forward_cost(n_bags: int, n_ids: int, n_rows: int, dim: int, elt: int,
                 weighted: bool = False,
                 distinct: Optional[int] = None) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-8 call: the ids (and weights) read,
    each distinct row read once, the (B, D) output written once; 2 flops
    a term and element.  The rows read are ``distinct`` where the caller
    counted them, else the static bound min(ids, rows) (the entry reads
    nothing back to count them)."""
    rows = min(n_ids, n_rows) if distinct is None else distinct
    return (2 * n_ids * dim,
            4 * n_ids * (2 if weighted else 1) + rows * dim * elt
            + n_bags * dim * elt)


def backward_cost(n_bags: int, n_ids: int, n_rows: int, dim: int, elt: int,
                  weighted: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one kernel-8b call (its public entry): the ids
    (and weights) and dOut read once, the dense (n_rows, D) gradient
    written once; 2 flops a term and element."""
    return (2 * n_ids * dim,
            4 * n_ids * (2 if weighted else 1) + n_bags * dim * elt
            + n_rows * dim * elt)


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
    KERNEL.launch_on(table.device, _ARGS.pack(
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
    with count_kernel("embedding_bag", lambda: forward_cost(
            bag_ids.shape[0], bag_ids.numel(), table.shape[0],
            table.shape[1], table.element_size(), bag_weights is not None),
            table.dtype):
        if table.is_cpu and bag_ids.is_cpu and (bag_weights is None
                                                or bag_weights.is_cpu):
            return ref.embedding_bag(table, bag_ids, bag_weights, mode)
        if bag_weights is None:
            KERNEL.ready(table, bag_ids)
        else:
            KERNEL.ready(table, bag_ids, bag_weights)
        return launch(table, bag_ids, bag_weights, mode)


class BackwardPrep(NamedTuple):
    """Kernel 8b's launch prep: every (bag, slot) term's key, the row it
    reads or n_rows for a pad, stable-sorted, so a row's terms keep their
    flat order and the pads come last; the sort's permutation, each sorted
    term's flat position b * L + j; and what the gradient kernel reads
    beside them."""
    keys: torch.Tensor       # (B * L,) int32, sorted
    pos: torch.Tensor        # (B * L,) int32, each sorted term's b * L + j
    weights: Optional[torch.Tensor]  # (B, L) float32, or None (all 1)
    den: Optional[torch.Tensor]      # (B,) float32 "mean" divisors, or None
    width: int               # L


def _check_terms(bag_ids: torch.Tensor, n_rows: int) -> None:
    if bag_ids.numel() >= 2 ** 31 or not 1 <= n_rows < 2 ** 31:
        raise ValueError(f"{bag_ids.numel()} (bag, slot) terms into "
                         f"{n_rows} rows: kernel 8b's keys and offsets are "
                         f"int32 (n_rows >= 1)")


def backward_keys_plain(bag_ids: torch.Tensor,
                        bag_weights: Optional[torch.Tensor], mode: str,
                        n_rows: int):
    """The key kernel's plain twin: (keys, den), each term's row in flat
    order, clamped to n_rows - 1 as the forward reads it, n_rows for a
    pad, as int32; the "mean" divisors (``ref.bag_denominators``), or
    None."""
    flat = bag_ids.reshape(-1)
    keys = torch.where(flat < 0, n_rows, flat.clamp(max=n_rows - 1))
    den = (ref.bag_denominators(bag_ids, bag_weights) if mode == "mean"
           else None)
    return keys.to(torch.int32), den


def sort_keys_plain(keys: torch.Tensor):
    """The sort's plain twin: (the keys stable-sorted, the permutation as
    int32), by ``torch.sort``."""
    keys, pos = torch.sort(keys, stable=True)
    return keys, pos.to(torch.int32)


def n_tiles(n_terms: int, n_rows: int, items: int) -> int:
    """The tiles of C = ``items`` places that the n_rows + 1 row marks and
    at most ``n_terms`` terms fill."""
    return -(-(n_rows + 1 + n_terms) // items)


def tile_bounds_plain(keys: torch.Tensor, n_rows: int,
                      items: int) -> torch.Tensor:
    """The tile kernel's plain twin: (n_tiles + 1, 2) int32, each tile's
    first row and first term over the sorted keys.  The row marks (row
    n_rows the end) and the live terms in one sequence, a row's mark
    before its terms, mark r at s(r) = r + the terms with a key below r;
    tile b owns the rows whose marks lie in [b * items, (b + 1) * items)
    and their terms.  By ``torch.searchsorted``."""
    rows = torch.arange(n_rows + 1, device=keys.device, dtype=keys.dtype)
    marks = rows + torch.searchsorted(keys, rows, out_int32=True)
    cuts = torch.arange(n_tiles(keys.numel(), n_rows, items) + 1,
                        device=keys.device) * items
    first = torch.searchsorted(marks, cuts.to(marks.dtype),
                               out_int32=True).clamp_(max=n_rows)
    return torch.stack([first, torch.searchsorted(keys, first,
                                                  out_int32=True)], 1)


def tile_bounds(keys: torch.Tensor, n_rows: int,
                items: int) -> torch.Tensor:
    """The tile kernel on sorted CUDA keys: ``tile_bounds_plain``'s
    bounds, by one pass over the keys.  CPU tensors take the plain
    twin."""
    if keys.is_cpu:
        return tile_bounds_plain(keys, n_rows, items)
    if not 1 <= items <= MAX_ITEMS \
            or keys.numel() + n_rows + 2 * items >= 2 ** 31:
        raise ValueError(f"items must be 1..{MAX_ITEMS} and the places "
                         f"int32, got {items} items, {keys.numel()} terms, "
                         f"{n_rows} rows")
    KERNEL_BWD_TILES.ready(keys)
    bounds = torch.empty(n_tiles(keys.numel(), n_rows, items) + 1, 2,
                         dtype=torch.int32, device=keys.device)
    KERNEL_BWD_TILES.launch_on(keys.device, _TILE_ARGS.pack(
        keys.data_ptr(), bounds.data_ptr(), keys.numel(), n_rows, items,
        stream_handle(keys.device)))
    return bounds


def backward_keys(bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor], mode: str,
                  n_rows: int):
    """The key kernel: (keys, den) as ``backward_keys_plain`` gives them,
    on the ids' device, its sizes from the shapes.  CPU tensors take the
    plain twin."""
    _check_terms(bag_ids, n_rows)
    if bag_ids.is_cpu and (bag_weights is None or bag_weights.is_cpu):
        return backward_keys_plain(bag_ids, bag_weights, mode, n_rows)
    if bag_weights is None:
        KERNEL_BWD_KEYS.ready(bag_ids)
    else:
        KERNEL_BWD_KEYS.ready(bag_ids, bag_weights)
    n_bags, width = bag_ids.shape
    keys = torch.empty(bag_ids.numel(), dtype=torch.int32,
                       device=bag_ids.device)
    den = (torch.empty(n_bags, dtype=torch.float32, device=bag_ids.device)
           if mode == "mean" else None)
    KERNEL_BWD_KEYS.launch_on(bag_ids.device, _KEY_ARGS.pack(
        bag_ids.data_ptr(),
        0 if bag_weights is None else bag_weights.data_ptr(),
        keys.data_ptr(), 0 if den is None else den.data_ptr(),
        keys.numel(), n_bags, width, n_rows,
        stream_handle(bag_ids.device)))
    return keys, den


def sort_keys(keys: torch.Tensor, n_rows: int):
    """The sort on CUDA keys in [0, n_rows]: ``sort_keys_plain``'s
    result by a stable LSD radix sort, 8 bits a pass over the bits of
    n_rows (three passes below 2^24 rows), the permutation built from the
    identity.  The keys are left as they were.  CPU tensors take the
    plain twin."""
    if keys.is_cpu:
        return sort_keys_plain(keys)
    KERNEL_BWD_SORT.ready(keys)
    n, bits = keys.numel(), n_rows.bit_length()
    work = torch.empty(5 * n + RADIX_BINS * (-(-n // SORT_TILE) + 1),
                       dtype=torch.int32, device=keys.device)
    keys_a, keys_b, pos_a, pos_b, hist = (work[:n], work[n:2 * n],
                                          work[2 * n:3 * n],
                                          work[3 * n:4 * n], work[4 * n:])
    KERNEL_BWD_SORT.launch_on(keys.device, _SORT_ARGS.pack(
        keys.data_ptr(), keys_a.data_ptr(), keys_b.data_ptr(),
        pos_a.data_ptr(), pos_b.data_ptr(), hist.data_ptr(),
        hist[-RADIX_BINS:].data_ptr(), n, bits,
        stream_handle(keys.device)))
    return (keys_a, pos_a) if -(-bits // 8) % 2 else (keys_b, pos_b)


def prepare_backward(bag_ids: torch.Tensor,
                     bag_weights: Optional[torch.Tensor], mode: str,
                     n_rows: int) -> BackwardPrep:
    """Kernel 8b's prep on the ids' device: the key kernel, then the
    keys' stable sort (``sort_keys``; its permutation gives each term's
    flat position).  Nothing is read back to the host.  CPU tensors take
    the plain twin."""
    keys, den = backward_keys(bag_ids, bag_weights, mode, n_rows)
    keys, pos = sort_keys(keys, n_rows)
    return BackwardPrep(keys, pos, bag_weights, den, bag_ids.shape[1])


def launch_backward(grad_out: torch.Tensor, prep: BackwardPrep,
                    n_rows: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tile kernel and the gradient kernel on checked CUDA tensors:
    the (n_rows, D) table gradient, every row written once (into ``out``
    where given, else a ``torch.empty``)."""
    dim = grad_out.shape[1]
    if out is None:
        out = torch.empty(n_rows, dim, dtype=grad_out.dtype,
                          device=grad_out.device)
    elif out.shape != (n_rows, dim) or out.dtype != grad_out.dtype \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({n_rows}, {dim}) "
                         f"{grad_out.dtype} tensor, got {out.dtype} "
                         f"{tuple(out.shape)}")
    aligned = (grad_out.data_ptr() % VECTOR_BYTES == 0
               and out.data_ptr() % VECTOR_BYTES == 0)
    vec, lanes = layout(dim, grad_out.element_size(), aligned)
    bounds = tile_bounds(prep.keys, n_rows, tile_items(vec, lanes))
    KERNEL_BWD.launch_on(grad_out.device, _BWD_ARGS.pack(
        grad_out.data_ptr(), prep.keys.data_ptr(), prep.pos.data_ptr(),
        bounds.data_ptr(),
        0 if prep.weights is None else prep.weights.data_ptr(),
        0 if prep.den is None else prep.den.data_ptr(), out.data_ptr(),
        prep.width, n_rows, dim, grad_out.dtype == torch.bfloat16, vec,
        lanes, bounds.shape[0] - 1, -(-(dim // vec) // lanes),
        stream_handle(grad_out.device)))
    return out


def embedding_bag_backward(grad_out: torch.Tensor, bag_ids: torch.Tensor,
                           n_rows: int,
                           bag_weights: Optional[torch.Tensor] = None,
                           mode: str = "sum") -> torch.Tensor:
    """The dense (n_rows, D) gradient of ``embedding_bag``'s table, in
    grad_out's dtype (the table's), given grad_out (B, D).  CPU tensors
    take the plain version; CUDA tensors launch kernel 8b (its key
    kernel, the keys' sort and its gradient kernel), with no host read."""
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
    with count_kernel("embedding_bag_bwd", lambda: backward_cost(
            bag_ids.shape[0], bag_ids.numel(), n_rows, grad_out.shape[1],
            grad_out.element_size(), bag_weights is not None),
            grad_out.dtype):
        if all(t.is_cpu for t in tensors):
            return ref.embedding_bag_backward(grad_out, bag_ids, n_rows,
                                              bag_weights, mode)
        KERNEL_BWD.ready(*tensors)
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
