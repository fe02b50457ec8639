"""The plain PyTorch version of the table-batched EmbeddingBag (kernel 8),
the twin of the JAX package's Pallas kernel
``kernels/embedding_bag/embedding_bag.py::_kernel``.

It follows that kernel, not the JAX package's ``ref.py``, where the two
differ: a bag's rows are summed in float32 in bag order ``j = 0..L-1``,
each row times its weight, one rounded multiply and one rounded add a
step; an id below 0 is padding (weight 0, row 0 read); an id at or past
V reads row V-1, as the Pallas kernel's clamped gather does (the jnp
``ref.py`` returns NaN there).  The CUDA kernel does the same
arithmetic in the same order, so the two agree bit for bit.

``embedding_bag_backward`` is the plain version of its table gradient
(kernel 8b, ``csrc/embedding_bag_bwd.cu``): each live (bag, slot) term
``w * dout[bag]`` (``dout[bag] / den[bag]`` under "mean") added into a
float32 buffer by ``index_add_`` in flat order, then one cast.  On the
CPU ``index_add_`` sums each row's terms in index order, the order the
kernel takes.
"""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D); bag_ids (B, L), -1 = pad; bag_weights (B, L) float32
    or None (all 1) -> (B, D) in the table's dtype."""
    n_bags, width = bag_ids.shape
    n_rows, dim = table.shape
    acc = torch.zeros(n_bags, dim, dtype=torch.float32, device=table.device)
    wsum = torch.zeros(n_bags, dtype=torch.float32, device=table.device)
    for j in range(width):
        ids = bag_ids[:, j]
        valid = ids >= 0
        safe = torch.where(valid, ids, 0).clamp_(max=n_rows - 1)
        rows = table[safe.to(torch.int64)].to(torch.float32)
        w = valid.to(torch.float32)
        if bag_weights is not None:
            w = bag_weights[:, j] * w
        acc = acc + rows * w[:, None]
        wsum = wsum + w
    if mode == "mean":
        acc = acc / wsum.clamp(min=1e-9)[:, None]
    return acc.to(table.dtype)


def bag_denominators(bag_ids: torch.Tensor,
                     bag_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,) float32: each bag's weight sum, taken in slot order as the
    forward takes it, clamped below at 1e-9 (the "mean" divisor)."""
    wsum = torch.zeros(bag_ids.shape[0], dtype=torch.float32,
                       device=bag_ids.device)
    for j in range(bag_ids.shape[1]):
        w = (bag_ids[:, j] >= 0).to(torch.float32)
        if bag_weights is not None:
            w = bag_weights[:, j] * w
        wsum = wsum + w
    return wsum.clamp(min=1e-9)


def embedding_bag_backward(grad_out: torch.Tensor, bag_ids: torch.Tensor,
                           n_rows: int,
                           bag_weights: Optional[torch.Tensor] = None,
                           mode: str = "sum") -> torch.Tensor:
    """grad_out (B, D) -> the (n_rows, D) table gradient in grad_out's
    dtype (the table's): pads add nothing, ids at or past n_rows land on
    row n_rows - 1 (the rows the forward read)."""
    width = bag_ids.shape[1]
    g = grad_out.to(torch.float32)
    if mode == "mean":
        g = g / bag_denominators(bag_ids, bag_weights)[:, None]
    flat = bag_ids.reshape(-1)
    pos = torch.nonzero(flat >= 0).squeeze(1)
    rows = flat[pos].to(torch.int64).clamp_(max=n_rows - 1)
    terms = g[torch.div(pos, width, rounding_mode="floor")]
    if bag_weights is not None:
        terms = bag_weights.reshape(-1)[pos][:, None] * terms
    buf = torch.zeros(n_rows, grad_out.shape[1], dtype=torch.float32,
                      device=grad_out.device)
    buf.index_add_(0, rows, terms)
    return buf.to(grad_out.dtype)
