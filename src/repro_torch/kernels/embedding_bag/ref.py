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
