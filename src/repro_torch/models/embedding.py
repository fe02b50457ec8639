"""EmbeddingBag over the concatenated field tables, on one card: the
recsys hot path, through kernel 8 (``kernels/embedding_bag``).

All field tables are one (total_rows, dim) matrix with per-field row
offsets, as in the JAX package's ``models/embedding.py``.  A one-hot
field lookup is an EmbeddingBag whose bags hold one id with weight 1
(``0 + row * 1.0`` is the row exactly), the way FBGEMM's table-batched
kernels serve pooling factor 1.  Where the table requires a gradient
(and grad mode is on), both functions go through
``eb_ops.embedding_bag_trainable``, whose backward is kernel 8b: the
dense (total_rows, D) gradient ``jax.grad`` gives the JAX package.  The
row-sharded lookup over a "model" axis is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.embedding_bag import ops as eb_ops


def table_meta(cfg: RecsysConfig) -> Tuple[np.ndarray, int]:
    """Per-field row offsets (n_sparse + 1,) int64 and the table's row
    count, rounded up to a multiple of 512."""
    offsets = np.concatenate([[0], np.cumsum(cfg.vocab_sizes)])
    total = int(offsets[-1])
    total = ((total + 511) // 512) * 512
    return offsets.astype(np.int64), total


def init_table(cfg: RecsysConfig, generator: torch.Generator,
               device) -> torch.Tensor:
    """(total_rows, embed_dim) float32, N(0, 1/embed_dim), made on
    ``device`` from ``generator`` (which must live on that device)."""
    _, total = table_meta(cfg)
    return torch.randn(total, cfg.embed_dim, generator=generator,
                       device=device) * (cfg.embed_dim ** -0.5)


def flat_indices(cfg: RecsysConfig, idx: torch.Tensor) -> torch.Tensor:
    """(B, F) per-field indices -> flat row ids into the concat table."""
    offsets, _ = table_meta(cfg)
    return idx + torch.as_tensor(offsets[:-1], dtype=idx.dtype,
                                 device=idx.device)[None, :]


def _bag_fn(table: torch.Tensor):
    """Kernel 8 with its gradient where the table trains, else alone."""
    if table.requires_grad and torch.is_grad_enabled():
        return eb_ops.embedding_bag_trainable
    return eb_ops.embedding_bag


def lookup(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """rows: (...,) int32 flat row ids -> (..., D) rows of the table,
    through kernel 8 as bags of one."""
    flat = rows.reshape(-1, 1).to(torch.int32).contiguous()
    out = _bag_fn(table)(table, flat)
    return out.reshape(*rows.shape, table.shape[1])


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """bag_ids: (B, L) multi-hot rows (-1 = pad) -> (B, D) reduced, the
    JAX package's ``embedding_bag(..., use_kernel=True)``."""
    return _bag_fn(table)(table, bag_ids, bag_weights, mode)
