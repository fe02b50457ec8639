"""EmbeddingBag over the concatenated field tables, on one card: the
recsys hot path, through kernel 8 (``kernels/embedding_bag``).

All field tables are one (total_rows, dim) matrix with per-field row
offsets, as in the JAX package's ``models/embedding.py``.  A one-hot
field lookup is an EmbeddingBag whose bags hold one id with weight 1
(``0 + row * 1.0`` is the row exactly), the way FBGEMM's table-batched
kernels serve pooling factor 1.  Where the table requires a gradient
(and grad mode is on), both functions go through
``eb_ops.embedding_bag_trainable``, whose backward is kernel 8b: the
dense (total_rows, D) gradient ``jax.grad`` gives the JAX package.

On a simulated mesh with a "model" axis of more than one shard
(``ShardCtx``), ``lookup`` is the JAX package's row-sharded lookup: the
table's rows split over "model", each shard gathers the rows it owns
(a masked local gather), and a psum over "model" assembles the result
(``core/collectives.py::psum_axis``, recorded).  That path is plain
torch, as the JAX package's is ``jnp.take`` there; kernel 8 runs where
the JAX package takes its kernel, with no mesh or one model shard.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core import collectives as coll
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models.common import ShardCtx


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


def _sharded(ctx: Optional[ShardCtx]) -> bool:
    return ctx is not None and ctx.mesh is not None and ctx.tp_size > 1


def _lookup_sharded(table: torch.Tensor, rows: torch.Tensor,
                    ctx: ShardCtx) -> torch.Tensor:
    """The row-sharded lookup: model shard r holds rows [r size, (r+1)
    size) of the table; the ids split over the data axes where they
    divide evenly (else every data shard takes them all, the JAX
    package's ``P(None)``).  Each shard's gather is zero where it does
    not own the row, so the psum is the row exactly."""
    tp, (total, d) = ctx.tp_size, table.shape
    if total % tp:
        raise ValueError(f"{total} table rows do not split over {tp} model "
                         f"shards")
    size = total // tp
    flat = rows.reshape(-1).long()
    n_dp = ctx.dp_size
    dp_dims = ([ctx.mesh.shape[a] for a in ctx.dp]
               if n_dp > 1 and flat.numel() % n_dp == 0
               else [1] * len(ctx.dp))
    ids = flat.reshape(*dp_dims, 1, -1)              # (*dp, 1, n)
    first = torch.arange(tp, device=flat.device)[:, None] * size
    loc = ids - first                                # (*dp, tp, n)
    ok = (loc >= 0) & (loc < size)
    shards = table.reshape(tp, size, d)
    vals = shards[torch.arange(tp, device=flat.device)[:, None],
                  loc.clamp(0, size - 1)]            # (*dp, tp, n, D)
    vals = torch.where(ok[..., None], vals, 0.0)
    vals = coll.psum_axis(vals, (*ctx.dp, "model"), "model")
    return vals[..., 0, :, :].reshape(*rows.shape, d)


def lookup(table: torch.Tensor, rows: torch.Tensor,
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """rows: (...,) flat row ids -> (..., D) rows of the table: through
    kernel 8 as bags of one (int32 ids) with no mesh or one model shard,
    else the row-sharded lookup over ``ctx``'s "model" axis."""
    if _sharded(ctx):
        return _lookup_sharded(table, rows, ctx)
    flat = rows.reshape(-1, 1).to(torch.int32).contiguous()
    out = _bag_fn(table)(table, flat)
    return out.reshape(*rows.shape, table.shape[1])


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  bag_weights: Optional[torch.Tensor] = None,
                  mode: str = "sum",
                  ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """bag_ids: (B, L) multi-hot rows (-1 = pad) -> (B, D) reduced: the
    JAX package's ``embedding_bag(..., use_kernel=True)``, kernel 8 with
    no mesh or one model shard; on a mesh, the row-sharded lookup of
    each id (pads read row 0 and weigh 0) and the weighted sum."""
    if not _sharded(ctx):
        return _bag_fn(table)(table, bag_ids, bag_weights, mode)
    valid = bag_ids >= 0
    vals = lookup(table, torch.where(valid, bag_ids, 0), ctx)
    w = valid.to(vals.dtype)
    if bag_weights is not None:
        w = w * bag_weights
    out = torch.sum(vals * w[..., None], dim=-2)
    if mode == "mean":
        out = out / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return out
