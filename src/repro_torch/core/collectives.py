"""Collectives of the simulated mesh as tensor ops.

Every per-processor array has shape ``(pr, pc, ...)``: element ``[i, j]``
is what processor (i, j) holds.  Flat processor ids are k = i*pc + j, the
order the JAX package's ``ppermute`` pairs use over the (row, col) axes.
Each function returns what every processor holds after the collective,
with the same two leading dims.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def perm_index(perm: Sequence[Tuple[int, int]], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) flat-id tensors of a list of permute pairs, made once
    per plan so a permute costs no host-to-device copy."""
    src = torch.tensor([s for s, _ in perm], dtype=torch.int64, device=device)
    dst = torch.tensor([d for _, d in perm], dtype=torch.int64, device=device)
    return src, dst


def ppermute(x: torch.Tensor, perm: Tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    """Whole-mesh permute: processor ``src[k]`` sends its block to
    ``dst[k]`` (``perm`` from ``perm_index``); processors that receive
    nothing hold zeros."""
    pr, pc = x.shape[:2]
    src, dst = perm
    flat = x.reshape(pr * pc, *x.shape[2:])
    out = torch.zeros_like(flat)
    out[dst] = flat[src]
    return out.reshape(x.shape)


def ppermute_col_ring(x: torch.Tensor) -> torch.Tensor:
    """The ring permute along the processor row, pairs (q, q+1 mod pc):
    processor (i, j) receives from (i, j-1)."""
    return torch.roll(x, shifts=1, dims=1)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_gather along the row axis: processor (i, j) receives the
    concatenation over i' of x[i', j].  The result is the same for every
    i, so it is returned as a broadcast view."""
    pr, pc = x.shape[:2]
    g = x.transpose(0, 1).reshape(pc, pr * x.shape[2], *x.shape[3:])
    return g.unsqueeze(0).expand(pr, *g.shape)


def all_to_all_cols(x: torch.Tensor) -> torch.Tensor:
    """all_to_all along the col axis (split and concat axis 2): x is
    ``(pr, pc, pc, ...)`` and processor (i, j) sends x[i, j, q] to (i, q),
    which stores it at position j."""
    return x.transpose(1, 2).contiguous()


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the whole mesh of per-processor values stacked on the
    leading dim(s); every processor holds the same result."""
    return x.sum()
