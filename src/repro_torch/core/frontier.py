"""Frontier bitmaps and the paper's vector-redistribution steps over the
simulated mesh.

Bitmaps are packed 32 vertices to a word.  Torch has few ops on uint32,
so a packed word is an int32 holding the same 32 bits (``.view`` it as
uint32 to compare with the JAX package's words); ``(w >> k) & 1`` reads
bit k of either.  Wire counters report paper units: 1 vertex id = 1 word,
1 bitmap bit = 1/64 word.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import collectives

INT_INF = 2**31 - 1

_F32 = np.float32


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., X) bool -> (..., X//32) int32 words; X must be a multiple of 32."""
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    b = mask.reshape(*mask.shape[:-1], -1, 32).to(torch.int64) << shifts
    w = b.sum(dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., W*32) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bool)


def test_bits(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Membership of ``idx`` in the packed bitmap ``words`` (a gather)."""
    idx = idx.to(torch.int64)
    return ((words[idx >> 5] >> (idx & 31)) & 1).to(torch.bool)


def pack_ids(mask: torch.Tensor, cap: int, offset, sentinel: int
             ) -> torch.Tensor:
    """Sparse frontier compaction, batched over leading dims: ``(...,
    chunk)`` bool -> ``(..., cap)`` int32 holding ``offset + position``
    of the first ``cap`` set bits in ascending order and ``sentinel`` in
    the unused slots; set bits past ``cap`` are dropped (callers detect
    that overflow themselves).  ``offset`` is an int or a tensor that
    broadcasts against ``(..., 1)``.  One pass over all rows: a running
    count ranks each set bit, and one scatter drops it into its slot.
    The count runs over the flattened mask (a 1-D scan runs device-wide;
    a per-row scan of few long rows leaves the card mostly idle), minus
    each row's count before it."""
    chunk = mask.shape[-1]
    m = mask.reshape(-1, chunk)
    cum = torch.cumsum(m.reshape(-1), 0, dtype=torch.int32).reshape(m.shape)
    rank = cum - (cum[:, :1] - m[:, :1].to(torch.int32)) - 1
    slot = torch.where(m & (rank < cap), rank, cap).to(torch.int64)
    pos = torch.arange(chunk, dtype=torch.int32, device=mask.device)
    local = torch.full((m.shape[0], cap + 1), chunk, dtype=torch.int32,
                       device=mask.device)
    # every unset or dropped bit lands in the spare column ``cap``
    local.scatter_(1, slot, pos.expand(m.shape[0], chunk))
    local = local[:, :cap].reshape(*mask.shape[:-1], cap)
    return torch.where(local < chunk, local + offset,
                       sentinel).to(torch.int32)


def unpack_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Global ids -> the packed n-bit bitmap, (n//32,) int32 words; ids
    outside [0, n) (the ``pack_ids`` sentinel) are dropped."""
    ids = ids.reshape(-1).to(torch.int64)
    mask = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    mask[torch.where((ids >= 0) & (ids < n), ids, n)] = True
    return pack_bits(mask[:n])


def transpose_vector(x: torch.Tensor, perm) -> torch.Tensor:
    """The paper's TransposeVector: one permute moving each processor's
    whole chunk from layout A to layout B (or back, with the inverse
    perm); ``perm`` comes from ``collectives.perm_index``."""
    return collectives.ppermute(x, perm)


def expand_bitmap(words: torch.Tensor, perm
                  ) -> Tuple[torch.Tensor, np.float32]:
    """Expand (Alg. 3 l.5-6 / Alg. 4 l.6-7): transpose the ``(pr, pc,
    chunk//32)`` packed frontier words to layout B, then gather them
    along the processor column, giving each processor its C_j slice.

    Returns ``(f_words (pr, pc, nc//32) int32, wire)``: ``wire`` is the
    float32 per-processor word count of the transpose and the gather, in
    paper 64-bit-word units."""
    pr = words.shape[0]
    gathered = collectives.all_gather_rows(transpose_vector(words, perm))
    # 1/2: a 32-bit word is half a paper word; the transpose sends one
    # copy and the gather pr-1 copies of each word
    wire = _F32(words.shape[-1]) * _F32(1.0 / 2.0) * _F32(1 + (pr - 1))
    return gathered, wire
