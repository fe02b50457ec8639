"""The plain PyTorch version of the blocked online-softmax attention
(kernel 9): plain softmax attention with the causal and window masks and
a query offset, the twin of the JAX package's
``kernels/flash_attention/ref.py::attention``.

A query row with no key inside its mask gets zeros, as that ``ref.py``
gives.  ``attention_gqa`` is the same function over the model's layout:
(B, S, H, dh) tensors, query head h reading kv head ``h // (Hq // Hkv)``.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, dh), k/v: (BH, Sk, dh) -> (BH, Sq, dh) in q's dtype."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask[None], s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, dh), k/v: (B, Sk, Hkv, dh) -> (B, Sq, Hq, dh)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv

    def heads(x, s):
        return x.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(
            b * hq, s, dh)
    out = attention(q.transpose(1, 2).reshape(b * hq, sq, dh), heads(k, sk),
                    heads(v, sk), causal=causal, window=window,
                    q_offset=q_offset)
    return out.reshape(b, hq, sq, dh).transpose(1, 2)
