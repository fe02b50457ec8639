"""Shared model blocks of the port: the sharding context, RMSNorm, RoPE,
and the chunked online-softmax attention in plain torch, each the twin
of the JAX package's ``models/common.py`` name.

``ShardCtx`` threads a simulated mesh (``launch/mesh.py::SimMesh``)
through the model code, as the JAX package's threads a device mesh: its
``dp``, ``tp`` and ``tp_size`` name the mesh's data axes and its "model"
axis.  The simulated mesh keeps every shard on one device, so ``cons``
(a sharding constraint there) is the identity here."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh context threaded through model code; ``mesh=None`` is one
    device with no mesh."""
    mesh: Optional[object] = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return () if self.mesh is None else tuple(self.mesh.shape)

    @property
    def dp(self) -> Tuple[str, ...]:
        return tuple(n for n in self.axis_names if n in ("pod", "data"))

    @property
    def tp(self) -> Optional[str]:
        return "model" if "model" in self.axis_names else None

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self.mesh.shape["model"]

    @property
    def dp_size(self) -> int:
        """The product of the data axes' sizes (1 with none)."""
        n = 1
        for a in self.dp:
            n *= self.mesh.shape[a]
        return n

    def cons(self, x: torch.Tensor, *spec) -> torch.Tensor:
        return x


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., :, None] * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]      # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int, causal: bool = True,
                      window: Optional[int] = None, kv_chunk: int = 1024,
                      kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks: the plain twin of the
    serving path's attention (kernel 9 computes the same function).

    q: (B, Sq, Hq, dh);  k, v: (B, Sk, Hkv, dh);  GQA via head repeat.
    q_offset: absolute position of q[0].  kv_valid_len: mask k at and
    beyond this length.  One deliberate difference from the JAX twin: a
    chunk in which a row has no live key while its running max is still
    -inf adds nothing (the JAX function's exp(-inf - -inf) makes the row
    NaN; this happens only under a window with several chunks).
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5
    kv_chunk = min(kv_chunk, sk)
    n_chunks = (sk + kv_chunk - 1) // kv_chunk
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    valid_k = sk if kv_valid_len is None else kv_valid_len
    m = torch.full((b, hq, sq), float("-inf"), device=dev)
    l = torch.zeros(b, hq, sq, device=dev)
    acc = torch.zeros(b, hq, sq, dh, device=dev)
    q32 = q.float()
    for c in range(n_chunks):
        lo, hi = c * kv_chunk, min((c + 1) * kv_chunk, sk)
        k_pos = torch.arange(lo, lo + kv_chunk, device=dev)
        kb = k[:, lo:hi].repeat_interleave(rep, dim=2).float()
        vb = v[:, lo:hi].repeat_interleave(rep, dim=2).float()
        if hi - lo < kv_chunk:        # the JAX twin's zero padding
            pad = (0, 0, 0, 0, 0, kv_chunk - (hi - lo))
            kb = torch.nn.functional.pad(kb, pad)
            vb = torch.nn.functional.pad(vb, pad)
        s = torch.einsum("bqhd,bchd->bhqc", q32, kb) * scale
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones(sq, kv_chunk, dtype=torch.bool, device=dev)
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        mask = mask & (k_pos < valid_k)[None, :]
        s = torch.where(mask[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, vb)
        m = m_new
    out = acc / l[..., None].clamp(min=1e-30)
    return out.transpose(1, 2).to(q.dtype)       # (B, Sq, Hq, dh)
