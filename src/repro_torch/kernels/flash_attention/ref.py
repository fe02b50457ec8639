"""The plain PyTorch version of the blocked online-softmax attention
(kernel 9): plain softmax attention with the causal and window masks and
a query offset, the twin of the JAX package's
``kernels/flash_attention/ref.py::attention``.

A query row with no key inside its mask gets zeros, as that ``ref.py``
gives.  ``attention_gqa`` is the same function over the model's layout:
(B, S, H, dh) tensors, query head h reading kv head ``h // (Hq // Hkv)``.
``tolerance`` is how far the kernel may sit from it.

``attention_gqa_backward`` is the plain version of its gradient (kernel
9b, ``csrc/flash_attention_bwd.cu``): over the materialised float32
scores, with P = softmax(S) and the forward's output O,
dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)), dQ = scale dS K,
dK = scale dS^T Q, the query heads of a kv head summed.  A row that no
key reaches has P = 0, so it gets and gives zero gradient.
``backward_bound`` is how far kernel 9b may sit from it.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


# How far kernel 9 may sit from this plain version, (rtol, atol, vtol):
# |got - want| <= rtol |want| + atol + vtol A, with A this function over
# |v|.  float32: the order of the sums (the JAX kernel test's 2e-5).
# bfloat16: each side rounds its output to bf16 (2**-8 |want| each), and
# the tensor cores take P rounded to bf16 before P V while l sums the
# unrounded P, so out = sum bf16(p_j) v_j / l is off by at most
# sum |bf16(p_j) - p_j| |v_j| / l <= 2**-8 A; a quarter more covers
# ex2.approx and the order of the float32 sums over up to 32,768 keys.
TOL = {torch.float32: (2e-5, 2e-5, 0.0),
       torch.bfloat16: (2.0 ** -7, 2e-5, 1.25 * 2.0 ** -8)}


def tolerance(q, k, v, *, causal: bool = True,
              window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """The float32 bound on |got - attention_gqa(q, k, v, ...)|, element
    by element, for q's dtype (TOL)."""
    rtol, atol, vtol = TOL[q.dtype]
    want = attention_gqa(q, k, v, causal=causal, window=window,
                         q_offset=q_offset).float()
    bound = rtol * want.abs() + atol
    if vtol:
        bound += vtol * attention_gqa(q, k, v.abs(), causal=causal,
                                      window=window,
                                      q_offset=q_offset).float()
    return bound


def _scores(q, k, causal, window, q_offset):
    """(B, Hq, Sq, Sk) float32 scaled scores, -inf outside the masks;
    and the float32 (B, Hq, S, dh) views of q and the repeated k."""
    b, sq, hq, dh = q.shape
    sk, rep = k.shape[1], hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (dh ** -0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return torch.where(mask, s, float("-inf")), qf, kf


def attention_gqa_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           do: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None, q_offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """q, o, do: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh); o is the
    forward's output.  -> (dq, dk, dv) in q's dtype, float32 inside."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    s, qf, kf = _scores(q, k, causal, window, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * (dh ** -0.5)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * (dh ** -0.5)

    def kv(x):          # the rep query heads of a kv head summed
        return x.reshape(b, hkv, rep, sk, dh).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(q.dtype), kv(dk).to(k.dtype),
            kv(dv).to(v.dtype))


# How far kernel 9b may sit from attention_gqa_backward, (rtol, atol):
# |got - want| <= rtol |want| + atol max|want|, for each of dq, dk, dv.
# Both compute in float32 from the same inputs (o and do included) and
# differ in the order of their sums over up to Sk keys or Sq queries and
# in exp2 of base-2 scores against exp: about 1e-6 of the largest term,
# and dS = P (dP - delta) cancels, so the bound is taken against each
# gradient's largest element.  bfloat16 adds one rounding of each side:
# one bf16 ulp, 2**-7 |want|.  A wrong mask, head or scale moves a
# gradient by its own size.
TOL_BWD = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}


def backward_bound(want: torch.Tensor) -> torch.Tensor:
    """The float32 bound on |got - want| for one of kernel 9b's outputs,
    element by element (TOL_BWD of want's dtype)."""
    rtol, atol = TOL_BWD[want.dtype]
    w = want.float()
    return rtol * w.abs() + atol * w.abs().max()
