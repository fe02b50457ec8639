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
key reaches has P = 0, so it gets and gives zero gradient.  Given each
row's base-2 log-sum-exp (``attention_lse``, what kernel 9's forward
saves), P = exp2(log2(e) S - lse) instead of the softmax: the same P.
``backward_tolerance`` is how far kernel 9b may sit from it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG2E = math.log2(math.e)


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


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0
                  ) -> torch.Tensor:
    """q: (B, Sq, Hq, dh), k: (B, Sk, Hkv, dh) -> (B, Hq, Sq) float32:
    each query row's base-2 log-sum-exp of its scaled, masked scores,
    log2 sum_k 2^(log2(e) S), +inf for a row that no key reaches (so that
    exp2(log2(e) S - lse) = 0 there): what kernel 9's prefill stores."""
    s, _, _ = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    return torch.where(torch.isfinite(lse), lse, float("inf"))


def _backward_parts(q, k, v, o, do, causal, window, q_offset, lse):
    """P, dS (B, Hq, Sq, Sk) and the float32 (B, Hq, S, dh) views of q,
    the repeated k and do."""
    s, qf, kf = _scores(q, k, causal, window, q_offset)
    if lse is None:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        p = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    else:
        p = torch.exp2(s * LOG2E - lse.float()[..., None])
    rep = q.shape[2] // k.shape[2]
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    return p, ds, qf, kf, dof


def _kv_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, Sk, dh) -> (B, Sk, Hkv, dh): the rep query heads of a kv
    head summed."""
    b, hq, sk, dh = x.shape
    return x.reshape(b, hkv, hq // hkv, sk, dh).sum(2).transpose(1, 2)


def attention_gqa_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           do: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None, q_offset: int = 0,
                           lse: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """q, o, do: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh); o is the
    forward's output, ``lse`` (B, Hq, Sq) its rows' log-sum-exp where
    saved.  -> (dq, dk, dv) in q's dtype, float32 inside."""
    hkv, scale = k.shape[2], q.shape[3] ** -0.5
    p, ds, qf, kf, dof = _backward_parts(q, k, v, o, do, causal, window,
                                         q_offset, lse)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return (dq.transpose(1, 2).to(q.dtype), _kv_sum(dk, hkv).to(k.dtype),
            _kv_sum(dv, hkv).to(v.dtype))


# How far kernel 9b may sit from attention_gqa_backward, (rtol, atol,
# ptol): |got - want| <= rtol |want| + atol max|want| + ptol R, for each
# of dq, dk, dv.
# - Both compute in float32 from the same inputs (o and do included) and
#   differ in the order of their sums over up to Sk keys or Sq queries
#   and in exp2 of base-2 scores against exp: about 1e-6 of the largest
#   term, and dS = P (dP - delta) cancels, so atol is taken against each
#   gradient's largest element.
# - bfloat16 adds one rounding of each side's output: one bf16 ulp,
#   2**-7 |want|.
# - The bf16 path also rounds the register operands of its tensor-core
#   products to bf16: P before dV += P^T dO, dS before dK += dS^T Q and
#   dQ += dS K (each within 2**-8 of itself: the unit roundoff of an
#   8-bit significand), the sums in float32.  The rounding of P moves
#   dV by at most 2**-8 sum_q P |dO|; that of dS moves dK by at most
#   2**-8 scale sum_q |dS| |Q| and dQ by 2**-8 scale sum_k |dS| |K|.
#   R is that sum, computed by this plain version over absolute values
#   (like ``tolerance``'s vtol term; a kv head's rep query heads summed),
#   and ptol = 2**-8.  dS itself is formed from the unrounded float32 P,
#   as here.  The float32 path rounds nothing: ptol 0.
# A wrong mask, head or scale moves a gradient by its own size.
TOL_BWD = {torch.float32: (1e-4, 1e-5, 0.0),
           torch.bfloat16: (2.0 ** -7, 1e-4, 2.0 ** -8)}


def backward_bound(want: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The float32 bound rtol |want| + atol max|want| on |got - want| for
    one of kernel 9b's outputs, element by element (TOL_BWD's row of
    ``dtype``, want's by default); without the rounding term of
    ``backward_tolerance``."""
    rtol, atol, _ = TOL_BWD[dtype or want.dtype]
    w = want.float()
    return rtol * w.abs() + atol * w.abs().max()


def backward_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, *,
                       causal: bool = True, window: Optional[int] = None,
                       q_offset: int = 0, dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 bounds (dq, dk, dv) on |got - attention_gqa_backward(q,
    k, v, o, do, ...)|, element by element: TOL_BWD's row of ``dtype``
    (q's by default), the rounding term R included."""
    dtype = dtype or q.dtype
    want = attention_gqa_backward(q, k, v, o, do, causal=causal,
                                  window=window, q_offset=q_offset)
    bounds = [backward_bound(w, dtype) for w in want]
    ptol = TOL_BWD[dtype][2]
    if ptol:
        hkv, scale = k.shape[2], q.shape[3] ** -0.5
        p, ds, qf, kf, dof = _backward_parts(q, k, v, o, do, causal, window,
                                             q_offset, None)
        ds = ds.abs()
        rq = torch.einsum("bhqk,bhkd->bhqd", ds, kf.abs()) * scale
        rk = torch.einsum("bhqk,bhqd->bhkd", ds, qf.abs()) * scale
        rv = torch.einsum("bhqk,bhqd->bhkd", p, dof.abs())
        for i, r in enumerate((rq.transpose(1, 2), _kv_sum(rk, hkv),
                               _kv_sum(rv, hkv))):
            bounds[i] = bounds[i] + ptol * r
    return tuple(bounds)
