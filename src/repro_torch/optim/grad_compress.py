"""Gradient compression for the data-parallel all-reduce, the JAX
package's ``optim/grad_compress.py``: error-feedback top-k (the entries
of largest magnitude of grad + residual cross the wire, the rest
accumulates into the residual) and int8 quantization with one scale a
tensor.  Trees are the port's dicts of tensors; residuals are float32,
and int8 rounds half to even (``torch.round``, as ``jnp.round``)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    residual: Tree


def ef_init(params: Tree) -> EFState:
    return EFState({k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()})


def topk_compress(grads: Tree, state: EFState, ratio: float = 0.01
                  ) -> Tuple[Tree, Tree, EFState]:
    """(values, indices, new_state): per leaf the k = max(1, int(n ratio))
    entries of largest magnitude of the flattened grad + residual, and
    that sum with those entries zeroed as the new residual."""
    vals, idxs, res = {}, {}, {}
    for name, g in grads.items():
        gz = g.float() + state.residual[name]
        flat = gz.reshape(-1)
        k = max(1, int(flat.numel() * ratio))
        _, idx = torch.topk(flat.abs(), k)
        vals[name] = flat[idx]
        idxs[name] = idx
        res[name] = flat.index_fill(0, idx, 0.0).reshape(gz.shape)
    return vals, idxs, EFState(res)


def topk_decompress(vals: Tree, idxs: Tree, like: Tree) -> Tree:
    """The dense tensors of ``like``'s shapes and dtypes holding ``vals``
    at ``idxs`` and zeros elsewhere."""
    out = {}
    for name, g in like.items():
        flat = torch.zeros(g.numel(), dtype=torch.float32, device=g.device)
        flat[idxs[name]] = vals[name]
        out[name] = flat.reshape(g.shape).to(g.dtype)
    return out


def int8_quantize(grads: Tree) -> Tuple[Tree, Tree]:
    """(q, scale) per leaf: scale = max(max|g|, 1e-12) / 127 (float32),
    q = clip(round(g / scale), -127, 127) as int8."""
    qs, ss = {}, {}
    for name, g in grads.items():
        g32 = g.float()
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        qs[name] = torch.clamp(torch.round(g32 / scale), -127, 127).to(
            torch.int8)
        ss[name] = scale
    return qs, ss


def int8_dequantize(qs: Tree, ss: Tree, like: Tree) -> Tree:
    return {name: (qs[name].float() * ss[name]).to(g.dtype)
            for name, g in like.items()}
