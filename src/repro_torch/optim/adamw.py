"""AdamW and SGD with momentum over a dict of tensors, the JAX package's
``optim/adamw.py`` on one card.

The same math in the same order and in float32: the global-norm clip,
the warmup and cosine schedule, the bias corrections ``1 - b1**step``
taken in float32 (as XLA takes them, not in Python doubles), the moments
kept in ``state_dtype``.  ``update`` returns new dicts and leaves its
arguments as they were, as the JAX functions do.  The update is plain
torch: the JAX package leaves it to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

Tree = Dict[str, torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Tree
    nu: Tree


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, the leaves summed in the JAX
    package's order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(tree[k].float() ** 2)
                          for k in sorted(tree)))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"       # "cosine" | "constant"
    total_steps: int = 10_000
    state_dtype: str = "float32"   # "bfloat16" halves optimizer traffic

    def init(self, params: Tree) -> AdamWState:
        dt = _DTYPES[self.state_dtype]
        dev = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=dt) for k, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp((s + 1) / max(self.warmup_steps, 1), max=1.0)
        if self.schedule == "cosine":
            frac = torch.clamp(s / max(self.total_steps, 1), 0.0, 1.0)
            base = 0.5 * (1 + torch.cos(_f32(math.pi, s) * frac))
        else:
            base = 1.0
        return self.lr * warm * base

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        step = state.step + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        sf = step.to(torch.float32)
        c1 = 1 - _f32(b1, sf) ** sf
        c2 = 1 - _f32(b2, sf) ** sf
        new_mu, new_nu, new_p = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float() * scale
            m = (b1 * state.mu[k].float() + (1 - b1) * g).to(
                state.mu[k].dtype)
            v = (b2 * state.nu[k].float() + (1 - b2) * g ** 2).to(
                state.nu[k].dtype)
            d = (m.float() / c1) / (torch.sqrt(v.float() / c2) + self.eps) \
                + self.weight_decay * p.float()
            new_p[k] = (p.float() - lr * d).to(p.dtype)
            new_mu[k], new_nu[k] = m, v
        return new_p, AdamWState(step=step, mu=new_mu, nu=new_nu)


@dataclasses.dataclass(frozen=True)
class SGDM:
    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params: Tree) -> Tree:
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Tree, state: Tree, params: Tree
               ) -> Tuple[Tree, Tree]:
        new_m = {k: self.momentum * state[k] + grads[k].float()
                 for k in state}
        new_p = {k: (p.float() - self.lr * new_m[k]).to(p.dtype)
                 for k, p in params.items()}
        return new_p, new_m
