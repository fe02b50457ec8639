"""AutoInt (Song et al. 2019) on one card: multi-head self-attention
over the sparse-field embeddings with a residual, then an MLP head; plus
the two-tower retrieval scorer and the training loss ``bce_loss``.  The
same einsums and the same head-major reshape as the JAX package's
``models/autoint.py``; the field lookup goes through kernel 8.

Serving and training differ only in the parameters' ``requires_grad``:
``AutoInt(cfg)`` builds them frozen and serves under
``torch.inference_mode`` as before; ``AutoInt(cfg, trainable=True)``
builds them trainable, and ``model.params()`` is the dict of tensors
(the JAX package's names) that ``bce_loss`` and the optimizer take.
With a trainable table the lookup carries its dense gradient (kernel
8b), as ``jax.grad`` of the JAX package's ``jnp.take`` gives it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.launch.mesh import make_generator
from repro_torch.models import embedding


def _param_shapes(cfg: RecsysConfig) -> Dict[str, tuple]:
    """Name -> shape of every dense parameter, in the JAX package's
    names (the table comes apart)."""
    d, da, nh = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    shapes: Dict[str, tuple] = {}
    din = d
    for i in range(cfg.n_attn_layers):
        for w in ("wq", "wk", "wv"):
            shapes[f"{w}{i}"] = (din, nh, da)
        shapes[f"wres{i}"] = (din, nh * da)
        din = nh * da
    dims = (cfg.n_sparse * din, *cfg.mlp_hidden, 1)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"mlp_w{i}"] = (a, b)
        shapes[f"mlp_b{i}"] = (b,)
    return shapes


Params = Dict[str, torch.Tensor]


def interact(p: Params, cfg: RecsysConfig, e: torch.Tensor) -> torch.Tensor:
    """e: (B, F, d) field embeddings -> (B, F, H*da) after the attention
    layers."""
    x = e
    for i in range(cfg.n_attn_layers):
        q = torch.einsum("bfd,dhk->bfhk", x, p[f"wq{i}"])
        k = torch.einsum("bfd,dhk->bfhk", x, p[f"wk{i}"])
        v = torch.einsum("bfd,dhk->bfhk", x, p[f"wv{i}"])
        s = torch.einsum("bfhk,bghk->bhfg", q, k) / np.sqrt(float(cfg.d_attn))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bghk->bfhk", a, v)
        o = o.reshape(*o.shape[:2], -1)
        x = torch.relu(o + x @ p[f"wres{i}"])
    return x


def embed(p: Params, cfg: RecsysConfig, idx: torch.Tensor) -> torch.Tensor:
    """(B, F) per-field ids -> (B, F, d), through kernel 8."""
    return embedding.lookup(p["table"], embedding.flat_indices(cfg, idx))


def logits(p: Params, cfg: RecsysConfig, e: torch.Tensor) -> torch.Tensor:
    """(B, F, d) field embeddings -> (B,) logits."""
    x = interact(p, cfg, e)
    flat = x.reshape(x.shape[0], -1)
    n_mlp = len(cfg.mlp_hidden) + 1
    for i in range(n_mlp):
        flat = flat @ p[f"mlp_w{i}"] + p[f"mlp_b{i}"]
        if i < n_mlp - 1:
            flat = torch.relu(flat)
    return flat[:, 0]


def forward(p: Params, cfg: RecsysConfig, idx: torch.Tensor) -> torch.Tensor:
    """idx: (B, F) sparse-field indices -> (B,) logits."""
    return logits(p, cfg, embed(p, cfg, idx))


def bce_loss(p: Params, cfg: RecsysConfig, idx: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy of the logits against float labels, by
    log-sigmoids as the JAX package takes it."""
    z = forward(p, cfg, idx)
    return -torch.mean(labels * F.logsigmoid(z)
                       + (1 - labels) * F.logsigmoid(-z))


class AutoInt(nn.Module):
    """Parameters under the JAX package's names: ``table`` and, per
    attention layer l, ``wq{l}``/``wk{l}``/``wv{l}`` (din, H, da) and
    ``wres{l}`` (din, H*da); per MLP layer i ``mlp_w{i}``, ``mlp_b{i}``.
    Random init from ``seed`` on ``device`` (N(0, 1/fan_in) weights,
    zero biases); ``trainable`` sets their ``requires_grad``."""

    def __init__(self, cfg: RecsysConfig, seed: int = 0, device="cuda",
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(device, seed)
        self.table = nn.Parameter(embedding.init_table(cfg, gen, device),
                                  requires_grad=trainable)
        self.w = nn.ParameterDict()
        for name, shape in _param_shapes(cfg).items():
            if name.startswith("mlp_b"):
                x = torch.zeros(shape, device=device)
            else:
                x = torch.randn(shape, generator=gen, device=device) \
                    * (shape[0] ** -0.5)
            self.w[name] = nn.Parameter(x, requires_grad=trainable)

    def params(self) -> Params:
        """The parameters as one dict under the JAX package's names."""
        return {"table": self.table, **self.w}

    def interact(self, e: torch.Tensor) -> torch.Tensor:
        return interact(self.params(), self.cfg, e)

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        return embed(self.params(), self.cfg, idx)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), self.cfg, idx)

    def logits(self, e: torch.Tensor) -> torch.Tensor:
        return logits(self.params(), self.cfg, e)

    def user_tower(self, idx: torch.Tensor) -> torch.Tensor:
        """Mean-pooled interacted fields -> (B, H*da) user vector."""
        return self.interact(self.embed(idx)).mean(dim=1)

    @staticmethod
    def retrieval_scores(user_vec: torch.Tensor,
                         cand_table: torch.Tensor) -> torch.Tensor:
        """(B, D) x (Ncand, D) -> (B, Ncand) batched dot."""
        return user_vec @ cand_table.T


def params_from_jax(cfg: RecsysConfig, params_np: Dict[str, np.ndarray],
                    device="cuda", trainable: bool = False) -> AutoInt:
    """An ``AutoInt`` on ``device`` holding the JAX package's parameter
    dict (numpy arrays, its names); every name and shape must match."""
    model = AutoInt(cfg, device=device, trainable=trainable)
    want = {"table", *model.w.keys()}
    if set(params_np) != want:
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(want - set(params_np))}, extra "
                       f"{sorted(set(params_np) - want)}")
    with torch.no_grad():
        for name, arr in params_np.items():
            dst = model.table if name == "table" else model.w[name]
            src = torch.from_numpy(np.array(arr))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} vs "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    return model
