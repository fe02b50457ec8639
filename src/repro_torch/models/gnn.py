"""GNN family: GIN, GAT, MeshGraphNet, segment-op message passing, the
JAX package's ``models/gnn.py`` on one device.

Message passing is a gather of sender rows and a segment sum (or max)
into the receivers over an edge-index list, as the JAX package builds it
on ``jax.ops.segment_sum``/``segment_max``: ``index_add`` and
``scatter_reduce`` here, plain PyTorch, as the JAX package leaves them to
XLA outside any Pallas kernel.  On a card these accumulate with atomics;
a training step that must repeat bit for bit runs under
``deterministic()`` (see ``launch/cells.py``).

Graph batches are static-shape: padded edges carry mask=0 (their
contributions are multiplied away).  Parameters are flat dicts of
float32 tensors with the JAX package's names (``eps{l}`` is 0-d);
``params_from_jax`` carries the JAX package's dicts across.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig

Params = Dict[str, torch.Tensor]


def gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``x``.  On a card ``x[ids]``, whose gradient is an
    accumulating ``index_put_`` (sorted, in place, under
    ``deterministic()``); on the CPU ``index_select``, whose gradient is
    an ``index_add`` (``x[ids]``'s is two orders of magnitude slower
    there, and on a card the deterministic ``index_add`` copies its
    source first: 15.8 GB a layer at ogb_products).  Any device but the
    CPU (``meta`` too, so that a counted trace follows the card) takes
    the card's form."""
    return x.index_select(0, ids) if x.is_cpu else _gather_card(x, ids)


def _gather_card(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return x[ids]


def _seg_sum_card(x: torch.Tensor, ids: torch.Tensor, n: int
                  ) -> torch.Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_put((ids,), x, accumulate=True)


def seg_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n`` segments by ``ids``: an
    accumulating ``index_put`` on a card, ``index_add`` on the CPU (the
    same sum; see ``gather``)."""
    if not x.is_cpu:
        return _seg_sum_card(x, ids, n)
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, ids, x)


def seg_max(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Row-wise max of ``x`` into ``n`` segments by ``ids``; a segment
    with no rows is -inf, as ``jax.ops.segment_max`` leaves it."""
    out = torch.full((n, *x.shape[1:]), float("-inf"), dtype=x.dtype,
                     device=x.device)
    idx = ids.long().view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)


class _Init:
    """Seeded normal draws on the CPU, moved to ``device``, so a seed gives
    the same parameters on any device."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)

    def normal(self, shape, scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen) * scale).to(
            self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)


def _mlp_init(init: _Init, dims, name: str) -> Params:
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"{name}_w{i}"] = init.normal((a, b), a ** -0.5)
        p[f"{name}_b{i}"] = init.zeros((b,))
    return p


def _mlp_apply(p: Params, name: str, x: torch.Tensor, n_layers: int,
               act: Callable = torch.relu, final_act: bool = False,
               layernorm: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"{name}_w{i}"] + p[f"{name}_b{i}"]
        if i < n_layers - 1 or final_act:
            x = act(x)
    if layernorm:
        # the population variance as ``jnp.var`` forms it: the mean of
        # the centred squares (``torch.var``'s float32 gradient drifts
        # 1e-3 from it on MeshGraphNet's 15 norms)
        mu = x.mean(-1, keepdim=True)
        c = x - mu
        x = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-6)
    return x


# ---------------------------------------------------------------------------
# GIN  (Xu et al. 2019): h' = MLP((1+eps)h + sum_j h_j)
# ---------------------------------------------------------------------------


def init_gin(cfg: GNNConfig, d_in: int, n_out: int, seed: int = 0,
             device="cpu") -> Params:
    init = _Init(seed, device)
    p: Params = {}
    d = d_in
    for l in range(cfg.n_layers):
        p.update(_mlp_init(init, (d, cfg.d_hidden, cfg.d_hidden), f"l{l}"))
        p[f"eps{l}"] = init.zeros(())
        d = cfg.d_hidden
    p.update(_mlp_init(init, (cfg.d_hidden, n_out), "head"))
    return p


def gin_forward(p: Params, cfg: GNNConfig, x, senders, receivers, edge_mask,
                n: int) -> torch.Tensor:
    for l in range(cfg.n_layers):
        # masked in place: the gather's gradient needs only the ids
        msg = gather(x, senders).mul_(edge_mask[:, None])
        agg = seg_sum(msg, receivers, n)
        x = _mlp_apply(p, f"l{l}", (1.0 + p[f"eps{l}"]) * x + agg, 2,
                       final_act=True)
    return x


# ---------------------------------------------------------------------------
# GAT  (Velickovic et al. 2018)
# ---------------------------------------------------------------------------


def init_gat(cfg: GNNConfig, d_in: int, n_out: int, seed: int = 0,
             device="cpu") -> Params:
    """As the JAX package's ``init_gat``, which draws ``a_src{l}`` and
    ``a_dst{l}`` from one key: the two are equal at init."""
    init = _Init(seed, device)
    H, dh = cfg.n_heads, cfg.d_hidden
    p: Params = {}
    d = d_in
    for l in range(cfg.n_layers):
        dout = n_out if l == cfg.n_layers - 1 else dh
        p[f"W{l}"] = init.normal((d, H, dout), d ** -0.5)
        p[f"a_src{l}"] = init.normal((H, dout), 0.1)
        p[f"a_dst{l}"] = p[f"a_src{l}"].clone()
        d = H * dh
    return p


def gat_forward(p: Params, cfg: GNNConfig, x, senders, receivers, edge_mask,
                n: int) -> torch.Tensor:
    m = edge_mask[:, None]
    for l in range(cfg.n_layers):
        last = l == cfg.n_layers - 1
        W = p[f"W{l}"]
        z = (x @ W.reshape(W.shape[0], -1)).reshape(n, *W.shape[1:])
        es = torch.sum(z * p[f"a_src{l}"], -1)            # (N, H)
        ed = torch.sum(z * p[f"a_dst{l}"], -1)
        logit = F.leaky_relu(gather(es, senders) + gather(ed, receivers),
                             0.2)
        logit = torch.where(m > 0, logit, torch.full_like(logit, -1e30))
        # a receiver with no edges keeps -inf here and is never gathered
        mx = seg_max(logit, receivers, n)
        expv = torch.exp(logit - gather(mx, receivers)) * m
        den = seg_sum(expv, receivers, n)
        alpha = expv / torch.clamp(gather(den, receivers), min=1e-16)
        out = seg_sum(alpha[..., None] * gather(z, senders), receivers,
                      n)                                   # (N, H, k)
        x = out.mean(1) if last else F.elu(out.reshape(n, -1))
    return x


# ---------------------------------------------------------------------------
# MeshGraphNet  (Pfaff et al. 2021): encode-process(x15)-decode
# ---------------------------------------------------------------------------


def init_mgn(cfg: GNNConfig, d_in: int, d_edge_in: int, n_out: int,
             seed: int = 0, device="cpu") -> Params:
    init = _Init(seed, device)
    dh, L = cfg.d_hidden, cfg.n_layers
    p: Params = {}
    p.update(_mlp_init(init, (d_in, dh, dh), "enc_n"))
    p.update(_mlp_init(init, (d_edge_in, dh, dh), "enc_e"))
    for l in range(L):
        p.update(_mlp_init(init, (3 * dh, dh, dh), f"pe{l}"))
        p.update(_mlp_init(init, (2 * dh, dh, dh), f"pn{l}"))
    p.update(_mlp_init(init, (dh, dh, n_out), "dec"))
    return p


def mgn_forward(p: Params, cfg: GNNConfig, x, e_feat, senders, receivers,
                edge_mask, n: int) -> torch.Tensor:
    h = _mlp_apply(p, "enc_n", x, 2, layernorm=True)
    e = _mlp_apply(p, "enc_e", e_feat, 2, layernorm=True)
    for l in range(cfg.n_layers):
        eu = _mlp_apply(p, f"pe{l}", torch.cat(
            [e, gather(h, senders), gather(h, receivers)], -1), 2,
            layernorm=True)
        e = e + eu
        agg = seg_sum(e * edge_mask[:, None], receivers, n)
        hu = _mlp_apply(p, f"pn{l}", torch.cat([h, agg], -1), 2,
                        layernorm=True)
        h = h + hu
    return _mlp_apply(p, "dec", h, 2)


# ---------------------------------------------------------------------------
# Task heads (selected per shape kind by the launcher)
# ---------------------------------------------------------------------------


def node_xent(logits, labels, mask) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


def graph_readout_xent(node_logits, graph_ids, labels, n_graphs: int
                       ) -> torch.Tensor:
    pooled = seg_sum(node_logits, graph_ids, n_graphs)
    logp = torch.log_softmax(pooled.float(), -1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def build_gnn_apply(cfg: GNNConfig, d_in: int, n_out: int,
                    d_edge_in: int = 4) -> Tuple[Callable, Callable]:
    """(init_fn(seed=0, device="cpu") -> params, apply_fn(params, batch) ->
    node outputs)."""
    if cfg.model == "gin":
        return (lambda seed=0, device="cpu": init_gin(cfg, d_in, n_out, seed,
                                                      device),
                lambda p, b: _head_gin(p, cfg, b))
    if cfg.model == "gat":
        return (lambda seed=0, device="cpu": init_gat(cfg, d_in, n_out, seed,
                                                      device),
                lambda p, b: gat_forward(p, cfg, b["x"], b["senders"],
                                         b["receivers"], b["edge_mask"],
                                         b["x"].shape[0]))
    if cfg.model == "meshgraphnet":
        return (lambda seed=0, device="cpu": init_mgn(
                    cfg, d_in, d_edge_in, n_out, seed, device),
                lambda p, b: mgn_forward(p, cfg, b["x"], b["e_feat"],
                                         b["senders"], b["receivers"],
                                         b["edge_mask"], b["x"].shape[0]))
    raise ValueError(cfg.model)


def _head_gin(p: Params, cfg: GNNConfig, b) -> torch.Tensor:
    h = gin_forward(p, cfg, b["x"], b["senders"], b["receivers"],
                    b["edge_mask"], b["x"].shape[0])
    return _mlp_apply(p, "head", h, 1)


_LAYER_KEYS = {"gin": ("eps{}", "l{}_w0"), "gat": ("W{}", "a_src{}"),
               "meshgraphnet": ("pe{}_w0", "pn{}_w0")}


def params_from_jax(cfg: GNNConfig, params_np: Mapping[str, np.ndarray],
                    device="cpu") -> Params:
    """The JAX package's flat parameter dict of ``cfg``'s model (numpy
    arrays, 0-d leaves included) as float32 tensors on ``device``."""
    missing = [f.format(l) for l in range(cfg.n_layers)
               for f in _LAYER_KEYS[cfg.model] if f.format(l) not in params_np]
    if missing:
        raise KeyError(f"{cfg.arch}: the parameters lack {missing}")
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params_np.items()}
