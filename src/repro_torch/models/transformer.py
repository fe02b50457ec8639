"""Decoder-only LM, dense and MoE: GQA, RoPE, optional sliding window;
training (``forward``, ``lm_loss``), and prefill and decode over a KV
cache.

Parameters are a dict of tensors under the JAX package's names, with the
layers stacked on a leading (L, ...) dim as there, and the same
functions over them (``models/transformer.py`` of the JAX package).
The attention goes through kernel 9 (``kernel_attention``): with the
cache filled up to ``kv_len = q_offset + S``, the causal test ``k <= q``
masks every key at and past ``kv_len`` already, so the JAX package's
``chunked_attention(..., kv_valid_len=kv_len)`` over the whole cache is
kernel 9 over the cache's first ``kv_len`` keys.  The plain matmuls stay
``torch.matmul``.  The KV cache is updated in place (the JAX functions
return a new one); ``prefill`` and ``decode_step`` return it all the
same.

MoE layers (``cfg.moe``) take the JAX package's three paths, chosen as
its ``_ffn`` chooses them: ``_moe_reference`` (every expert on every
token, exact top-k, no capacity drops) with no mesh or a "model" axis of
one; ``moe_ep_shardmap`` (the expert-parallel token exchange, two
all_to_alls over "model" a co-owner, capacity drops) for prefill and
training on a simulated mesh; ``moe_decode_psum`` (replicated tokens,
each model shard's experts, one psum) for decode on it.  The mesh is a
``ShardCtx`` over ``launch/mesh.py::SimMesh``: every shard is stacked on
leading (data..., model) dims on one device, and each exchange goes
through ``core/collectives.py``, which records it.

Training keeps no cache: each layer's attention is kernel 9 on its own
keys and values with its gradient by kernel 9b
(``fa_ops.attention``).  ``cfg.remat_policy`` maps the JAX package's
``jax.checkpoint`` of a layer: "full" recomputes a layer in the backward
pass (``torch.utils.checkpoint``, non-reentrant), "dots" recomputes all
but the products without batch dimensions (``_dots_policy``, as
``dots_with_no_batch_dims_saveable`` saves them), "none" keeps every
activation.  ``lm_loss`` takes the cross entropy over equal sequence
chunks of about ``seq_chunk`` positions, each chunk's logits recomputed
in the backward pass, so (B, S, V) is never held at once; its logit
GEMMs are float32, or keep the operands' dtype under ``cfg.loss_bf16``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LMConfig
from repro_torch.core import collectives as coll
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.mesh import make_generator
from repro_torch.models.common import (ShardCtx, chunked_attention, rms_norm,
                                       rope)

Params = Dict[str, torch.Tensor]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_ATTN_KEYS = ("wq", "wk", "wv", "wo", "ln1", "ln2")
_DENSE_KEYS = ("wg", "wu", "wd")
_MOE_KEYS = ("router", "wg_e", "wu_e", "wd_e")
_NO_MESH = ShardCtx()


def layer_keys(cfg: LMConfig) -> Tuple[str, ...]:
    """The stacked per-layer parameter names of ``cfg``, in the JAX
    package's order (``_stack_layers``): attention and norms, then the
    dense FFN's or the MoE's."""
    return _ATTN_KEYS + (_DENSE_KEYS if cfg.moe is None else _MOE_KEYS)


def _layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """name -> (one layer's shape, fan_in) of the normal weights."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out = {"wq": ((d, hq * dh), d), "wk": ((d, hkv * dh), d),
           "wv": ((d, hkv * dh), d), "wo": ((hq * dh, d), hq * dh)}
    if cfg.moe is None:
        f = cfg.d_ff
        out.update(wg=((d, f), d), wu=((d, f), d), wd=((f, d), f))
    else:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        out.update(router=((d, e), d), wg_e=((e, d, fe), d),
                   wu_e=((e, d, fe), d), wd_e=((e, fe, d), fe))
    return out


def init_params(cfg: LMConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """N(0, 1/fan_in) weights in ``dtype`` (the config's by default) and
    unit float32 norms, made on ``device`` from one generator seeded
    with ``seed``: the embedding first, then layer by layer, each
    layer's tensors drawn in float32 one at a time and written into the
    stacked (L, ...) tensors.  No float32 transient is larger than one
    layer's tensor (qwen3-moe-30b-a3b's whole ``wg_e`` would be 38.7 GB),
    and a config cut in depth holds the first layers of the full one."""
    dtype = dtype or _DTYPES[cfg.dtype]
    gen = make_generator(device, seed)
    d, n_l = cfg.d_model, cfg.n_layers

    def nrm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                * (fan_in ** -0.5)).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)
    shapes = _layer_shapes(cfg)
    p = {"embed": nrm((cfg.vocab, d), d), "final_ln": ones((d,)),
         "ln1": ones((n_l, d)), "ln2": ones((n_l, d))}
    for name, (shape, _) in shapes.items():
        p[name] = torch.empty((n_l, *shape), dtype=dtype, device=device)
    for i in range(n_l):
        for name, (shape, fan_in) in shapes.items():
            p[name][i] = nrm(shape, fan_in)
    return {k: p[k] for k in ("embed", "final_ln", *layer_keys(cfg))}


def params_from_jax(cfg: LMConfig, params_np: Dict[str, np.ndarray],
                    device="cuda") -> Params:
    """The JAX package's parameter dict (numpy arrays of the stacked
    (L, ...) layers) as the port's, on ``device``, in the same dtypes."""
    want = {"embed", "final_ln", *layer_keys(cfg)}
    if set(params_np) != want:
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(want - set(params_np))}, extra "
                       f"{sorted(set(params_np) - want)}")
    out = {}
    for name, arr in params_np.items():
        arr = np.array(arr)                     # a writable copy
        if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out[name] = t.to(device)
    return out


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> Params:
    dtype = dtype or _DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# attention over a layer's cache: (q, ck, cv, q_offset, kv_len, window)
AttnFn = Callable[..., torch.Tensor]


def kernel_attention(q, ck, cv, q_offset: int, kv_len: int,
                     window: Optional[int]) -> torch.Tensor:
    """Kernel 9 over the cache's first ``kv_len`` keys."""
    return fa_ops.flash_attention_gqa(q, ck[:, :kv_len], cv[:, :kv_len],
                                      causal=True, window=window,
                                      q_offset=q_offset)


def plain_attention(q, ck, cv, q_offset: int, kv_len: int,
                    window: Optional[int]) -> torch.Tensor:
    """The JAX package's attention over the whole cache, as its ``_attn``
    calls it: ``chunked_attention`` with ``kv_valid_len``."""
    return chunked_attention(q, ck, cv, q_offset=q_offset, causal=True,
                             window=window, kv_valid_len=kv_len)


# How far the kernel path's bf16 logits may sit from the plain path's:
# the largest |difference| over the largest |plain logit|, and the mean
# |difference| over it.  Two correct attention paths differ by float32
# summation order, which a bf16 round of each layer's output turns into
# a gap of a few percent of the largest logit after 30 layers at full
# width (chip_smoke.py phase 13 prints it; the CPU check, at 4 layers, is
# tests/test_torch_transformer.py::test_bf16_paths_agree_at_full_width);
# a wrong mask or head mapping moves logits by their own scale.
LOGIT_TOL_BF16 = {"max": 0.06, "mean": 0.01}


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """{"max": max|got - want|, "mean": mean|got - want|}, each over
    max|want|."""
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    return {"max": float(d.max()) / scale, "mean": float(d.mean()) / scale}


def _qkv(h, lp, cfg: LMConfig, q_offset: int):
    """A layer's q (B, S, Hq, dh) and k, v (B, S, Hkv, dh) of ``h`` at
    positions q_offset.., q and k rotated."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    q = (hn @ lp["wq"]).reshape(b, s, hq, dh)
    k = (hn @ lp["wk"]).reshape(b, s, hkv, dh)
    v = (hn @ lp["wv"]).reshape(b, s, hkv, dh)
    pos = q_offset + torch.arange(s, device=h.device)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _attn(h, lp, cfg: LMConfig, q_offset: int, ck, cv,
          attn: AttnFn) -> torch.Tensor:
    """One attention block; writes the new keys and values into the
    layer's cache (ck, cv) at ``q_offset`` in place."""
    b, s, _ = h.shape
    q, k, v = _qkv(h, lp, cfg, q_offset)
    ck[:, q_offset:q_offset + s] = k.to(ck.dtype)
    cv[:, q_offset:q_offset + s] = v.to(cv.dtype)
    out = attn(q, ck, cv, q_offset, q_offset + s, cfg.swa_window)
    return h + out.reshape(b, s, -1) @ lp["wo"]


# ------------------------------------------------------------------ MoE


def moe_route(x: torch.Tensor, router_w: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate, choice) of tokens x (..., T, D): the top-k of the float32
    router softmax, largest first, the gates renormalised to sum to 1."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, choice = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return gate, choice


def _moe_local_math(xs, wg, wu, wd):
    """xs: (..., E_loc, C, D) grouped tokens -> the SwiGLU expert FFN of
    each group, batched over the experts (and any leading shard dims)."""
    g = xs @ wg
    u = xs @ wu
    h = torch.nn.functional.silu(g.float()).to(u.dtype) * u
    return h @ wd


def _moe_reference(x, router_w, wg, wu, wd, cfg: LMConfig):
    """Dense reference MoE (one device): every expert on every token,
    exact top-k, no capacity drops.  x (T, D); wg, wu (E, D, F), wd (E,
    F, D).  Each expert's products are kept (E, T, .), the JAX package's
    (T, E, .) transposed: ``x @ wg`` shares x over the experts, a product
    without batch dims, as its ``"td,edf->tef"``."""
    e_n, k = cfg.moe.n_experts, cfg.moe.top_k
    gate, choice = moe_route(x, router_w, k)
    onehot = torch.nn.functional.one_hot(choice, e_n).to(x.dtype)  # (T,k,E)
    w = torch.einsum("tk,tke->te", gate.to(x.dtype), onehot)
    g = x @ wg                                   # (E, T, F)
    u = x @ wu
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = h @ wd                                   # (E, T, D)
    return torch.bmm(w.unsqueeze(1), y.transpose(0, 1)).squeeze(1)


def ep_layout(n_experts: int, tp: int) -> Tuple[int, int]:
    """(E_loc, tp_sub): the experts a "model" shard owns, and the shards
    that co-own one expert (each an F-slice of it) where E < tp."""
    if n_experts % tp and tp % n_experts:
        raise ValueError(f"{n_experts} experts do not split over a model "
                         f"axis of {tp} (nor it over them)")
    return max(n_experts // tp, 1), max(tp // n_experts, 1)


def ep_capacity(t_loc: int, cfg: LMConfig, tp: int,
                capacity_mult: float = 1.0) -> int:
    """Slots a (destination shard, expert) queue holds: the JAX
    package's ``max(8, ceil(T_loc k tp_sub cf / tp))``."""
    tp_sub = ep_layout(cfg.moe.n_experts, tp)[1]
    cf = cfg.moe.capacity_factor * capacity_mult
    return int(max(8, np.ceil(t_loc * cfg.moe.top_k * tp_sub * cf / tp)))


def ep_route(xl: torch.Tensor, router_w: torch.Tensor, cfg: LMConfig,
             tp: int, cap: int) -> Dict[str, torch.Tensor]:
    """The expert-parallel dispatch of each shard's tokens xl (n_dev,
    T_loc, D), as ``moe_ep_shardmap``'s body computes it: gate and choice
    (n_dev, T_loc, k); per (token, choice), flattened token-major, the
    first destination shard ``dest0``, the local expert ``e_loc``, the
    rank ``pos`` within its (destination, expert) queue (stable argsort
    of the queue key, minus ``searchsorted`` of the key's first place)
    and ``keep = pos < cap``."""
    e_loc_n, tp_sub = ep_layout(cfg.moe.n_experts, tp)
    gate, choice = moe_route(xl, router_w, cfg.moe.top_k)
    flat_e = choice.reshape(choice.shape[0], -1)
    dest0 = (flat_e // e_loc_n) if tp_sub == 1 else flat_e * tp_sub
    e_loc = flat_e % e_loc_n
    key = (dest0 * e_loc_n + e_loc).to(torch.int32)
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_key = torch.gather(key, 1, order)
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.arange(key.shape[1], device=key.device) - first
    pos = torch.empty_like(rank).scatter_(1, order, rank)
    return {"gate": gate, "choice": choice, "dest0": dest0, "e_loc": e_loc,
            "pos": pos, "keep": pos < cap}


def ep_weights(wg, wu, wd, tp: int, tp_sub: int):
    """The experts' weights as the "model" shards hold them, stacked
    (tp, E_loc, ...).  With E < tp each expert's F is cut into tp_sub
    slices first, expert-major, so shard r = e tp_sub + s holds expert
    e's s-th slice (the JAX package's reshape before its shard_map)."""
    if tp_sub > 1:
        e_n, d, f = wg.shape
        fs = f // tp_sub
        wg = wg.reshape(e_n, d, tp_sub, fs).transpose(1, 2).reshape(
            e_n * tp_sub, d, fs)
        wu = wu.reshape(e_n, d, tp_sub, fs).transpose(1, 2).reshape(
            e_n * tp_sub, d, fs)
        wd = wd.reshape(e_n * tp_sub, fs, d)
    return tuple(w.reshape(tp, w.shape[0] // tp, *w.shape[1:])
                 for w in (wg, wu, wd))


def _mesh_dims(ctx: ShardCtx) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axes, sizes) of the stacked shards: the data axes, then "model"."""
    axes = (*ctx.dp, "model")
    return axes, tuple(ctx.mesh.shape[a] for a in axes)


def moe_ep_shardmap(x, router_w, wg, wu, wd, cfg: LMConfig, ctx: ShardCtx,
                    capacity_mult: float = 1.0):
    """Token-exchange expert parallelism along the "model" axis.

    x: (T, D) tokens split over every shard of the mesh, data-major, as
    the JAX package's ``P((*dp, "model"), None)``; returns the same
    shape.  Each shard routes its tokens, scatters each kept (token,
    choice) into its slot of the destination's (E_loc, cap) queue (a
    slot at ``cap`` or beyond is dropped), one all_to_all over "model"
    delivers the queues, the owners run their experts, a second
    all_to_all returns the results, and each token sums its gated
    choices; with E < tp this runs once for each of the tp_sub
    co-owners, whose partial sums add up."""
    e_n, k = cfg.moe.n_experts, cfg.moe.top_k
    tp = ctx.tp_size
    if ctx.mesh is None or tp == 1:
        return _moe_reference(x, router_w, wg, wu, wd, cfg)
    e_loc_n, tp_sub = ep_layout(e_n, tp)
    axes, lead = _mesh_dims(ctx)
    n_dev = math.prod(lead)
    t, d = x.shape
    if t % n_dev:
        raise ValueError(f"{t} tokens do not split over {n_dev} shards")
    t_loc = t // n_dev
    cap = ep_capacity(t_loc, cfg, tp, capacity_mult)
    xl = x.reshape(n_dev, t_loc, d)
    r = ep_route(xl, router_w, cfg, tp, cap)
    wgs, wus, wds = ep_weights(wg, wu, wd, tp, tp_sub)
    tok = torch.arange(t_loc, device=x.device).repeat_interleave(k)
    src = xl[:, tok]                                     # (n_dev, T_loc k, D)
    width = e_loc_n * cap
    keep = r["keep"]
    # a dropped (over-capacity) entry goes to a spare slot past the
    # queue, which is cut off before the exchange (JAX drops the
    # out-of-bounds scatter); its gather below is masked by keep
    slot = torch.where(keep, r["e_loc"] * cap + r["pos"], width)
    contrib = None
    for sub in range(tp_sub):
        dest = r["dest0"] + sub
        buf = x.new_zeros(n_dev, tp * (width + 1), d)
        buf.scatter_(1, (dest * (width + 1) + slot)[..., None].expand(
            -1, -1, d), src)
        buf = buf.view(n_dev, tp, width + 1, d)[:, :, :width]
        recv = coll.all_to_all_axis(buf.reshape(*lead, tp, width, d), axes,
                                    "model")
        xs = recv.reshape(*lead, tp, e_loc_n, cap, d).transpose(-4, -3)
        ys = _moe_local_math(xs.reshape(*lead, e_loc_n, tp * cap, d),
                             wgs, wus, wds)
        ys = ys.reshape(*lead, e_loc_n, tp, cap, d).transpose(-4, -3)
        back = coll.all_to_all_axis(ys.reshape(*lead, tp, width, d), axes,
                                    "model").reshape(n_dev, tp * width, d)
        idx = dest * width + slot.clamp(max=width - 1)
        got = torch.gather(back, 1, idx[..., None].expand(-1, -1, d))
        got = got * keep[..., None].to(got.dtype)
        contrib = got if contrib is None else contrib + got
    contrib = contrib.float() * r["gate"].reshape(n_dev, -1)[..., None]
    out = torch.zeros(n_dev, t_loc, d, dtype=torch.float32, device=x.device)
    out.index_add_(1, tok, contrib)
    return out.to(x.dtype).reshape(t, d)


def moe_decode_psum(x, router_w, wg, wu, wd, cfg: LMConfig, ctx: ShardCtx):
    """Decode-path MoE: tokens split over the data axes and replicated
    over "model"; each model shard applies its E_loc experts to the
    choices it owns and one psum over "model" combines them (no
    all_to_all for a few tokens)."""
    e_n, k = cfg.moe.n_experts, cfg.moe.top_k
    tp = ctx.tp_size
    if ctx.mesh is None or tp == 1 or e_n < tp:
        return _moe_reference(x, router_w, wg, wu, wd, cfg)
    e_loc_n = ep_layout(e_n, tp)[0]
    axes, lead = _mesh_dims(ctx)
    t, d = x.shape
    n_dp = math.prod(lead[:-1])
    if t % n_dp:
        raise ValueError(f"{t} tokens do not split over {n_dp} data shards")
    # (*dp, 1, T_dp, D): each data shard's tokens, alike on every model
    # shard
    xl = x.reshape(*lead[:-1], 1, t // n_dp, d)
    wgs, wus, wds = ep_weights(wg, wu, wd, tp, 1)
    gate, choice = moe_route(xl, router_w, k)
    first = (torch.arange(tp, device=x.device) * e_loc_n).reshape(
        tp, 1, 1)                                       # model shard r's
    mine = (choice >= first) & (choice < first + e_loc_n)
    local = torch.where(mine, choice - first, -1)       # (*dp, tp, T_dp, k)
    out = torch.zeros(*lead, t // n_dp, d, dtype=torch.float32,
                      device=x.device)
    for e in range(e_loc_n):
        wsum = torch.where(local == e, gate, 0.0).sum(-1)   # (*dp, tp, T)
        g = xl @ wgs[:, e]
        u = xl @ wus[:, e]
        h = torch.nn.functional.silu(g.float()).to(u.dtype) * u
        y = (h @ wds[:, e]).float()
        out = out + y * wsum[..., None]
    out = coll.psum_axis(out, axes, "model").to(x.dtype)
    return out[..., 0, :, :].reshape(t, d)


# ------------------------------------------------------------ the passes


def _ffn(h, lp, cfg: LMConfig, ctx: ShardCtx = _NO_MESH,
         decode: bool = False) -> torch.Tensor:
    """The FFN block: dense SwiGLU, or the MoE path the JAX package's
    ``_ffn`` takes (``moe_decode_psum`` when ``decode``, else
    ``moe_ep_shardmap``; each falls back to ``_moe_reference`` without a
    "model" axis)."""
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        g = hn @ lp["wg"]
        u = hn @ lp["wu"]
        y = (torch.nn.functional.silu(g.float()).to(u.dtype) * u) \
            @ lp["wd"]
        return h + y
    b, s, d = h.shape
    moe = moe_decode_psum if decode else moe_ep_shardmap
    y = moe(hn.reshape(b * s, d), lp["router"], lp["wg_e"], lp["wu_e"],
            lp["wd_e"], cfg, ctx)
    return h + y.reshape(b, s, d)


def _run(params: Params, tokens, cache: Params, cfg: LMConfig,
         q_offset: int, attn: AttnFn, ctx: ShardCtx, decode: bool):
    """The layers over ``tokens`` (B, S) at positions q_offset.. ->
    (cache, float32 logits of the last position (B, V))."""
    keys = layer_keys(cfg)
    h = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    for i in range(cfg.n_layers):
        lp = {k: params[k][i] for k in keys}
        h = _attn(h, lp, cfg, q_offset, cache["k"][i], cache["v"][i], attn)
        h = _ffn(h, lp, cfg, ctx, decode)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", h[:, -1].float(),
                          params["embed"].float())
    return cache, logits


def prefill(params: Params, tokens: torch.Tensor, cache: Params,
            cfg: LMConfig, ctx: Optional[ShardCtx] = None,
            attn: AttnFn = kernel_attention):
    """Full-prompt pass that fills the KV cache from position 0; returns
    (cache, logits of the last position).  ``ctx`` (default: no mesh)
    is the simulated mesh the MoE layers exchange over."""
    return _run(params, tokens, cache, cfg, 0, attn, ctx or _NO_MESH, False)


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: LMConfig, ctx: Optional[ShardCtx] = None,
                attn: AttnFn = kernel_attention):
    """One decode step: token (B, 1) at position ``pos`` (the current
    length).  Returns (cache, logits (B, V))."""
    return _run(params, token, cache, cfg, int(pos), attn, ctx or _NO_MESH,
                True)


# ------------------------------------------------------------ training


def _block(h, *lp_vals, cfg: LMConfig, ctx: ShardCtx) -> torch.Tensor:
    """One layer over the whole sequence from position 0, no cache."""
    lp = dict(zip(layer_keys(cfg), lp_vals))
    b, s, _ = h.shape
    q, k, v = _qkv(h, lp, cfg, 0)
    out = fa_ops.attention(q, k, v, causal=True, window=cfg.swa_window)
    return _ffn(h + out.reshape(b, s, -1) @ lp["wo"], lp, cfg, ctx)


def _shared_operand(t) -> bool:
    """Whether a batched product's operand is one matrix broadcast over
    the batch (stride 0): ``torch.matmul`` runs a product without batch
    dims that way where it does not fold it into ``mm``."""
    return isinstance(t, torch.Tensor) and t.dim() == 3 and t.stride(0) == 0


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dims, recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable``: ``mm`` and ``addmm`` (the
    projections, the router, ``_moe_reference``'s ``x @ wg`` where
    matmul folds it), and a ``bmm`` one of whose operands is shared by
    every batch (that product, unfolded); a ``bmm`` over a real batch
    (the EP path's per-expert ``"ecd,edf->ecf"``, the combine over
    tokens) is recomputed."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    if op == torch.ops.aten.bmm.default and any(
            _shared_operand(a) for a in args[:2]):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "full", "dots")


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
            ctx: Optional[ShardCtx] = None, *,
            remat: bool = True) -> torch.Tensor:
    """Full causal pass over tokens (B, S) -> the final hidden states
    (B, S, D), each layer under ``cfg.remat_policy`` when ``remat``;
    ``ctx`` (default: no mesh) as in ``prefill``."""
    policy = cfg.remat_policy if remat else "none"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    block = functools.partial(_block, cfg=cfg, ctx=ctx or _NO_MESH)
    h = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    layers = [params[k].unbind(0) for k in layer_keys(cfg)]
    for i in range(cfg.n_layers):
        lp = [w[i] for w in layers]
        if policy == "none":
            h = block(h, *lp)
        elif policy == "full":
            h = ckpt.checkpoint(block, h, *lp, use_reentrant=False)
        else:
            h = ckpt.checkpoint(
                block, h, *lp, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return rms_norm(h, params["final_ln"], cfg.norm_eps)


class _LogitsF32Out(torch.autograd.Function):
    """(N, D) @ (V, D).T -> float32 logits from operands kept in their own
    dtype, as the JAX package's ``loss_bf16`` einsum
    (``preferred_element_type=float32``): on the card bf16 operands go to
    the tensor cores with a float32 output (``torch.mm(..., out_dtype)``);
    on the CPU the operands are widened first, which is the same product
    (bf16 products are exact in float32, the sums float32 either way).
    The backward is that einsum's transpose: float32 cotangents against
    the widened operands, each gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, h, emb):
        ctx.save_for_backward(h, emb)
        if not h.is_cpu and h.dtype != torch.float32:
            return torch.mm(h, emb.t(), out_dtype=torch.float32)
        return torch.mm(h.float(), emb.float().t())

    @staticmethod
    def backward(ctx, g):
        h, emb = ctx.saved_tensors
        return (torch.mm(g, emb.float()).to(h.dtype),
                torch.mm(g.t(), h.float()).to(emb.dtype))


def _chunk_loss(hc, lc, emb, loss_bf16: bool = False) -> torch.Tensor:
    """sum(logsumexp(logits) - logits[label]) over one chunk, the logits
    float32.  By default both operands are widened to float32 first
    (float32 GEMMs, on the card's CUDA cores); with ``loss_bf16`` and
    operands of one dtype they stay in that dtype with a float32 output
    (``_LogitsF32Out``, the tensor cores for bf16 on the card), as the
    JAX package's ``cfg.loss_bf16`` einsum.  The two give the same
    products and differ in the summation order and in the units that
    run them."""
    if loss_bf16 and hc.dtype == emb.dtype:
        b, c, d = hc.shape
        logits = _LogitsF32Out.apply(hc.reshape(b * c, d), emb).reshape(
            b, c, -1)
    else:
        logits = torch.einsum("bsd,vd->bsv", hc.float(), emb.float())
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def lm_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: LMConfig, ctx: Optional[ShardCtx] = None,
            seq_chunk: int = 2048, remat: bool = True) -> torch.Tensor:
    """Causal-LM cross entropy, the mean over (B, S), with the logits
    taken in ``n_chunks = max(S // min(seq_chunk, S), 1)`` equal chunks
    of the sequence, as the JAX package's; an S that ``n_chunks`` does
    not divide raises ``ValueError``, as the JAX package's reshape
    refuses it."""
    h = forward(params, tokens, cfg, ctx, remat=remat)
    b, s, _ = h.shape
    n_chunks = max(s // min(seq_chunk, s), 1)
    if s % n_chunks:
        raise ValueError(f"lm_loss: sequence length {s} does not split into "
                         f"{n_chunks} equal chunks (seq_chunk {seq_chunk})")
    c = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        total = total + ckpt.checkpoint(
            _chunk_loss, h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
            params["embed"], cfg.loss_bf16, use_reentrant=False)
    return total / (b * s)
