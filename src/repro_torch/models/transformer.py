"""Decoder-only LM on one card, dense family: GQA, RoPE, optional
sliding window; training (``forward``, ``lm_loss``), and prefill and
decode over a KV cache.

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
same.  MoE layers come with a later slice.

Training keeps no cache: each layer's attention is kernel 9 on its own
keys and values with its gradient by kernel 9b
(``fa_ops.attention``).  ``cfg.remat_policy`` maps the JAX package's
``jax.checkpoint`` of a layer: "full" recomputes a layer in the backward
pass (``torch.utils.checkpoint``, non-reentrant), "dots" recomputes all
but the matmuls without batch dimensions (a selective-checkpoint policy
that saves ``aten.mm``'s outputs, as
``dots_with_no_batch_dims_saveable`` saves the dots), "none" keeps
every activation.  ``lm_loss`` takes the cross entropy over equal sequence
chunks of about ``seq_chunk`` positions, each chunk's logits recomputed
in the backward pass, so (B, S, V) is never held at once; its logit
GEMMs are float32, or keep the operands' dtype under ``cfg.loss_bf16``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import chunked_attention, rms_norm, rope

Params = Dict[str, torch.Tensor]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1", "ln2", "wg", "wu", "wd")


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch}: MoE layers are not ported yet; the port serves "
            f"dense LMs only")


def init_params(cfg: LMConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """N(0, 1/fan_in) weights in ``dtype`` (the config's by default) and
    unit float32 norms, made on ``device`` from a generator seeded with
    ``seed``."""
    _dense_only(cfg)
    dtype = dtype or _DTYPES[cfg.dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    d, n_l, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def nrm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device)
                * (fan_in ** -0.5)).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)
    return {
        "embed": nrm((cfg.vocab, d), d),
        "final_ln": ones((d,)),
        "wq": nrm((n_l, d, hq * dh), d),
        "wk": nrm((n_l, d, hkv * dh), d),
        "wv": nrm((n_l, d, hkv * dh), d),
        "wo": nrm((n_l, hq * dh, d), hq * dh),
        "ln1": ones((n_l, d)),
        "ln2": ones((n_l, d)),
        "wg": nrm((n_l, d, f), d),
        "wu": nrm((n_l, d, f), d),
        "wd": nrm((n_l, f, d), f),
    }


def params_from_jax(cfg: LMConfig, params_np: Dict[str, np.ndarray],
                    device="cuda") -> Params:
    """The JAX package's parameter dict (numpy arrays of the stacked
    (L, ...) layers) as the port's, on ``device``, in the same dtypes."""
    _dense_only(cfg)
    want = {"embed", "final_ln", *_LAYER_KEYS}
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


def _ffn(h, lp, cfg: LMConfig) -> torch.Tensor:
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    g = hn @ lp["wg"]
    u = hn @ lp["wu"]
    y = (torch.nn.functional.silu(g.float()).to(u.dtype) * u) @ lp["wd"]
    return h + y


def _run(params: Params, tokens, cache: Params, cfg: LMConfig,
         q_offset: int, attn: AttnFn):
    """The layers over ``tokens`` (B, S) at positions q_offset.. ->
    (cache, float32 logits of the last position (B, V))."""
    _dense_only(cfg)
    h = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    for i in range(cfg.n_layers):
        lp = {k: params[k][i] for k in _LAYER_KEYS}
        h = _attn(h, lp, cfg, q_offset, cache["k"][i], cache["v"][i], attn)
        h = _ffn(h, lp, cfg)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", h[:, -1].float(),
                          params["embed"].float())
    return cache, logits


def prefill(params: Params, tokens: torch.Tensor, cache: Params,
            cfg: LMConfig, attn: AttnFn = kernel_attention):
    """Full-prompt pass that fills the KV cache from position 0; returns
    (cache, logits of the last position)."""
    return _run(params, tokens, cache, cfg, 0, attn)


def decode_step(params: Params, cache: Params, token: torch.Tensor,
                pos: int, cfg: LMConfig, attn: AttnFn = kernel_attention):
    """One decode step: token (B, 1) at position ``pos`` (the current
    length).  Returns (cache, logits (B, V))."""
    return _run(params, token, cache, cfg, int(pos), attn)


# ------------------------------------------------------------ training


def _block(h, *lp_vals, cfg: LMConfig) -> torch.Tensor:
    """One layer over the whole sequence from position 0, no cache."""
    lp = dict(zip(_LAYER_KEYS, lp_vals))
    b, s, _ = h.shape
    q, k, v = _qkv(h, lp, cfg, 0)
    out = fa_ops.attention(q, k, v, causal=True, window=cfg.swa_window)
    return _ffn(h + out.reshape(b, s, -1) @ lp["wo"], lp, cfg)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims, recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "full", "dots")


def forward(params: Params, tokens: torch.Tensor, cfg: LMConfig, *,
            remat: bool = True) -> torch.Tensor:
    """Full causal pass over tokens (B, S) -> the final hidden states
    (B, S, D), each layer under ``cfg.remat_policy`` when ``remat``."""
    _dense_only(cfg)
    policy = cfg.remat_policy if remat else "none"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    block = functools.partial(_block, cfg=cfg)
    h = params["embed"][tokens].to(_DTYPES[cfg.dtype])
    layers = [params[k].unbind(0) for k in _LAYER_KEYS]
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
        if h.is_cuda and h.dtype != torch.float32:
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
            cfg: LMConfig, seq_chunk: int = 2048,
            remat: bool = True) -> torch.Tensor:
    """Causal-LM cross entropy, the mean over (B, S), with the logits
    taken in ``n_chunks = max(S // min(seq_chunk, S), 1)`` equal chunks
    of the sequence, as the JAX package's; an S that ``n_chunks`` does
    not divide raises ``ValueError``, as the JAX package's reshape
    refuses it."""
    h = forward(params, tokens, cfg, remat=remat)
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
