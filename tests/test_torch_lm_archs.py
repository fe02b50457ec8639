"""Every LM arch of the port against the JAX package at
``tests/test_models.py::_reduced_lm``'s dims (2 layers, d 64, d_head 16,
vocab 211; 4 heads, or 3 on 1 kv head for starcoder2's 36; MoE cut to 4
experts top-2 of d_ff 32; mixtral's window cut to 8), in float32, the
JAX parameters carried across by ``params_from_jax``: ``forward``,
``prefill`` (logits and the KV cache), three teacher-forced
``decode_step``s, ``lm_loss`` and every gradient; and the parameter
counts of every registered LM config.

Tolerance: rtol = atol = 1e-5 on hidden states, the cache, the logits,
the loss and the gradients (the same float32 math summed in another
order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.models import transformer as r_tf
from repro.models.common import ShardCtx as RShardCtx
from repro_torch.configs import base
from repro_torch.models import transformer as tf
from _torch_threads import one_thread  # noqa: F401

LM_ARCHS = ["stablelm-3b", "smollm-135m", "starcoder2-7b",
            "qwen3-moe-30b-a3b", "mixtral-8x22b"]
ALL_LM = LM_ARCHS + [f"qwen3-moe-r{i}" for i in range(1, 5)]
RCTX = RShardCtx(mesh=None)
TOL = dict(rtol=1e-5, atol=1e-5)


def _reduced_lm(arch, get_config, reduced):
    """``tests/test_models.py::_reduced_lm`` in float32, for either
    package's registry."""
    cfg = get_config(arch)
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab=211, d_head=16,
              dtype="float32")
    if cfg.n_heads % 4 == 0:
        kw.update(n_heads=4,
                  n_kv_heads=max(cfg.n_kv_heads * 4 // cfg.n_heads, 1))
    else:
        kw.update(n_heads=3, n_kv_heads=1)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        d_ff_expert=32)
    if cfg.swa_window:
        kw["swa_window"] = 8
    return reduced(cfg, **kw)


_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        rcfg = _reduced_lm(arch, r_base.get_config, r_base.reduced)
        cfg = _reduced_lm(arch, base.get_config, base.reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        rp = r_tf.init_params(rcfg, jax.random.PRNGKey(0))
        params = tf.params_from_jax(cfg, {k: np.asarray(v)
                                          for k, v in rp.items()},
                                    device="cpu")
        toks = np.random.default_rng(len(arch)).integers(
            0, cfg.vocab, (2, 17)).astype(np.int32)
        _CACHE[arch] = rcfg, cfg, rp, params, toks
    return _CACHE[arch]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_jax(arch):
    rcfg, cfg, rp, params, toks = _setup(arch)
    want = jax.jit(lambda p, t: r_tf.forward(p, t, rcfg, RCTX, remat=False))(
        rp, jnp.asarray(toks))
    got = tf.forward(params, torch.from_numpy(toks), cfg, remat=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    rcfg, cfg, rp, params, toks = _setup(arch)
    b, s, max_len = 2, toks.shape[1], 24
    rcache, rlog = jax.jit(lambda p, t, c: r_tf.prefill(p, t, c, rcfg, RCTX))(
        rp, jnp.asarray(toks), r_tf.init_kv_cache(rcfg, b, max_len))
    r_decode = jax.jit(lambda p, c, t, i: r_tf.decode_step(p, c, t, i, rcfg,
                                                           RCTX))
    cache = tf.init_kv_cache(cfg, b, max_len, device="cpu")
    cache, log = tf.prefill(params, torch.from_numpy(toks), cache, cfg)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   **TOL)
    for pos in range(s, s + 3):
        tok = np.array(jnp.argmax(rlog, -1), np.int32)[:, None]
        rcache, rlog = r_decode(rp, rcache, jnp.asarray(tok), jnp.int32(pos))
        cache, log = tf.decode_step(params, cache, torch.from_numpy(tok),
                                    pos, cfg)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog),
                                   **TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    rcfg, cfg, rp, params, toks = _setup(arch)
    inp, lab = toks[:, :-1], toks[:, 1:]
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: r_tf.lm_loss(
        p, inp, lab, rcfg, RCTX, seq_chunk=8)))(rp)
    pp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = tf.lm_loss(pp, torch.from_numpy(inp), torch.from_numpy(lab), cfg,
                      seq_chunk=8)
    grads = dict(zip(pp, torch.autograd.grad(loss, list(pp.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(rloss), **TOL)
    assert sorted(grads) == sorted(rgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(rgrads[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ALL_LM)
def test_param_counts_match_jax(arch):
    cfg, rcfg = base.get_config(arch), r_base.get_config(arch)
    assert cfg.n_params() == rcfg.n_params()
    assert cfg.n_active_params() == rcfg.n_active_params()
    assert cfg.n_active_params() <= cfg.n_params()
    # the stacked tensors init_params makes hold n_params() values
    small = _reduced_lm(arch, base.get_config, base.reduced)
    p = tf.init_params(small, seed=0, device="cpu")
    assert sum(x.numel() for x in p.values()) == small.n_params()
