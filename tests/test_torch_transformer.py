"""The port's LM serving slice against the JAX package at the serving
launcher's reduced dims, in float32, with the JAX parameters carried
across by ``params_from_jax``: prefill and decode logits, the KV cache,
and the greedy tokens of ``Server.serve``.  The port's attention runs
kernel 9's plain version here (CPU tensors); the JAX side runs its
model's ``chunked_attention``.

Tolerance: logits and cache within rtol = atol = 1e-4 in float32 (two
layers of matmuls, softmax and norms summed in another order; the
logits are dot products over d_model = 64 of O(1) values)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import transformer as jax_tf
from repro.models.common import ShardCtx
from repro.runtime.server import Request as JaxRequest
from repro.runtime.server import Server as JaxServer
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.runtime.server import Request
from _torch_threads import one_thread  # noqa: F401

CTX = ShardCtx(mesh=None)
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(arch="smollm-135m", **extra):
    kw = dict(serve.LM_SMALL, dtype="float32", **extra)
    jcfg = jax_base.get_config(arch)
    if jcfg.moe is not None:         # the launchers' MoE cut
        kw["moe"] = dataclasses.replace(jcfg.moe, **serve.MOE_SMALL)
    jcfg = jax_base.reduced(jcfg, **kw)
    cfg = base.reduced(base.get_config(arch), **{
        **kw, "moe": None if jcfg.moe is None else base.MoEConfig(
            **dataclasses.asdict(jcfg.moe))})
    assert cfg == serve.reduced_lm(base.reduced(base.get_config(arch),
                                                dtype="float32",
                                                **extra))
    jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    params = tf.params_from_jax(cfg, {k: np.asarray(v) for k, v in
                                      jp.items()}, device="cpu")
    return jcfg, cfg, jp, params


@pytest.mark.parametrize("swa", [None, 8])
def test_prefill_and_decode_match_jax(swa):
    jcfg, cfg, jp, params = _setup(swa_window=swa)
    rng = np.random.default_rng(3)
    b, s, max_len = 3, 20, 32
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jcache, jlog = jax_tf.prefill(jp, jnp.asarray(toks),
                                  jax_tf.init_kv_cache(jcfg, b, max_len),
                                  jcfg, CTX)
    cache = tf.init_kv_cache(cfg, b, max_len, device="cpu")
    cache, log = tf.prefill(params, torch.from_numpy(toks), cache, cfg)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)
    for pos in range(s, s + 4):        # teacher-forced on the JAX argmax
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        jcache, jlog = jax_tf.decode_step(jp, jcache, jnp.asarray(tok),
                                          jnp.int32(pos), jcfg, CTX)
        cache, log = tf.decode_step(params, cache, torch.from_numpy(tok),
                                    pos, cfg)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)


def test_kernel_and_plain_attention_paths_agree():
    """The serving path's attention (kernel 9 over the filled cache) and
    the JAX model's (chunked attention over the whole cache with
    kv_valid_len) give the same logits."""
    _, cfg, _, params = _setup()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    outs = []
    for attn in (tf.kernel_attention, tf.plain_attention):
        cache = tf.init_kv_cache(cfg, 2, 24, device="cpu")
        cache, log = tf.prefill(params, toks, cache, cfg, attn=attn)
        _, log2 = tf.decode_step(params, cache, toks[:, :1], 12, cfg,
                                 attn=attn)
        outs.append((log, log2))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _serve_both(arch):
    """The launcher's traffic (6 requests from default_rng(0), 5 new
    tokens, max_batch 4, max_len 128, bucket 32) through both servers,
    at the launcher's reduced dims of ``arch``, in float32."""
    jcfg, cfg, jp, params = _setup(arch)
    max_b, max_len = 4, 128

    @jax.jit
    def prefill_fn(tokens):
        cache = jax_tf.init_kv_cache(jcfg, max_b, max_len)
        return jax_tf.prefill(jp, tokens, cache, jcfg, CTX)

    @jax.jit
    def decode_fn(cache, tok, pos):
        return jax_tf.decode_step(jp, cache, tok, pos, jcfg, CTX)

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 24))
                    .astype(np.int32), max_new_tokens=5) for _ in range(6)]
    want = JaxServer(prefill_fn, decode_fn, max_batch=max_b,
                     bucket=32).serve(requests(JaxRequest))
    server = serve.make_lm_server(cfg, params, "cpu", max_batch=max_b,
                                  max_len=max_len, bucket=32)
    got = server.serve(requests(Request))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
        np.testing.assert_array_equal(g.out, w.out)


def test_server_greedy_tokens_match_jax():
    _serve_both("smollm-135m")


def test_moe_config_is_rejected_by_name():
    """MoE configs are no longer rejected: qwen3-moe-30b-a3b, by name, at
    the serving launcher's reduced dims (4 experts, top-2) serves the
    launcher's traffic to the JAX package's greedy tokens (its prefill
    through ``moe_ep_shardmap`` and its decode through
    ``moe_decode_psum``, each ``_moe_reference`` with no mesh)."""
    assert base.get_config("qwen3-moe-30b-a3b").moe.n_experts == 128
    _serve_both("qwen3-moe-30b-a3b")


def test_full_config_param_count():
    cfg = base.get_config("smollm-135m")
    assert cfg.d_head == 64
    assert cfg.n_params() == jax_base.get_config("smollm-135m").n_params()
    assert 134e6 < cfg.n_params() < 135e6
    assert dataclasses.asdict(cfg)["n_kv_heads"] == 3


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--arch", "smollm-135m", "--device", "cpu",
                "--requests", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].startswith("req0: ")
    assert all(len(eval(x.split("->")[1])) == 5 for x in lines)


def test_bf16_paths_agree_at_full_width():
    """At the registered width in bfloat16 (depth cut to 4 layers), the
    serving path's attention (kernel 9's plain version here) and the JAX
    model's chunked attention give logits within ``LOGIT_TOL_BF16``,
    prefill and teacher-forced decode: the tolerance ``chip_smoke.py``
    holds the kernel to on the card."""
    cfg = base.reduced(base.get_config("smollm-135m"), n_layers=4)
    params = tf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 160)).astype(np.int32))
    logs = {}
    for name, attn in (("kernel", tf.kernel_attention),
                       ("plain", tf.plain_attention)):
        cache = tf.init_kv_cache(cfg, 2, 168, device="cpu")
        cache, log = tf.prefill(params, toks, cache, cfg, attn=attn)
        logs[name] = [log]
        for pos in range(160, 163):
            tok = logs["kernel"][pos - 160].argmax(-1).to(torch.int32)
            cache, log = tf.decode_step(params, cache, tok[:, None], pos,
                                        cfg, attn=attn)
            logs[name].append(log)
    for a, b in zip(logs["kernel"], logs["plain"]):
        gap = tf.logit_gap(a, b)
        assert gap["max"] <= tf.LOGIT_TOL_BF16["max"], gap
        assert gap["mean"] <= tf.LOGIT_TOL_BF16["mean"], gap
