"""The port's MoE layer on the CPU: ``_moe_reference`` against the JAX
package's (the top-k choice sets equal first, so that a flipped choice
shows as a flip, then the values), the expert-parallel and decode paths
on simulated meshes against the reference (pods included), the "dots"
remat policy's saved products, the axis collectives, the gradient
compressors against the JAX package's, the layer-by-layer
``init_params`` and the launchers' refusal of a model larger than the
device.

Tolerance: float32 within rtol = atol = 1e-5 (the same math summed in
another order); the compressors' int8 codes and top-k picks exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import base as r_base
from repro.models import transformer as r_tf
from repro.optim import grad_compress as r_gc
from repro_torch.configs import base
from repro_torch.core import collectives as coll
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.common import ShardCtx
from repro_torch.optim import grad_compress as gc
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(n_experts, top_k, d=32, f=16, cf=1.25):
    kw = dict(arch="t", family="moe", n_layers=1, d_model=d, n_heads=2,
              n_kv_heads=2, d_ff=f, vocab=64, dtype="float32")
    moe = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=f,
               capacity_factor=cf)
    return (r_base.LMConfig(**kw, moe=r_base.MoEConfig(**moe)),
            base.LMConfig(**kw, moe=base.MoEConfig(**moe)))


def _weights(n_experts, t, d=32, f=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((t, d), 1.0), ((d, n_experts), 0.3), ((n_experts, d, f), 0.2),
        ((n_experts, d, f), 0.2), ((n_experts, f, d), 0.2))]


@pytest.mark.parametrize("n_experts,top_k", [(8, 2), (16, 4), (4, 1)])
def test_moe_reference_choice_sets_then_values_match_jax(n_experts, top_k):
    rcfg, cfg = _cfgs(n_experts, top_k)
    x, rw, wg, wu, wd = _weights(n_experts, 48, seed=n_experts)
    logits = jnp.asarray(x) @ jnp.asarray(rw)
    _, rchoice = lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    _, choice = tf.moe_route(torch.from_numpy(x), torch.from_numpy(rw),
                             top_k)
    np.testing.assert_array_equal(np.sort(choice.numpy(), -1),
                                  np.sort(np.asarray(rchoice), -1))
    want = r_tf._moe_reference(*map(jnp.asarray, (x, rw, wg, wu, wd)), rcfg)
    got = tf._moe_reference(*map(torch.from_numpy, (x, rw, wg, wu, wd)), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("grid,pods,n_experts,top_k", [
    ((2, 4), None, 8, 2), ((1, 4), 2, 8, 2), ((2, 4), None, 2, 1),
    ((1, 2), None, 4, 2)])
def test_ep_and_decode_paths_equal_reference_on_simulated_meshes(
        grid, pods, n_experts, top_k):
    """With capacity for every choice the exchange drops nothing, so
    ``moe_ep_shardmap`` is the reference on any mesh, a "pod" axis
    among the data axes included; ``moe_decode_psum`` too (E >= tp; with
    E < tp it is the reference itself, as in the JAX package)."""
    _, cfg = _cfgs(n_experts, top_k, cf=8.0)
    args = list(map(torch.from_numpy, _weights(n_experts, 64, seed=1)))
    ctx = ShardCtx(make_local_mesh(*grid, device="cpu", pods=pods))
    want = tf._moe_reference(*args, cfg)
    with coll.ScheduleRecorder() as rec:
        got = tf.moe_ep_shardmap(*args, cfg, ctx, capacity_mult=4.0)
    tp_sub = max(grid[1] // n_experts, 1)
    assert rec.counts() == {"all-to-all": 2 * tp_sub, "total": 2 * tp_sub}
    assert {r.axes for r in rec.records} == {("model",)}
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    dec = tf.moe_decode_psum(*args, cfg, ctx)
    np.testing.assert_allclose(dec.numpy(), want.numpy(), **TOL)


def test_ep_capacity_drops_follow_stable_queue_ranks():
    """At capacity 8 a (shard, expert) queue keeps its first 8 entries in
    token order; the dropped choices add nothing to their tokens."""
    _, cfg = _cfgs(4, 1, cf=0.01)
    x, rw, wg, wu, wd = _weights(4, 64, seed=2)
    rw[:, 0] += 2.0 * np.sign(x[0])          # expert 0 crowded
    xl = torch.from_numpy(x).reshape(4, 16, 32)
    r = tf.ep_route(xl, torch.from_numpy(rw), cfg, 4, 8)
    for dev in range(4):
        for e in range(4):
            mine = (r["choice"][dev, :, 0] == e).nonzero()[:, 0]
            assert torch.equal(r["pos"][dev, mine], torch.arange(len(mine)))
    assert not bool(r["keep"].all())
    ctx = ShardCtx(make_local_mesh(1, 4, device="cpu"))
    got = tf.moe_ep_shardmap(*map(torch.from_numpy, (x, rw, wg, wu, wd)),
                             cfg, ctx)
    dropped = ~r["keep"].reshape(64)
    assert bool((got[dropped] == 0).all())
    assert bool((got[~dropped] != 0).any(-1).all())


def test_ep_layout_needs_experts_and_shards_to_divide():
    assert tf.ep_layout(128, 4) == (32, 1)
    assert tf.ep_layout(2, 8) == (1, 4)
    with pytest.raises(ValueError, match="do not split"):
        tf.ep_layout(6, 4)


def _policy_log(cfg, ctx, frozen):
    """(op, touches an expert weight, decision) of each product the
    "dots" policy decided in the forward pass of one MoE layer."""
    params = tf.init_params(cfg, seed=0, device="cpu")
    wn = cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff_expert
    log, orig = [], tf._dots_policy

    def policy(c, op, *args, **kw):
        out = orig(c, op, *args, **kw)
        if not c.is_recompute and "mm" in str(op):
            log.append((str(op).split(".")[1], any(
                isinstance(a, torch.Tensor) and a.numel() == wn
                for a in args), out.name))
        return out
    tf._dots_policy = policy
    try:
        pp = {k: v.clone().requires_grad_(not (frozen and k.endswith("_e")))
              for k, v in params.items()}
        toks = torch.randint(0, cfg.vocab, (2, 8),
                             generator=torch.Generator().manual_seed(0))
        tf.lm_loss(pp, toks, toks, cfg, ctx, seq_chunk=8).backward()
    finally:
        tf._dots_policy = orig
    return log


@pytest.mark.parametrize("frozen", [False, True])
def test_dots_policy_saves_what_jax_saves(frozen):
    """The JAX package's "dots" policy saves products without batch dims:
    ``_moe_reference``'s ``"td,edf->tef"`` (twice), the router's and the
    projections', and recomputes the batched ones (its ``"tef,efd->ted"``,
    the combine, the EP path's ``"ecd,edf->ecf"``).  ``x @ wg`` is an
    ``mm`` where matmul folds it (trained experts) and a ``bmm`` of x
    broadcast over the experts where it does not (frozen ones): saved
    either way (which of the two torch takes depends on its version)."""
    cfg = base.reduced(base.get_config("qwen3-moe-r1"), n_layers=1,
                       d_model=32, n_heads=2, n_kv_heads=1, d_head=16,
                       vocab=64, dtype="float32",
                       moe=base.MoEConfig(n_experts=4, top_k=2,
                                          d_ff_expert=12))
    assert cfg.remat_policy == "dots"
    ref = _policy_log(cfg, None, frozen)
    assert sorted(d for _, w, d in ref if w) == [
        "MUST_SAVE", "MUST_SAVE", "PREFER_RECOMPUTE"]
    assert all(d == "MUST_SAVE" for op, w, d in ref if op == "mm")
    ep = _policy_log(cfg, ShardCtx(make_local_mesh(1, 2, device="cpu")),
                     frozen)
    assert [d for _, w, d in ep if w] == ["PREFER_RECOMPUTE"] * 3


def test_moe_forward_and_loss_through_the_mesh_paths():
    """Prefill (EP), decode (psum) and ``lm_loss`` with its gradients on a
    2x2 simulated mesh equal the no-mesh passes while nothing is
    dropped."""
    cfg = base.reduced(base.get_config("qwen3-moe-30b-a3b"),
                       **serve.LM_SMALL, dtype="float32",
                       moe=base.MoEConfig(n_experts=4, top_k=2,
                                          d_ff_expert=32,
                                          capacity_factor=8.0))
    ctx = ShardCtx(make_local_mesh(2, 2, device="cpu"))
    assert (ctx.dp, ctx.tp, ctx.tp_size, ctx.dp_size) == (("data",), "model",
                                                          2, 2)
    params = tf.init_params(cfg, seed=3, device="cpu")
    assert ctx.cons(params["embed"], "model", None) is params["embed"]
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    outs = []
    for c in (None, ctx):
        cache = tf.init_kv_cache(cfg, 2, 20, device="cpu")
        cache, log = tf.prefill(params, toks, cache, cfg, c)
        _, log2 = tf.decode_step(params, cache, toks[:, :1], 16, cfg, c)
        pp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = tf.lm_loss(pp, toks, toks, cfg, c, seq_chunk=16)
        loss.backward()
        outs.append([log, log2, loss.detach()]
                    + [pp[k].grad for k in sorted(pp)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_axis_collectives_keep_the_other_axes():
    x = torch.arange(2 * 3 * 3 * 5, dtype=torch.float32).reshape(2, 3, 3, 5)
    axes = ("data", "model")
    with coll.ScheduleRecorder() as rec:
        a2a = coll.all_to_all_axis(x, axes, "model")
        s = coll.psum_axis(x, axes, "model")
        m = coll.pmean_axis(x, axes, "data")
    for d in range(2):
        for i in range(3):
            for j in range(3):
                assert torch.equal(a2a[d, i, j], x[d, j, i])
                assert torch.equal(s[d, i], x[d].sum(0))
    assert torch.equal(m[1], x.mean(0))
    assert [(r.kind, r.op, r.axes) for r in rec.records] == [
        ("all-to-all", "all_to_all", ("model",)),
        ("all-reduce", "psum", ("model",)),
        ("all-reduce", "pmean", ("data",))]
    with pytest.raises(ValueError, match="blocks"):
        coll.all_to_all_axis(x[:, :, :2], axes, "model")
    with pytest.raises(ValueError, match="stacked axes"):
        coll.psum_axis(x, axes, "pod")


def test_grad_compressors_match_jax():
    rng = np.random.default_rng(4)
    grads = {"a": rng.normal(size=(8, 5)).astype(np.float32),
             "b": rng.normal(size=(33,)).astype(np.float32)}
    res = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1
           for k, v in grads.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    vals, idxs, st = gc.topk_compress(tg, gc.EFState(
        {k: torch.from_numpy(v) for k, v in res.items()}), 0.2)
    rvals, ridxs, rst = r_gc.topk_compress(
        {k: jnp.asarray(v) for k, v in grads.items()},
        r_gc.EFState({k: jnp.asarray(v) for k, v in res.items()}), 0.2)
    dense = gc.topk_decompress(vals, idxs, tg)
    rdense = r_gc.topk_decompress(rvals, ridxs, grads)
    for k in grads:
        assert sorted(idxs[k].tolist()) == sorted(np.asarray(ridxs[k]))
        np.testing.assert_array_equal(dense[k].numpy(), np.asarray(rdense[k]))
        np.testing.assert_array_equal(st.residual[k].numpy(),
                                      np.asarray(rst.residual[k]))
    grads["c"] = np.array([0.5, -1.5, 2.5, 127.0, -0.25], np.float32)
    tg["c"] = torch.from_numpy(grads["c"])
    qs, ss = gc.int8_quantize(tg)
    rqs, rss = r_gc.int8_quantize({k: jnp.asarray(v)
                                   for k, v in grads.items()})
    back = gc.int8_dequantize(qs, ss, tg)
    rback = r_gc.int8_dequantize(rqs, rss, grads)
    for k in grads:
        assert qs[k].dtype == torch.int8
        np.testing.assert_array_equal(qs[k].numpy(), np.asarray(rqs[k]))
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(rback[k]))
    # half to even, as jnp.round: the scale 1.0 makes codes of the values
    assert qs["c"].tolist() == [0, -2, 2, 127, 0]
    ef = gc.ef_init(tg)
    assert all(r.dtype == torch.float32 and not r.any()
               for r in ef.residual.values())


def test_init_params_layer_by_layer_keeps_the_first_layers():
    """A config cut in depth draws the same first layers as the full
    one, every stacked tensor holds its layers' draws, and the norms
    are ones."""
    cfg = serve.reduced_lm(base.get_config("mixtral-8x22b"))
    cut = dataclasses.replace(cfg, n_layers=1)
    full, part = (tf.init_params(c, seed=7, device="cpu") for c in (cfg,
                                                                    cut))
    assert list(full) == ["embed", "final_ln", *tf.layer_keys(cfg)]
    for k, v in part.items():
        want = full[k] if k in ("embed", "final_ln") else full[k][:1]
        assert torch.equal(v, want), k
    assert not torch.equal(full["wg_e"][0], full["wg_e"][1])
    assert bool((full["ln1"] == 1).all())
    std = float(full["wg_e"].float().std())
    assert 0.9 < std * cfg.d_model ** 0.5 < 1.1


@pytest.mark.parametrize("launcher", [serve, train])
def test_full_launch_refuses_a_model_larger_than_the_device(
        launcher, monkeypatch):
    monkeypatch.setattr(serve, "device_bytes", lambda dev: 80 * 10 ** 9)
    args = ["--arch", "mixtral-8x22b", "--full", "--device", "cpu"]
    with pytest.raises(SystemExit, match="280.9 GB .* 80.0 GB"):
        launcher.main(args)
