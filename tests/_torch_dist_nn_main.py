"""Subprocess entry: the port's NN exchanges on the simulated mesh against
the JAX package's shard_map functions on 8 forced host devices, every
case in one process.

- ``moe_ep_shardmap`` on a (2, 4) ("data", "model") mesh: E = 8 top-2
  (experts split over "model") and E = 2 top-1 (each expert co-owned by
  two shards, ``tp_sub`` 2), with generous capacity; then each at
  ``capacity_factor`` 1.0 with a router skewed so that queues overflow.
  In those, expert e's down-projection writes only its own block of
  output columns, so the JAX output shows which (token, expert) pairs it
  kept; the port's keep mask (``ep_route``) must be the same set.
- ``moe_decode_psum`` on the same mesh.
- ``embedding.lookup`` with the table's rows over "model", exactly.
- 5 steps of ``make_dp_compressed_step`` in each mode on a 4-replica
  "data" mesh: losses, params and replica 0's error-feedback residual.

Float32 throughout; values within rtol = atol = 1e-5 (the same float32
math summed in another order), keep masks and lookups exact.  Each port
case also runs under a ``ScheduleRecorder``: 2 tp_sub all_to_alls an EP
call, one psum a decode call and a lookup, and a pmean a leaf and one
for the loss a data-parallel step.

Run as:  python tests/_torch_dist_nn_main.py
(sets XLA_FLAGS before importing jax).  Prints one JSON line of the
cases' results, then ``OK torch-dist-nn (N cases)``.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import LMConfig as RLMConfig  # noqa: E402
from repro.configs.base import MoEConfig as RMoEConfig  # noqa: E402
from repro.configs.base import RecsysConfig as RRecsysConfig  # noqa: E402
from repro.models import embedding as r_emb  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro.models.common import ShardCtx as RShardCtx  # noqa: E402
from repro.optim.adamw import SGDM as RSGDM  # noqa: E402
from repro.optim import dp_step as r_dp  # noqa: E402
from repro_torch.configs.base import LMConfig, MoEConfig  # noqa: E402
from repro_torch.configs.base import RecsysConfig  # noqa: E402
from repro_torch.core.collectives import ScheduleRecorder  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d  # noqa: E402,E501
from repro_torch.models import embedding  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import ShardCtx  # noqa: E402
from repro_torch.optim import dp_step  # noqa: E402
from repro_torch.optim.adamw import SGDM  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D, F, T = 32, 16, 512          # d_model, d_ff_expert, tokens (64 a shard)
MESH = jax.make_mesh((2, 4), ("data", "model"))
RCTX = RShardCtx(mesh=MESH)
CTX = ShardCtx(mesh=make_local_mesh(2, 4, device="cpu"))


def moe_cfgs(n_experts, top_k, cf):
    kw = dict(arch="t", family="moe", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, d_ff=F, vocab=64)
    moe = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=F,
               capacity_factor=cf)
    return (RLMConfig(**kw, moe=RMoEConfig(**moe)),
            LMConfig(**kw, moe=MoEConfig(**moe)))


def moe_inputs(n_experts, skew, blocks, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    rw = (rng.normal(size=(D, n_experts)) * 0.1).astype(np.float32)
    if skew:                   # experts 0 and 1 favoured: queues overflow
        x[:, 0] += 1.0
        rw[0, :2] += (0.6, 0.4)
    wg = (rng.normal(size=(n_experts, D, F)) * 0.2).astype(np.float32)
    wu = (rng.normal(size=(n_experts, D, F)) * 0.2).astype(np.float32)
    wd = (rng.normal(size=(n_experts, F, D)) * 0.2).astype(np.float32)
    if blocks:                 # expert e writes columns [e w, (e+1) w)
        w = D // n_experts
        for e in range(n_experts):
            wd[e, :, :e * w] = 0.0
            wd[e, :, (e + 1) * w:] = 0.0
    return x, rw, wg, wu, wd


def port_keep(x, rw, cfg, capacity_mult):
    """The port's kept (token, expert) pairs, (T, E) bool."""
    n_dev, tp = 8, 4
    cap = tf.ep_capacity(T // n_dev, cfg, tp, capacity_mult)
    r = tf.ep_route(torch.from_numpy(x).reshape(n_dev, T // n_dev, D),
                    torch.from_numpy(rw), cfg, tp, cap)
    choice = r["choice"].reshape(T, -1)
    keep = r["keep"].reshape(T, -1)
    out = torch.zeros(T, cfg.moe.n_experts, dtype=torch.bool)
    out[torch.arange(T)[:, None].expand_as(choice)[keep], choice[keep]] = True
    return out.numpy(), cap


def moe_case(name, n_experts, top_k, cf, capacity_mult, skew, seed):
    rcfg, cfg = moe_cfgs(n_experts, top_k, cf)
    x, rw, wg, wu, wd = moe_inputs(n_experts, skew, skew, seed)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(MESH, P(("data", "model"), None)))
    want = np.asarray(jax.jit(lambda *a: r_tf.moe_ep_shardmap(
        *a, rcfg, RCTX, capacity_mult=capacity_mult))(
        xs, *map(jnp.asarray, (rw, wg, wu, wd))))
    args = [torch.from_numpy(a) for a in (x, rw, wg, wu, wd)]
    with ScheduleRecorder() as rec:
        got = tf.moe_ep_shardmap(*args, cfg, CTX,
                                 capacity_mult=capacity_mult).numpy()
    np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    keep, cap = port_keep(x, rw, cfg, capacity_mult)
    res = {"counts": rec.counts(), "cap": cap,
           "kept": int(keep.sum()), "pairs": T * top_k,
           "max_err": float(np.abs(got - want).max())}
    if skew:
        w = D // n_experts
        jax_keep = np.stack([np.any(want[:, e * w:(e + 1) * w] != 0, axis=1)
                             for e in range(n_experts)], axis=1)
        res["keep_equal"] = bool(np.array_equal(keep, jax_keep))
    else:
        ref = tf._moe_reference(*args, cfg).numpy()
        np.testing.assert_allclose(got, ref, **TOL, err_msg=name)
    return res


def decode_case():
    rcfg, cfg = moe_cfgs(8, 2, 1.25)
    x, rw, wg, wu, wd = moe_inputs(8, False, False, 5)
    x = x[:16]
    want = np.asarray(jax.jit(lambda *a: r_tf.moe_decode_psum(
        *a, rcfg, RCTX))(*map(jnp.asarray, (x, rw, wg, wu, wd))))
    args = [torch.from_numpy(a) for a in (x, rw, wg, wu, wd)]
    with ScheduleRecorder() as rec:
        got = tf.moe_decode_psum(*args, cfg, CTX).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return {"counts": rec.counts(),
            "max_err": float(np.abs(got - want).max())}


def lookup_case():
    kw = dict(arch="t", n_sparse=4, embed_dim=8, n_attn_layers=1, n_heads=1,
              d_attn=8, vocab_sizes=(100, 200, 300, 424))
    rcfg, cfg = RRecsysConfig(**kw), RecsysConfig(**kw)
    table = np.array(r_emb.init_table(rcfg, jax.random.PRNGKey(1)))
    idx = np.random.default_rng(0).integers(0, 100, (16, 4)).astype(np.int32)
    rows = np.asarray(r_emb.flat_indices(rcfg, jnp.asarray(idx)))
    ts = jax.device_put(jnp.asarray(table), NamedSharding(MESH,
                                                          P("model", None)))
    want = np.asarray(jax.jit(lambda a, b: r_emb.lookup(a, b, RCTX))(
        ts, jnp.asarray(rows)))
    t_rows = embedding.flat_indices(cfg, torch.from_numpy(idx))
    with ScheduleRecorder() as rec:
        got = embedding.lookup(torch.from_numpy(table), t_rows, CTX).numpy()
    plain = embedding.lookup(torch.from_numpy(table), t_rows).numpy()
    ids = np.where(np.arange(64).reshape(16, 4) % 5 == 0, -1,
                   rows)                     # multi-hot bags with pads
    bag = embedding.embedding_bag(torch.from_numpy(table),
                                  torch.from_numpy(ids), ctx=CTX).numpy()
    bag_plain = embedding.embedding_bag(torch.from_numpy(table),
                                        torch.from_numpy(ids)).numpy()
    bag_want = np.asarray(jax.jit(lambda a, b: r_emb.embedding_bag(
        a, b, ctx=RCTX))(ts, jnp.asarray(ids)))
    np.testing.assert_allclose(bag, bag_want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bag, bag_plain, rtol=1e-6, atol=1e-6)
    return {"counts": rec.counts(), "equal_jax": bool(np.array_equal(
        got, want)), "equal_no_mesh": bool(np.array_equal(got, plain))}


def dp_cases(steps=5):
    n = 4
    rmesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
    mesh = make_local_mesh_1d(n, device="cpu")
    rng = np.random.default_rng(0)
    w_true = (rng.normal(size=(16, 1)) * 0.3).astype(np.float32)
    xs = [rng.normal(size=(n * 8, 16)).astype(np.float32)
          for _ in range(steps)]
    ropt, opt = RSGDM(lr=0.02, momentum=0.8), SGDM(lr=0.02, momentum=0.8)

    def r_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    out = {}
    sh = NamedSharding(rmesh, P("data"))
    for mode in dp_step.MODES:
        rstep = r_dp.make_dp_compressed_step(r_loss, ropt, rmesh, "data",
                                             mode=mode, ratio=0.25)
        step = dp_step.make_dp_compressed_step(loss, opt, mesh, "data",
                                               mode=mode, ratio=0.25)
        rstate = r_dp.init_dp_state({"w": jnp.zeros((16, 1))}, ropt)
        state = dp_step.init_dp_state({"w": torch.zeros(16, 1)}, opt, mesh)
        rlosses, losses = [], []
        for x in xs:
            y = x @ w_true
            rstate, rm = rstep(rstate, {
                "x": jax.device_put(jnp.asarray(x), sh),
                "y": jax.device_put(jnp.asarray(y), sh)})
            with ScheduleRecorder() as rec:
                state, m = step(state, {"x": torch.from_numpy(x),
                                        "y": torch.from_numpy(y)})
            rlosses.append(float(rm["loss"]))
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses, rlosses, **TOL, err_msg=mode)
        np.testing.assert_allclose(state[0]["w"].numpy(),
                                   np.asarray(rstate[0]["w"]), **TOL,
                                   err_msg=mode)
        np.testing.assert_allclose(state[1]["w"].numpy(),
                                   np.asarray(rstate[1]["w"]), **TOL,
                                   err_msg=mode)
        res0 = state[2].residual["w"]
        assert res0.shape == (n, 16, 1), res0.shape
        np.testing.assert_allclose(res0[0].numpy(),
                                   np.asarray(rstate[2].residual["w"]),
                                   **TOL, err_msg=mode)
        out[f"dp_{mode}"] = {
            "counts": rec.counts(), "losses": losses,
            "residual_nonzero": bool((res0 != 0).any()),
            "replicas_differ": bool(not torch.equal(res0[0], res0[1]))}
    return out


def main():
    res = {
        "moe_ep_e8": moe_case("e8", 8, 2, 8.0, 4.0, False, 0),
        "moe_ep_e2": moe_case("e2", 2, 1, 8.0, 4.0, False, 1),
        "moe_ep_e8_drops": moe_case("e8 drops", 8, 2, 1.0, 1.0, True, 2),
        "moe_ep_e2_drops": moe_case("e2 drops", 2, 1, 1.0, 1.0, True, 3),
        "moe_decode": decode_case(),
        "lookup": lookup_case(),
        **dp_cases(),
    }
    print(json.dumps(res))
    print(f"OK torch-dist-nn ({len(res)} cases)")


if __name__ == "__main__":
    main()
