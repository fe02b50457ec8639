"""The port's recsys serving slice against the JAX package on numpy
inputs made from a seed: configs and table layout, the data pipeline,
the embedding lookup (through kernel 8's plain version on the CPU) and
the AutoInt scorer with the JAX parameters carried across by
``params_from_jax``.

Tolerances: configs, batches and the lookup are exact; multi-hot bags
agree within the JAX kernel test's rtol = atol = 1e-6; the AutoInt
outputs within rtol = atol = 1e-5 in float32 (the same einsums,
softmax and matmuls, summed in another order by another library)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.data import pipeline as jax_pipe
from repro.models import autoint as jax_ai
from repro.models import embedding as jax_emb
from repro.models.common import ShardCtx
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch import serve
from repro_torch.models import embedding
from repro_torch.models.autoint import AutoInt, params_from_jax
from _torch_threads import one_thread  # noqa: F401

CTX = ShardCtx(mesh=None)
SMALL = dict(n_sparse=8, embed_dim=8, n_attn_layers=2, n_heads=2, d_attn=8,
             vocab_sizes=tuple([50] * 8), mlp_hidden=(32,))


SERVING_ARCHS = ["autoint", "mixtral-8x22b", "qwen3-moe-30b-a3b",
                 "qwen3-moe-r1", "qwen3-moe-r2", "qwen3-moe-r3",
                 "qwen3-moe-r4", "smollm-135m", "stablelm-3b",
                 "starcoder2-7b"]


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_configs_equal_the_jax_ones(arch):
    assert dataclasses.asdict(base.get_config(arch)) \
        == dataclasses.asdict(jax_base.get_config(arch))
    # the serving archs the port runs; the bfs-rmat and GNN archs sit
    # beside them
    assert [a for a in base.list_archs() if not a.startswith("bfs-rmat")
            and base.get_config(a).kind != "gnn"] == SERVING_ARCHS


def test_unported_arch_is_named():
    """Every arch of the JAX package is ported (the GNN archs last); a
    name the registry lacks is refused with the archs it has."""
    assert set(base.list_archs()) == set(jax_base.list_archs())
    with pytest.raises(KeyError, match="not ported yet.*gat-cora"):
        base.get_config("no-such-arch")


def test_full_autoint_table_meta():
    cfg, jcfg = base.get_config("autoint"), jax_base.get_config("autoint")
    offs, total = embedding.table_meta(cfg)
    joffs, jtotal = jax_emb.table_meta(jcfg)
    np.testing.assert_array_equal(offs, joffs)
    assert total == jtotal == 11_238_400
    assert cfg.n_embed_rows() == 11_238_000


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 0), (5, 7)])
def test_batches_are_bit_identical(step, seed):
    cfg, jcfg = base.get_config("autoint"), jax_base.get_config("autoint")
    a = pipeline.recsys_batch(cfg, 64, step, seed)
    b = jax_pipe.recsys_batch(jcfg, 64, step, seed)
    for k in ("idx", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    lcfg = base.get_config("smollm-135m")
    a = pipeline.lm_batch(lcfg, 4, 33, step, seed)
    b = jax_pipe.lm_batch(jax_base.get_config("smollm-135m"), 4, 33, step,
                          seed)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
    stream = pipeline.step_stream(lambda s: pipeline.recsys_batch(cfg, 8, s),
                                  start_step=step)
    np.testing.assert_array_equal(next(stream)["idx"],
                                  pipeline.recsys_batch(cfg, 8, step)["idx"])


def _models():
    jcfg = jax_base.reduced(jax_base.get_config("autoint"), **SMALL)
    cfg = base.reduced(base.get_config("autoint"), **SMALL)
    jp = jax_ai.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(cfg, {k: np.asarray(v) for k, v in jp.items()},
                            device="cpu")
    idx = np.random.default_rng(0).integers(0, 50, (16, 8)).astype(np.int32)
    return jcfg, jp, model, idx


def test_lookup_equals_jax_lookup_exactly():
    jcfg, jp, model, idx = _models()
    rows = jax_emb.flat_indices(jcfg, jnp.asarray(idx))
    want = np.asarray(jax_emb.lookup(jp["table"], rows, CTX))
    got = model.embed(torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        embedding.flat_indices(model.cfg, torch.from_numpy(idx)).numpy(),
        np.asarray(rows))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multi_hot_embedding_bag_matches_jax(mode, weighted):
    """The multi-hot entry point against the JAX package's, through its
    Pallas kernel (interpret mode) and its jnp path, within the JAX
    kernel test's float32 tolerance."""
    rng = np.random.default_rng(11)
    table = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(-1, 300, (128, 6)).astype(np.int32)
    ids[::7] = -1
    w = rng.random((128, 6)).astype(np.float32) if weighted else None
    got = embedding.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), mode=mode).numpy()
    for use_kernel in (True, False):
        want = jax_emb.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids),
            None if w is None else jnp.asarray(w), mode=mode, ctx=CTX,
            use_kernel=use_kernel)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_autoint_matches_jax():
    jcfg, jp, model, idx = _models()
    t_idx = torch.from_numpy(idx)
    e = jax_emb.lookup(jp["table"], jax_emb.flat_indices(jcfg, idx), CTX)
    with torch.inference_mode():
        got = {"interact": model.interact(model.embed(t_idx)),
               "forward": model(t_idx),
               "user_tower": model.user_tower(t_idx[:3])}
        cand = np.random.default_rng(1).normal(size=(100, 16)).astype(
            np.float32)
        got["retrieval"] = AutoInt.retrieval_scores(got["user_tower"],
                                                    torch.from_numpy(cand))
    want = {"interact": jax_ai.interact(jp, jcfg, e),
            "forward": jax_ai.forward(jp, jcfg, jnp.asarray(idx), CTX),
            "user_tower": jax_ai.user_tower(jp, jcfg, jnp.asarray(idx[:3]),
                                            CTX)}
    want["retrieval"] = jax_ai.retrieval_scores(want["user_tower"],
                                                jnp.asarray(cand), CTX)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_params_from_jax_rejects_other_names():
    _, jp, model, _ = _models()
    params = {k: np.asarray(v) for k, v in jp.items() if k != "wq0"}
    with pytest.raises(KeyError):
        params_from_jax(model.cfg, params, device="cpu")


def test_serve_launcher_scores_on_cpu(capsys):
    serve.main(["--arch", "autoint", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("scored batch of 32: mean p(click)=")
    assert 0.0 < float(line.split("=")[1]) < 1.0
