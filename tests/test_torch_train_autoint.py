"""AutoInt training on the CPU against the JAX package: ``bce_loss`` and
every parameter's gradient, the table's included, on the reduced AutoInt
of the JAX launcher (``launch/train.py``: 8 fields of 100 rows, d 8, 2
attention layers of 2 heads of 8, MLP 32), batches of 64 from
``recsys_batch``; the plain version of kernel 8b against ``jax.grad`` of
the JAX package's ``embedding_bag`` (sum, mean, weights, pads), and its
launch prep against a loop.

Tolerances: float32 rtol 1e-4, atol 1e-6 (the same float32 math in
another order); kernel 8b's plain version against the JAX gradient rtol
1e-6, atol 1e-7 (each row's terms summed in another order); against the
loop, 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import autoint as r_ai
from repro.models.common import ShardCtx
from repro.models.embedding import embedding_bag as r_embedding_bag
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import recsys_batch
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.models import autoint as ai
from repro_torch.models import embedding

_SMALL = dict(n_sparse=8, embed_dim=8, n_attn_layers=2, n_heads=2, d_attn=8,
              vocab_sizes=tuple([100] * 8), mlp_hidden=(32,))


@pytest.fixture(scope="module")
def setup():
    rcfg = r_reduced(r_get_config("autoint"), **_SMALL)
    cfg = reduced(get_config("autoint"), **_SMALL)
    p = r_ai.init_params(rcfg, jax.random.PRNGKey(0))
    model = ai.params_from_jax(cfg, {k: np.asarray(v) for k, v in p.items()},
                               device="cpu", trainable=True)
    return rcfg, cfg, p, model


@pytest.mark.parametrize("step", [0, 3])
def test_bce_loss_and_grads_match_reference(setup, step):
    rcfg, cfg, p, model = setup
    b = recsys_batch(cfg, 64, step)
    loss_r, g_r = jax.value_and_grad(lambda q: r_ai.bce_loss(
        q, rcfg, jnp.asarray(b["idx"]), jnp.asarray(b["labels"]),
        ShardCtx(mesh=None)))(p)
    params = model.params()
    assert all(t.requires_grad for t in params.values())
    loss = ai.bce_loss(params, cfg, torch.from_numpy(b["idx"]),
                       torch.from_numpy(b["labels"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
    assert sorted(params) == sorted(g_r)
    for k, g in zip(params, grads):
        assert g.shape == g_r[k].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the table's gradient is dense and lands on the rows the batch read
    gt = dict(zip(params, grads))["table"]
    read = torch.unique(embedding.flat_indices(cfg, torch.from_numpy(
        b["idx"])))
    touched = torch.nonzero(gt.abs().sum(1)).squeeze(1)
    assert set(touched.tolist()) <= set(read.tolist())


def test_serving_model_stays_frozen():
    cfg = reduced(get_config("autoint"), **_SMALL)
    model = ai.AutoInt(cfg, device="cpu")
    assert not any(t.requires_grad for t in model.params().values())
    idx = torch.from_numpy(recsys_batch(cfg, 8, 0)["idx"])
    with torch.inference_mode():
        out = model(idx)
    assert out.shape == (8,)
    trained = ai.AutoInt(cfg, device="cpu", trainable=True)
    assert torch.equal(trained(idx).detach(), out)


def _bags(seed, n_bags=6, width=5, n_rows=20):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_rows, (n_bags, width)).astype(np.int32)
    ids[0] = -1                                 # a bag of pads only
    w = rng.uniform(0.1, 2.0, (n_bags, width)).astype(np.float32)
    table = rng.normal(size=(n_rows, 4)).astype(np.float32)
    gout = rng.normal(size=(n_bags, 4)).astype(np.float32)
    return ids, w, table, gout


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_backward_matches_jax_grad(mode, weighted):
    ids, w, table, gout = _bags(1)
    wt = w if weighted else None
    _, vjp = jax.vjp(lambda t: r_embedding_bag(
        t, jnp.asarray(ids), None if wt is None else jnp.asarray(wt),
        mode=mode), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(gout))[0])
    got = eb_ops.embedding_bag_backward(
        torch.from_numpy(gout), torch.from_numpy(ids), table.shape[0],
        None if wt is None else torch.from_numpy(wt), mode)
    assert got.shape == table.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # through the model's lookup: the same gradient by autograd
    tt = torch.from_numpy(table).requires_grad_(True)
    out = embedding.embedding_bag(tt, torch.from_numpy(ids),
                                  None if wt is None else torch.from_numpy(wt),
                                  mode)
    (g,) = torch.autograd.grad(out, tt, torch.from_numpy(gout))
    assert torch.equal(g, got)


def test_embedding_bag_backward_bf16_and_clamp_against_a_loop():
    """bf16 dout: float32 sums, one rounding; ids past the table land on
    its last row, as the forward reads it; pads add nothing."""
    ids, w, _, gout = _bags(2, n_rows=30)
    ids[1, 0] = 45                              # past the table
    n_rows = 20
    for mode in ("sum", "mean"):
        for wt in (None, torch.from_numpy(w)):
            g = torch.from_numpy(gout).to(torch.bfloat16)
            got = eb_ops.embedding_bag_backward(g, torch.from_numpy(ids),
                                                n_rows, wt, mode)
            den = eb_ref.bag_denominators(torch.from_numpy(ids), wt)
            want = torch.zeros(n_rows, 4)
            for b in range(ids.shape[0]):
                for j in range(ids.shape[1]):
                    if ids[b, j] < 0:
                        continue
                    x = g[b].float()
                    if mode == "mean":
                        x = x / den[b]
                    if wt is not None:
                        x = wt[b, j] * x
                    want[min(int(ids[b, j]), n_rows - 1)] += x
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, want.to(torch.bfloat16)), (mode, wt)


def test_backward_prep_against_a_loop():
    ids, w, _, _ = _bags(3, n_bags=9, width=4, n_rows=12)
    ids[2, 1] = 40
    prep = eb_ops.prepare_backward(torch.from_numpy(ids),
                                   torch.from_numpy(w), "mean", 12)
    terms = {}
    for b in range(ids.shape[0]):
        for j in range(ids.shape[1]):
            if ids[b, j] >= 0:
                terms.setdefault(min(int(ids[b, j]), 11), []).append((b, j))
    rows = sorted(terms)
    assert prep.seg_rows.tolist() == rows
    assert prep.seg_rows.dtype == prep.seg_off.dtype == torch.int32
    counts = [len(terms[r]) for r in rows]
    assert prep.seg_off.tolist() == list(np.concatenate([[0],
                                                         np.cumsum(counts)]))
    flat = [t for r in rows for t in terms[r]]     # flat order in a row
    assert prep.bags.tolist() == [b for b, _ in flat]
    assert prep.weights.tolist() == [float(w[b, j]) for b, j in flat]
    assert torch.equal(prep.den, eb_ref.bag_denominators(
        torch.from_numpy(ids), torch.from_numpy(w)))
    plain = eb_ops.prepare_backward(torch.from_numpy(ids), None, "sum", 12)
    assert plain.weights is None and plain.den is None
