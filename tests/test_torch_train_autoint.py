"""AutoInt training on the CPU against the JAX package: ``bce_loss`` and
every parameter's gradient, the table's included, on the reduced AutoInt
of the JAX launcher (``launch/train.py``: 8 fields of 100 rows, d 8, 2
attention layers of 2 heads of 8, MLP 32), batches of 64 from
``recsys_batch``; the plain version of kernel 8b against ``jax.grad`` of
the JAX package's ``embedding_bag`` (sum, mean, weights, pads), and the
plain twin of its launch prep (keys, sort, tile ranges) against a loop.

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
from _torch_threads import one_thread  # noqa: F401

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


def _terms_by_row(ids, n_rows):
    """{row: [(b, j), ...]}: each live term under the row it lands on, in
    flat order."""
    terms = {}
    for b in range(ids.shape[0]):
        for j in range(ids.shape[1]):
            if ids[b, j] >= 0:
                terms.setdefault(min(int(ids[b, j]), n_rows - 1),
                                 []).append((b, j))
    return terms


def test_backward_keys_against_a_loop():
    """The key kernel's plain twin: each term's row clamped to n_rows - 1,
    the sentinel n_rows for a pad, in flat order; the "mean" divisors bit
    for bit those of ``ref.bag_denominators``; ``prepare_backward`` on CPU
    tensors is the plain twins' keys, sorted."""
    ids, w, _, _ = _bags(3, n_bags=9, width=4, n_rows=12)
    ids[2, 1] = 40
    ids[4, 3] = 12                               # one past the table
    tid, tw = torch.from_numpy(ids), torch.from_numpy(w)
    keys, den = eb_ops.backward_keys_plain(tid, tw, "mean", 12)
    want = [12 if i < 0 else min(int(i), 11) for i in ids.reshape(-1)]
    assert keys.dtype == torch.int32 and keys.tolist() == want
    assert den.dtype == torch.float32
    assert torch.equal(den, eb_ref.bag_denominators(tid, tw))
    assert torch.equal(eb_ops.backward_keys_plain(tid, None, "mean", 12)[1],
                       eb_ref.bag_denominators(tid, None))
    assert den[0] == np.float32(1e-9)            # the bag of pads only
    keys_sum, den_sum = eb_ops.backward_keys_plain(tid, None, "sum", 12)
    assert torch.equal(keys_sum, keys) and den_sum is None
    prep = eb_ops.prepare_backward(tid, tw, "mean", 12)
    sorted_keys, pos = eb_ops.sort_keys_plain(keys)
    assert torch.equal(prep.keys, sorted_keys)
    assert torch.equal(prep.pos, pos) and prep.pos.dtype == torch.int32
    for got, want in zip(eb_ops.sort_keys(keys, 12), (sorted_keys, pos)):
        assert torch.equal(got, want)
    assert torch.equal(prep.den, den) and prep.weights is tw


@pytest.mark.parametrize("weighted", [False, True])
def test_backward_sort_keeps_flat_order_within_a_row(weighted):
    """After the stable sort each row's terms lie together in flat order,
    the rows ascending and the pads (key n_rows) last; a term's weight is
    read at its flat position."""
    ids, w, _, _ = _bags(4, n_bags=11, width=5, n_rows=7)
    ids[3, 2] = 30
    wt = torch.from_numpy(w) if weighted else None
    prep = eb_ops.prepare_backward(torch.from_numpy(ids), wt, "sum", 7)
    terms = _terms_by_row(ids, 7)
    flat = [(r, b, j) for r in sorted(terms) for b, j in terms[r]]
    n_live = len(flat)
    assert prep.keys.tolist()[:n_live] == [r for r, _, _ in flat]
    assert prep.keys.tolist()[n_live:] == [7] * (ids.size - n_live)
    assert prep.pos.tolist()[:n_live] == [b * 5 + j for _, b, j in flat]
    pads = prep.pos.tolist()[n_live:]
    assert pads == sorted(pads) and all(ids.reshape(-1)[pads] < 0)
    assert prep.width == 5 and prep.den is None
    if weighted:
        got = prep.weights.reshape(-1)[prep.pos[:n_live]].tolist()
        assert got == [float(w[b, j]) for _, b, j in flat]
    else:
        assert prep.weights is None


@pytest.mark.parametrize("items", [1, 3, 50])
def test_backward_tile_bounds_against_a_loop(items):
    """The tiles, the gradient kernel's blocks: the row marks (row 12 the
    end) and the terms in one sequence, a row's mark before its terms;
    tile b owns the rows whose marks lie in [b * items, (b + 1) * items)
    and their terms.  At one place a tile, three, and past all of them;
    a tile has at most ``items`` rows, and at most ``items`` terms but
    its last row's."""
    ids, w, _, _ = _bags(5, n_bags=9, width=4, n_rows=12)
    ids[1, 1] = 50
    ids[6] = 4                                   # a row of many terms
    prep = eb_ops.prepare_backward(torch.from_numpy(ids),
                                         torch.from_numpy(w), "mean", 12)
    got = eb_ops.tile_bounds_plain(prep.keys, 12, items)
    assert got.dtype == torch.int32
    assert torch.equal(eb_ops.tile_bounds(prep.keys, 12, items), got)
    terms = _terms_by_row(ids, 12)
    count = [len(terms.get(r, [])) for r in range(13)]
    marks = [r + sum(count[:r]) for r in range(13)]
    n_tiles = -(-(13 + ids.size) // items)
    assert eb_ops.n_tiles(ids.size, 12, items) == n_tiles
    want = []
    for b in range(n_tiles + 1):
        first = next((r for r in range(13) if marks[r] >= b * items), 12)
        want.append([first, sum(count[:first])])
    assert got.tolist() == want
    for (r0, k0), (r1, k1) in zip(want, want[1:]):
        assert r1 - r0 <= items
        assert k1 - k0 <= items or k1 - k0 - count[r1 - 1] <= items


@pytest.mark.parametrize("dim,elt,want", [
    (16, 4, 480), (16, 2, 480), (64, 2, 120), (7, 4, 1024), (1, 4, 1024),
    (1100, 4, 7)])
def test_backward_tile_items(dim, elt, want):
    """A tile's rows plus terms: 15/16 of the terms a block stages, each
    a slice of ``lanes * vec`` floats, at most MAX_ITEMS."""
    vec, lanes = eb_ops.layout(dim, elt, True)
    items = eb_ops.tile_items(vec, lanes)
    assert items == want and items <= eb_ops.MAX_ITEMS
    assert items * lanes * vec <= eb_ops.STAGE_FLOATS
