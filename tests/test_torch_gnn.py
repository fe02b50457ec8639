"""The port's GIN, GAT and MeshGraphNet (``models/gnn.py``) against the
JAX package's ``models/gnn.py``: forward outputs, losses and gradients on
``full_graph_sm`` and ``molecule`` at ``reduce_to=16``, built as the JAX
package's ``tests/test_models.py`` builds them, with the JAX parameters
carried across by ``params_from_jax``.  Each JAX reference (the init,
the forward, the loss and its gradients) is computed once for the
module, in one ``jax.jit`` a case.  MeshGraphNet runs 4 of its 15
processor layers (the same layer code repeated), which keeps its compile
short.

Tolerances (float32): outputs and losses within 1e-5 of the largest JAX
value plus 1e-6; gradients within 1e-4 of the largest plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.graph.datasets import build_gnn_batch as r_build_gnn_batch
from repro.models import gnn as rg
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced
from repro_torch.models import gnn as tg
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("gin-tu", "gat-cora", "meshgraphnet")
SHAPES = ("full_graph_sm", "molecule")
FWD, GRAD = 1e-5, 1e-4
MGN_LAYERS = 4


def get_config(arch):
    cfg = t_get_config(arch)
    return reduced(cfg, n_layers=MGN_LAYERS) if arch == "meshgraphnet" \
        else cfg


def ref_config(arch):
    cfg = r_get_config(arch)
    return r_reduced(cfg, n_layers=MGN_LAYERS) if arch == "meshgraphnet" \
        else cfg


def close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = rel * np.abs(want).max() + 1e-6
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def _losses(shape_kind, arch, mod, xp):
    def loss_fn(apply, p, b):
        out = apply(p, b)
        if shape_kind == "batched":
            return mod.graph_readout_xent(out, b["graph_ids"], b["labels"],
                                          int(b["labels"].shape[0]))
        if arch == "meshgraphnet":
            return xp.mean((out[:, :3] - b["targets"]) ** 2)
        return mod.node_xent(out, b["labels"], xp.ones(out.shape[0]))
    return loss_fn


@pytest.fixture(scope="module")
def cases():
    """(arch, shape) -> (numpy batch, numpy JAX params, JAX out, loss,
    grads)."""
    out = {}
    for arch in ARCHS:
        cfg = ref_config(arch)
        for shape_name in SHAPES:
            shape = next(s for s in cfg.shapes if s.name == shape_name)
            b = r_build_gnn_batch(cfg, shape, reduce_to=16, seed=1)
            bj = {k: jnp.asarray(v) for k, v in b.items()}
            init, apply = rg.build_gnn_apply(cfg, b["x"].shape[1],
                                             cfg.n_classes)
            loss_fn = _losses(shape.kind, arch, rg, jnp)

            def ref(key, bj, init=init, apply=apply, loss_fn=loss_fn):
                p = init(key)
                return p, apply(p, bj), jax.value_and_grad(
                    lambda q: loss_fn(apply, q, bj))(p)
            p, y, (loss, g) = jax.jit(ref)(jax.random.PRNGKey(0), bj)
            np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}
            out[arch, shape_name] = (b, np_(p), np.asarray(y), float(loss),
                                     np_(g), shape.kind)
    return out


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(cases, arch, shape_name):
    b_np, p_np, y_ref, loss_ref, g_ref, kind = cases[arch, shape_name]
    cfg = get_config(arch)
    b = {k: torch.from_numpy(v) for k, v in b_np.items()}
    _, apply = tg.build_gnn_apply(cfg, b["x"].shape[1], cfg.n_classes)
    p = {k: v.requires_grad_(True)
         for k, v in tg.params_from_jax(cfg, p_np).items()}
    close(apply(p, b), y_ref, FWD)
    loss = _losses(kind, arch, tg, torch)(apply, p, b)
    close(loss, np.float32(loss_ref), FWD)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert set(p) == set(g_ref)
    for k, g in zip(p, grads):
        close(g, g_ref[k], GRAD)


def test_gin_eps_is_a_0d_parameter_carried_across(cases):
    _, p_np, *_ = cases["gin-tu", "full_graph_sm"]
    cfg = get_config("gin-tu")
    p = tg.params_from_jax(cfg, p_np)
    assert p["eps0"].shape == () and p_np["eps0"].shape == ()
    own = tg.init_gin(cfg, 16, cfg.n_classes)
    assert set(own) == set(p)
    assert all(own[k].shape == () for k in own if k.startswith("eps"))
    with pytest.raises(KeyError, match="eps0"):
        tg.params_from_jax(cfg, {k: v for k, v in p_np.items()
                                 if k != "eps0"})


def test_gat_init_keeps_a_src_equal_to_a_dst(cases):
    """The JAX ``init_gat`` draws both from one key, so they are equal;
    the port's init keeps that."""
    cfg = get_config("gat-cora")
    _, rp, *_ = cases["gat-cora", "molecule"]
    p = tg.init_gat(cfg, 16, cfg.n_classes, seed=3)
    for l in range(cfg.n_layers):
        assert np.array_equal(rp[f"a_src{l}"], rp[f"a_dst{l}"])
        assert torch.equal(p[f"a_src{l}"], p[f"a_dst{l}"])
        assert p[f"a_src{l}"].data_ptr() != p[f"a_dst{l}"].data_ptr()
        assert p[f"W{l}"].shape == rp[f"W{l}"].shape


def test_gat_isolated_receiver_and_masked_edges_match_reference(cases):
    """A receiver with no edges: both libraries' segment max leave -inf in
    its row, which no edge gathers, so its output is 0 in both; masked
    edges (logit -1e30, weight 0) change nothing either."""
    rcfg, cfg = ref_config("gat-cora"), get_config("gat-cora")
    _, p_np, *_ = cases["gat-cora", "molecule"]          # d_in 16
    rng = np.random.default_rng(4)
    n, e = 30, 90
    s = rng.integers(0, n - 1, e).astype(np.int32)
    r = rng.integers(0, n - 1, e).astype(np.int32)   # node n-1 receives none
    mask = (rng.random(e) > 0.2).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p_, *a: rg.gat_forward(p_, rcfg, *a, n))(
        p_np, x, s, r, mask))
    pt = tg.params_from_jax(cfg, p_np)
    got = tg.gat_forward(pt, cfg, torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(r), torch.from_numpy(mask), n)
    close(got, want, FWD)
    assert np.all(want[n - 1] == 0) and torch.all(got[n - 1] == 0)
    mx = tg.seg_max(torch.from_numpy(x[s]), torch.from_numpy(r), n)
    mx_ref = np.asarray(rg.seg_max(jnp.asarray(x[s]), jnp.asarray(r), n))
    assert np.isneginf(mx_ref[n - 1]).all() and torch.isneginf(mx[n - 1]).all()
    assert np.array_equal(mx.numpy(), mx_ref)


def test_layernorm_is_the_population_variance():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    w = rng.normal(size=(6, 6)).astype(np.float32)
    pj = {"m_w0": jnp.asarray(w), "m_b0": jnp.zeros(6)}
    want = rg._mlp_apply(pj, "m", jnp.asarray(x), 1, layernorm=True)
    pt = {"m_w0": torch.from_numpy(w), "m_b0": torch.zeros(6)}
    close(tg._mlp_apply(pt, "m", torch.from_numpy(x), 1, layernorm=True),
          want, FWD)


def test_node_xent_and_graph_readout_xent_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(40, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 40).astype(np.int32)
    mask = (rng.random(40) > 0.3).astype(np.float32)
    want = rg.node_xent(jnp.asarray(logits), jnp.asarray(labels),
                        jnp.asarray(mask))
    got = tg.node_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(mask))
    close(got, np.float32(want), FWD)
    # an all-zero mask divides by 1, not 0
    zero = tg.node_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.zeros(40))
    assert float(zero) == 0.0
    gids = np.repeat(np.arange(5, dtype=np.int32), 8)
    glab = rng.integers(0, 7, 5).astype(np.int32)
    want = rg.graph_readout_xent(jnp.asarray(logits), jnp.asarray(gids),
                                 jnp.asarray(glab), 5)
    got = tg.graph_readout_xent(torch.from_numpy(logits),
                                torch.from_numpy(gids),
                                torch.from_numpy(glab), 5)
    close(got, np.float32(want), FWD)


def test_card_gather_and_segment_sum_equal_the_cpu_ones():
    """On a card ``gather`` and ``seg_sum`` take ``x[ids]`` and an
    accumulating ``index_put`` (sorted under the deterministic mode, no
    copy); held here on CPU tensors against the CPU forms, values and
    gradients."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, 30, 400).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(30, 6)).astype(np.float32))
    outs = []
    for g_fn, s_fn in ((tg.gather, tg.seg_sum),
                       (tg._gather_card, tg._seg_sum_card)):
        xx = x.clone().requires_grad_(True)
        y = s_fn(g_fn(xx, ids) * 2.0, seg, 30)
        (gx,) = torch.autograd.grad((y * w).sum(), xx)
        outs.append((y.detach(), gx))
    close(outs[1][0], outs[0][0].numpy(), FWD)
    close(outs[1][1], outs[0][1].numpy(), GRAD)
