"""The port's MACE (``models/mace.py``) against the JAX package's: the
Gaunt table bit for bit, ``mace_energy`` and its gradients (with respect
to ``pos``, the forces, and to every parameter) at ``d_hidden`` 16 on the
20-node, 40-edge graph of the JAX package's ``tests/test_models.py``, and
the port's own E(3) invariance at that test's ``rtol=2e-4``.

The JAX reference is computed once for the module in one ``jax.jit``.
Tolerances (float32): energies within 1e-5 of the largest plus 1e-6,
gradients within 1e-4 of the largest plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNShape as RShape
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.graph.datasets import build_gnn_batch as r_build_gnn_batch
from repro.models import mace as rm
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import mace as tm
from _torch_threads import one_thread  # noqa: F401

FWD, GRAD = 1e-5, 1e-4
ARGS = ("species", "pos", "senders", "receivers", "edge_mask", "graph_ids")


def close(got, want, rel):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = rel * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.fixture(scope="module")
def ref():
    """(batch, params, energy, d energy / d pos, d energy / d params) of
    the JAX package, as numpy."""
    cfg = r_reduced(r_get_config("mace"), d_hidden=16)
    b = r_build_gnn_batch(cfg, RShape("tiny", 20, 40, kind="full"), seed=3)

    def run(key, species, pos, *rest):
        p = rm.init_mace(cfg, key, n_species=8)

        def energy(p_, pos_):
            return rm.mace_energy(p_, cfg, species, pos_, *rest, 1).sum()
        e, (gp, gx) = jax.value_and_grad(energy, argnums=(0, 1))(p, pos)
        return p, e, gx, gp
    p, e, gx, gp = jax.jit(run)(jax.random.PRNGKey(0),
                               *(jnp.asarray(b[k]) for k in ARGS))
    as_np = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return b, as_np(p), np.asarray(e), np.asarray(gx), as_np(gp)


def _port(b, p_np):
    cfg = reduced(get_config("mace"), d_hidden=16)
    p = {k: v.requires_grad_(True)
         for k, v in tm.params_from_jax(cfg, p_np).items()}
    t = {k: torch.from_numpy(b[k]) for k in ARGS}
    return cfg, p, t


def test_gaunt_table_is_the_reference_bit_for_bit():
    got, want = tm.gaunt_table(), rm.gaunt_table()
    assert got.shape == (9, 9, 9) and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_energy_and_forces_match_reference(ref):
    b, p_np, e_ref, gx_ref, gp_ref = ref
    cfg, p, t = _port(b, p_np)
    pos = t["pos"].clone().requires_grad_(True)
    e = tm.mace_energy(p, cfg, t["species"], pos, t["senders"],
                       t["receivers"], t["edge_mask"], t["graph_ids"], 1)
    assert e.shape == (1,)
    close(e.sum(), e_ref, FWD)
    grads = torch.autograd.grad(e.sum(), [pos, *p.values()])
    close(grads[0], gx_ref, GRAD)
    assert set(p) == set(gp_ref)
    for k, g in zip(p, grads[1:]):
        close(g, gp_ref[k], GRAD)
    # the l > 0 mixes reach no output: zero gradient in both packages
    for l in range(cfg.n_layers):
        g = dict(zip(p, grads[1:]))[f"mix_{l}"]
        assert torch.all(g[:, 1:] == 0) and np.all(gp_ref[f"mix_{l}"][:, 1:]
                                                   == 0)


def test_port_energy_is_e3_invariant(ref):
    b, p_np, *_ = ref
    cfg, p, t = _port(b, p_np)
    args = (t["senders"], t["receivers"], t["edge_mask"], t["graph_ids"], 1)
    with torch.no_grad():
        e0 = tm.mace_energy(p, cfg, t["species"], t["pos"], *args)
        rng = np.random.default_rng(0)
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        pos2 = b["pos"] @ Q.T + rng.normal(size=(1, 3))
        e1 = tm.mace_energy(p, cfg, t["species"],
                            torch.from_numpy(pos2.astype(np.float32)), *args)
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=2e-4)
    assert torch.isfinite(e0).all()


def test_port_init_shapes_match_reference(ref):
    _, p_np, *_ = ref
    cfg = reduced(get_config("mace"), d_hidden=16)
    own = tm.init_mace(cfg, n_species=8, seed=1)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in p_np.items()}
    with pytest.raises(KeyError, match="mix_0"):
        tm.params_from_jax(cfg, {k: v for k, v in p_np.items()
                                 if k != "mix_0"})
