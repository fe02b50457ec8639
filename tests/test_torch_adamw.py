"""The port's optimizers (``repro_torch.optim.adamw``) against the JAX
package's on the same params and grads, made with numpy from a seed.

Tolerance: float32 state rtol 1e-6, atol 1e-7 (the same float32
operations; XLA's and torch's pow, cos and sqrt may differ in the last
bit); bfloat16 state: the moments may land one bf16 ulp apart after a
float32 difference in the last bit, so they and the params are held to
2**-7 of each value plus 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as RAdamW
from repro.optim.adamw import SGDM as RSGDM
from repro.optim.adamw import global_norm as r_global_norm
from repro_torch.optim.adamw import SGDM, AdamW, AdamWState, global_norm
from _torch_threads import one_thread  # noqa: F401

_SHAPES = {"w": (8, 16), "b": (16,), "emb": (32, 4)}


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in _SHAPES.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, bf16=False):
    for k in want:
        g = got[k].float().numpy()
        w = np.asarray(want[k]).astype(np.float32)
        if bf16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(schedule="constant", warmup_steps=1),
    dict(warmup_steps=3, total_steps=8, grad_clip=0.5),
    dict(state_dtype="bfloat16", weight_decay=0.0),
], ids=["cosine", "constant", "warmup-clip", "bf16-state"])
def test_adamw_matches_reference(kw, steps):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(steps)]
    ropt, opt = RAdamW(lr=1e-2, **kw), AdamW(lr=1e-2, **kw)
    rp, rst = _jax(p0), ropt.init(_jax(p0))
    tp, tst = _torch(p0), opt.init(_torch(p0))
    for g in grads:
        rp, rst = ropt.update(_jax(g), rst, rp)
        tp, tst = opt.update(_torch(g), tst, tp)
    bf16 = kw.get("state_dtype") == "bfloat16"
    assert isinstance(tst, AdamWState)
    assert int(tst.step) == int(rst.step) == steps
    assert tst.step.dtype == torch.int32
    _close(tp, rp, bf16)
    _close(tst.mu, rst.mu, bf16)
    _close(tst.nu, rst.nu, bf16)
    want_dt = torch.bfloat16 if bf16 else torch.float32
    assert all(v.dtype == want_dt for v in tst.mu.values())


def test_adamw_keeps_param_dtype_and_leaves_inputs():
    rng = np.random.default_rng(1)
    p = {k: v.to(torch.bfloat16) for k, v in _torch(_tree(rng)).items()}
    before = {k: v.clone() for k, v in p.items()}
    opt = AdamW()
    st = opt.init(p)
    new, st2 = opt.update(_torch(_tree(rng)), st, p)
    assert all(new[k].dtype == torch.bfloat16 for k in new)
    assert all(torch.equal(p[k], before[k]) for k in p)
    assert int(st.step) == 0 and int(st2.step) == 1


@pytest.mark.parametrize("steps", [1, 5])
def test_sgdm_matches_reference(steps):
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    ropt, opt = RSGDM(lr=0.05), SGDM(lr=0.05)
    rp, rst = _jax(p0), ropt.init(_jax(p0))
    tp, tst = _torch(p0), opt.init(_torch(p0))
    for g in grads:
        rp, rst = ropt.update(_jax(g), rst, rp)
        tp, tst = opt.update(_torch(g), tst, tp)
    _close(tp, rp)
    _close(tst, rst)


def test_global_norm_matches_reference():
    t = _tree(np.random.default_rng(3), scale=2.0)
    np.testing.assert_allclose(float(global_norm(_torch(t))),
                               float(r_global_norm(_jax(t))), rtol=1e-6)


def test_adamw_descends_quadratic():
    """The JAX package's test_runtime.py::test_adamw_descends_quadratic."""
    opt = AdamW(lr=0.05, weight_decay=0.0, warmup_steps=1,
                schedule="constant")
    p = {"w": torch.ones(16) * 3.0}
    st = opt.init(p)

    def loss(p):
        return torch.sum(p["w"] ** 2)
    l0 = float(loss(p))
    for _ in range(100):
        w = p["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        p, st = opt.update({"w": g}, st, p)
    assert float(loss(p)) < 0.05 * l0
    assert float(global_norm(p)) < float(global_norm({"w": torch.ones(16)
                                                      * 3}))
    # and it followed the reference's path
    rp = {"w": jnp.ones((16,)) * 3.0}
    ropt = RAdamW(lr=0.05, weight_decay=0.0, warmup_steps=1,
                  schedule="constant")
    rst = ropt.init(rp)
    for _ in range(100):
        rp, rst = ropt.update(jax.grad(lambda q: jnp.sum(q["w"] ** 2))(rp),
                              rst, rp)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(rp["w"]),
                               rtol=1e-5, atol=1e-6)
