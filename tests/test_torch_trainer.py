"""The port's fault-tolerant loop (``repro_torch.runtime.trainer``) and
its prefetcher (``data/pipeline.py::DevicePrefetcher``), on the CPU.

An interrupted and resumed run equals the uninterrupted one (the JAX
package's ``tests/test_runtime.py::test_trainer_resume_bit_identical``;
here bit for bit, tolerance 0, as every op is deterministic on the
CPU), and both equal the JAX package's loop on the same data within
float32 rounding (rtol 1e-5, atol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import SGDM as RSGDM
from repro.runtime.trainer import Trainer as RTrainer
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import (DevicePrefetcher, lm_batch,
                                       step_stream)
from repro_torch.optim.adamw import SGDM
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.trainer import Trainer, value_and_grad_step
from _torch_threads import one_thread  # noqa: F401


def _batch_np(step):
    rng = np.random.default_rng((7, step))
    x = rng.normal(size=(4, 8)).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True) * 0.1}


def _loss(p, b):
    pred = b["x"] @ p["w"] + p["b"]
    return torch.mean((pred - b["y"]) ** 2)


def _p0():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": np.zeros(8, np.float32)}


def test_trainer_resume_bit_identical(tmp_path):
    opt = SGDM(lr=0.05)
    step = value_and_grad_step(_loss, opt)

    def make_batch(s):
        return {k: torch.from_numpy(v) for k, v in _batch_np(s).items()}
    p0 = {k: torch.from_numpy(v) for k, v in _p0().items()}
    s0 = (p0, opt.init(p0))
    mon = StragglerMonitor()
    full, log_full = Trainer(step, make_batch, str(tmp_path / "a"),
                             ckpt_every=100, straggler=mon).run(
        s0, 10, resume=False)
    assert len(log_full) == 10 and len(mon._times) == 10
    Trainer(step, make_batch, str(tmp_path / "b"), ckpt_every=5).run(
        s0, 5, resume=False)                     # "crash" after 5 steps
    resumed, log_res = Trainer(step, make_batch, str(tmp_path / "b"),
                               ckpt_every=5).run(s0, 10, resume=True)
    assert [m["loss"] for m in log_res] == [m["loss"] for m in
                                            log_full[5:]]
    for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(resumed)):
        assert torch.equal(a, b)
    # the JAX package's loop on the same data
    ropt = RSGDM(lr=0.05)

    @jax.jit
    def rstep(state, b):
        p, o = state
        loss, g = jax.value_and_grad(lambda q: jnp.mean(
            (b["x"] @ q["w"] + q["b"] - b["y"]) ** 2))(p)
        p, o = ropt.update(g, o, p)
        return (p, o), {"loss": loss}
    rp0 = {k: jnp.asarray(v) for k, v in _p0().items()}
    rfull, rlog = RTrainer(rstep, lambda s: {k: jnp.asarray(v) for k, v in
                                             _batch_np(s).items()},
                           str(tmp_path / "r"), ckpt_every=100).run(
        (rp0, ropt.init(rp0)), 10, resume=False)
    np.testing.assert_allclose([m["loss"] for m in log_full],
                               [m["loss"] for m in rlog], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(rfull)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_trainer_refuses_another_config(tmp_path):
    opt = SGDM(lr=0.05)
    step = value_and_grad_step(_loss, opt)
    p0 = {k: torch.from_numpy(v) for k, v in _p0().items()}

    def make_batch(s):
        return {k: torch.from_numpy(v) for k, v in _batch_np(s).items()}
    d = str(tmp_path / "c")
    Trainer(step, make_batch, d, ckpt_every=2, meta={"arch": "a"}).run(
        (p0, opt.init(p0)), 2)
    with pytest.raises(ValueError, match="meta mismatch"):
        Trainer(step, make_batch, d, meta={"arch": "b"}).run(
            (p0, opt.init(p0)), 4)


def test_prefetcher_yields_step_stream_in_order():
    cfg = reduced(get_config("smollm-135m"), vocab=512)

    def make(s):
        return lm_batch(cfg, 2, 16, s)
    for device in (None, "cpu"):
        pf = DevicePrefetcher(step_stream(make, start_step=3), device=device,
                              depth=2)
        got = [next(pf) for _ in range(6)]
        pf.close()
        for i, b in enumerate(got):
            want = make(3 + i)
            assert sorted(b) == sorted(want)
            for k in want:
                assert np.array_equal(np.asarray(b[k]), want[k])


def test_prefetcher_ends_with_its_stream_and_passes_errors_on():
    pf = DevicePrefetcher(iter([{"x": np.zeros(2)}, {"x": np.ones(2)}]),
                          device="cpu")
    assert [float(b["x"][0]) for b in pf] == [0.0, 1.0]
    pf.close()
    assert not pf._thread.is_alive()

    def broken():
        yield {"x": np.zeros(1)}
        raise ValueError("bad batch")
    pf = DevicePrefetcher(broken(), device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()
