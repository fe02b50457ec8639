"""Training-state checkpoints (``repro_torch.ckpt.checkpoint.save`` /
``restore``) against the JAX package's: the round trip, retention and
the meta refusal of ``tests/test_runtime.py``, and cross-loading in both
directions, bit for bit (tolerance 0).

A bfloat16 leaf goes to disk as raw 2-byte records (numpy ``|V2``) in
both packages.  The JAX package's own ``restore`` cannot read such a
leaf back (numpy has no cast from ``|V2`` to ml_dtypes' bfloat16), for
its own files and for the port's alike; the port reads both."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro.optim.adamw import AdamW as RAdamW
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.optim.adamw import AdamW, AdamWState
from _torch_threads import one_thread  # noqa: F401


def _toy_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)}


def test_checkpoint_roundtrip_and_retention(tmp_path):
    """tests/test_runtime.py::test_checkpoint_roundtrip_and_retention."""
    d = str(tmp_path / "ck")
    s = _toy_state()
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, s, meta={"cfg": "x"}, keep=2)
    assert ckpt.latest_step(d) == 40
    assert len(sorted(os.listdir(d))) == 2          # retention pruned
    got, meta = ckpt.restore(d, 40, s, expect_meta={"cfg": "x"})
    assert meta["step"] == 40 and meta["n_leaves"] == 2
    for k in s:
        assert torch.equal(got[k], s[k])
    with pytest.raises(ValueError, match="meta mismatch"):
        ckpt.restore(d, 40, s, expect_meta={"cfg": "y"})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, 40, {"w": s["w"]})


def _states(dtype):
    """The same (params, AdamW state) in both packages: params in
    ``dtype``, one AdamW step taken in each."""
    rng = np.random.default_rng(0)
    pn = {"embed": rng.normal(size=(16, 4)).astype(np.float32),
          "ln": rng.normal(size=(4,)).astype(np.float32)}
    gn = {k: rng.normal(size=v.shape).astype(np.float32)
          for k, v in pn.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rp = {k: jnp.asarray(v).astype(jdt) for k, v in pn.items()}
    ropt = RAdamW(lr=0.1)
    rp, rst = ropt.update({k: jnp.asarray(v) for k, v in gn.items()},
                          ropt.init(rp), rp)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in pn.items()}
    opt = AdamW(lr=0.1)
    tp, tst = opt.update({k: torch.from_numpy(v) for k, v in gn.items()},
                         opt.init(tp), tp)
    return (rp, rst), (tp, tst)


def _bits(x):
    """A leaf's shape, raw bytes and dtype name, either package's."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape),
                x.reshape(-1).view(torch.uint8).numpy().tobytes(),
                str(x.dtype).replace("torch.", ""))
    a = np.asarray(x)
    return a.shape, a.tobytes(), a.dtype.name


def _same_tree(got, want):
    gl, _ = ckpt._flatten(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert _bits(g) == _bits(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_bit_for_bit(tmp_path, dtype):
    (rp, rst), (tp, tst) = _states(dtype)
    d = str(tmp_path / "ref")
    r_ckpt.save(d, 7, (rp, rst), meta={"arch": "x"})
    like = (tp, AdamWState(step=torch.zeros((), dtype=torch.int32),
                           mu={k: torch.zeros_like(v) for k, v in
                               tst.mu.items()},
                           nu={k: torch.zeros_like(v) for k, v in
                               tst.nu.items()}))
    got, meta = ckpt.restore(d, 7, like, expect_meta={"arch": "x"})
    assert isinstance(got[1], AdamWState)
    assert got[0]["embed"].dtype == tp["embed"].dtype
    _same_tree(got, (rp, rst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_is_the_reference_format(tmp_path, dtype):
    """The port writes the bytes the JAX package writes: the same npz
    members (names, dtypes, bytes) and meta (treedef string included);
    float32 states restore in the JAX package bit for bit, and a bf16
    leaf meets the same refusal there as the JAX package's own."""
    (rp, rst), (tp, tst) = _states(dtype)
    # the same values in both packages: write the reference's state
    # from the port
    state = ckpt.restore(*_write_ref(tmp_path, rp, rst), (tp, tst))[0]
    dp, dr = str(tmp_path / "port"), str(tmp_path / "ref2")
    ckpt.save(dp, 3, state, meta={"arch": "x"})
    r_ckpt.save(dr, 3, (rp, rst), meta={"arch": "x"})
    zp = np.load(os.path.join(dp, "step_0000000003", "host0.npz"))
    zr = np.load(os.path.join(dr, "step_0000000003", "host0.npz"))
    assert sorted(zp.files) == sorted(zr.files)
    for f in zr.files:
        assert zp[f].dtype == zr[f].dtype and zp[f].shape == zr[f].shape
        assert zp[f].tobytes() == zr[f].tobytes(), f
    mp, mr = (json.load(open(os.path.join(x, "step_0000000003",
                                          "meta.json"))) for x in (dp, dr))
    assert mp == mr
    if dtype == "float32":
        got, _ = r_ckpt.restore(dp, 3, (rp, rst))
        _same_tree(state, got)
    else:
        for d in (dp, dr):
            with pytest.raises(ValueError, match="No cast function"):
                r_ckpt.restore(d, 3, (rp, rst))


def _write_ref(tmp_path, rp, rst):
    d = str(tmp_path / "src")
    r_ckpt.save(d, 1, (rp, rst))
    return d, 1


def test_flatten_order_and_treedef_match_jax():
    tree = ({"w": torch.ones(2), "b": torch.ones(1)},
            AdamWState(step=torch.zeros((), dtype=torch.int32),
                       mu={"w": 1, "b": 2}, nu={"w": 3, "b": 4}),
            [None, (5,)])
    jtree = ({"w": 0, "b": 0}, RAdamW().init({"w": jnp.ones(2),
                                              "b": jnp.ones(1)}),
             [None, (5,)])
    leaves, td = ckpt._flatten(tree)
    assert ckpt.treedef_str(td) == str(jax.tree.flatten(jtree)[1])
    assert [x if not isinstance(x, torch.Tensor) else "t" for x in leaves] \
        == ["t", "t", "t", 2, 1, 4, 3, 5]
    back = ckpt._unflatten(td, leaves)
    assert isinstance(back[1], AdamWState) and back[2][0] is None
    assert back[1].mu == {"w": 1, "b": 2} and back[2][1] == (5,)
