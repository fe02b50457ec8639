"""GNN training on the CPU against the JAX package: one AdamW step of each
GNN arch's ``_gnn_loss`` (``launch/cells.py``) on the JAX launcher's
smoke graph (512 nodes, 2,048 edges, 32 features) with ``d_hidden`` cut
to 16 (and MeshGraphNet to 4 of its 15 layers, for the compile), against
``jax.value_and_grad`` of the JAX ``_gnn_loss`` and the JAX
``AdamW.update``; the sampled cell's step (``khop_sample``, the
batch, the loss) against the JAX cell's on a degree-1 graph, where the
sampler has nothing to draw; ``launch.train`` for each GNN arch;
a resumed run bit for bit; and the port's ``examples/gnn_full_graph.py``.

Tolerances (float32): losses within 1e-5 of the JAX value plus 1e-6,
gradients within 1e-4 of the largest plus 1e-6.  The optimizers are
compared on the same (the JAX) gradients, since AdamW's first step is
about g/|g|: parameters and moments within 1e-5 of the largest plus
1e-6.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNShape as RShape
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.graph.datasets import build_gnn_batch as r_build_gnn_batch
from repro.launch import cells as r_cells
from repro.launch.mesh import make_local_mesh as r_mesh
from repro.models.common import ShardCtx
from repro.optim.adamw import AdamW as RAdamW
from repro_torch.configs.base import GNNShape, get_config, reduced
from repro_torch.launch import cells, train
from repro_torch.models import gnn as tg
from repro_torch.models import mace as tm
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import Trainer
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("gin-tu", "gat-cora", "meshgraphnet", "mace")
FWD, GRAD = 1e-5, 1e-4
D_HIDDEN = 16


def _cut(arch):
    return dict(d_hidden=D_HIDDEN,
                **({"n_layers": 4} if arch == "meshgraphnet" else {}))


def close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = rel * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _port_params(arch, cfg, p_np):
    mod = tm if arch == "mace" else tg
    return mod.params_from_jax(cfg, p_np)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(arch):
    rcfg = r_reduced(r_get_config(arch), **_cut(arch))
    cfg = reduced(get_config(arch), **_cut(arch))
    rshape = RShape("smoke", 512, 2048, d_feat=32, kind="full")
    b = r_build_gnn_batch(rcfg, rshape, seed=0)
    b["node_mask"] = np.ones(b["x"].shape[0], np.float32)
    b["targets_g"] = np.zeros(1, np.float32)
    init_r, loss_r = r_cells._gnn_loss(rcfg, rshape, ShardCtx(mesh=None),
                                       512, 1, 32)
    ropt = RAdamW(lr=1e-3, total_steps=3)

    def ref(key, bj):
        p = init_r(key)
        ost = ropt.init(p)
        loss, g = jax.value_and_grad(loss_r)(p, bj)
        p2, ost2 = ropt.update(g, ost, p)
        return p, loss, g, p2, ost2
    p, loss, g, p2, ost2 = jax.jit(ref)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in b.items()})
    as_np = lambda t: {k: np.array(v) for k, v in t.items()}

    init, loss_fn = cells._gnn_loss(cfg, train.GNN_SMOKE, 512, 1, 32)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    params = _port_params(arch, cfg, as_np(p))
    assert {k: tuple(v.shape) for k, v in init().items()} == \
        {k: v.shape for k, v in as_np(p).items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    got = loss_fn(leaves, tb)
    close(got, np.float32(loss), FWD)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    for k, gr in grads.items():
        close(gr, np.asarray(g[k]), GRAD)
    opt = AdamW(lr=1e-3, total_steps=3)
    new_p, st = opt.update({k: torch.from_numpy(v)
                            for k, v in as_np(g).items()},
                           opt.init(params), params)
    assert int(st.step) == int(ost2.step) == 1
    for k in params:
        close(new_p[k], np.asarray(p2[k]), FWD)
        close(st.mu[k], np.asarray(ost2.mu[k]), FWD)
        close(st.nu[k], np.asarray(ost2.nu[k]), FWD)


def test_sampled_step_matches_reference_on_a_degree_one_graph():
    """The JAX ``_gnn_sampled_cell``'s step run on concrete arrays beside
    the port's ``cells.sampled_loss`` + AdamW: on a graph where every
    vertex has one neighbour, both samplers pick the same children."""
    arch = "meshgraphnet"
    rcfg = r_reduced(r_get_config(arch), d_hidden=D_HIDDEN, n_layers=3)
    cfg = reduced(get_config(arch), d_hidden=D_HIDDEN, n_layers=3)
    n = 300
    rshape = RShape("mini", n, n, batch_nodes=8, fanout=(3, 2),
                    kind="sampled")
    shape = GNNShape("mini", n, n, batch_nodes=8, fanout=(3, 2),
                     kind="sampled")
    rng = np.random.default_rng(2)
    row_ptr = np.arange(n + 1, dtype=np.int32)
    col_idx = rng.integers(0, n, n).astype(np.int32)
    feats = rng.normal(size=(n, cells.SAMPLED_D_FEAT)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    seeds = rng.integers(0, n, 8).astype(np.int32)
    cell = r_cells._gnn_sampled_cell(rcfg, rshape, r_mesh(1, 1), "mini")
    init_r, _ = r_cells._gnn_loss(rcfg, rshape, ShardCtx(mesh=None), 1, 1,
                                  cells.SAMPLED_D_FEAT)
    ropt = RAdamW()

    def ref(key, *arrays):
        p = init_r(key)
        return (p, *cell.fn(p, ropt.init(p), *arrays))
    p, p2, _, loss_ref = jax.jit(ref)(
        jax.random.PRNGKey(0), row_ptr, col_idx, feats, labels, seeds,
        jax.random.key_data(jax.random.PRNGKey(7)))

    _, loss_fn = cells.sampled_loss(cfg, shape)
    graph = {"row_ptr": torch.from_numpy(row_ptr),
             "col_idx": torch.from_numpy(col_idx),
             "feats": torch.from_numpy(feats),
             "labels": torch.from_numpy(labels)}
    params = tg.params_from_jax(cfg, {k: np.asarray(v) for k, v in p.items()})
    inputs = {"graph": graph, "seeds": torch.from_numpy(seeds),
              "sample_seed": 3}
    step = cells.deterministic_step(train.value_and_grad_step(loss_fn,
                                                              AdamW()))
    (new_p, _), m = step((params, AdamW().init(params)), inputs)
    close(m["loss"], np.float32(loss_ref), FWD)
    b = cells.sampled_batch(torch.Generator().manual_seed(3), graph,
                            inputs["seeds"], shape.fanout)
    assert b["x"].shape == (8 * (1 + 3 + 6), cells.SAMPLED_D_FEAT)
    assert int(b["node_mask"].sum()) == 8
    for k in params:
        assert new_p[k].shape == tuple(p2[k].shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_prints_the_reference_line(arch, tmp_path, capsys):
    train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{arch}: 3 steps, loss ") and " -> " in line
    a, b = (float(v) for v in line.split("loss ")[1].split(" -> "))
    assert np.isfinite(a) and np.isfinite(b)


def test_launch_train_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train.main(["--arch", "gin-tu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch", ("gin-tu", "mace"))
def test_resumed_run_equals_the_uninterrupted_one(arch, tmp_path):
    """4 steps in one run against 2 steps, a checkpoint and 2 resumed
    ones: losses, parameters (GIN's 0-d eps among them) and AdamW moments
    bit for bit."""
    cfg = reduced(get_config(arch), d_hidden=D_HIDDEN)
    opt = AdamW(lr=1e-3, total_steps=4)

    def run(ckdir):
        state, step_fn, mk = train.gnn_setup(cfg, torch.device("cpu"), opt)
        return Trainer(step_fn, mk, str(ckdir), ckpt_every=2,
                       meta={"arch": arch}).run(state, 4)
    (p_a, o_a), log_a = run(tmp_path / "a")
    shutil.copytree(tmp_path / "a" / f"step_{2:010d}",
                    tmp_path / "b" / f"step_{2:010d}")
    (p_b, o_b), log_b = run(tmp_path / "b")
    assert [m["loss"] for m in log_b] == [m["loss"] for m in log_a[2:]]
    if arch == "gin-tu":
        assert p_b["eps0"].shape == () and float(p_b["eps0"]) != 0.0
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k
        assert torch.equal(o_a.mu[k], o_b.mu[k]) and \
            torch.equal(o_a.nu[k], o_b.nu[k]), k
    assert int(o_a.step) == int(o_b.step) == 4


def test_gnn_full_graph_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import gnn_full_graph
    gnn_full_graph.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "2D expand/fold SpMM matches segment_sum oracle" in out
    assert "GIN loss" in out and "over 30 steps" in out
