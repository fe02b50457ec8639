"""The port's 2D expand/fold GNN cells (``launch/optimized.py``) against
the JAX package's, run concretely: gin-tu-2d and mace-2d at
``full_graph_sm`` on a 2x2 simulated grid against the JAX cells jitted
on 4 forced host devices (``_torch_cells_main.py optimized``), the same
seeded inputs and parameters: one training step's loss and updated
parameters.  And gin-tu-2d's loss equals gin-tu's on one device over the
same edge multiset.

Tolerances, float32: the loss within 2e-5 of its magnitude (sums of
10,556 edges and 2,708 nodes in another order); the updated parameters
within 1e-5 absolute.  AdamW's first step moves a weight by about lr
(3e-4) times the sign of its gradient, so a weight whose gradient the
two orders round to opposite signs near zero would move 6e-4 apart;
none does here."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.optimized import (block_edges, build_gin2d_cell,
                                          build_mace2d_cell, gin2d_loss,
                                          node_blocks, _part_and_cap)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import mace as mace_mod
from repro_torch.optim.adamw import AdamW
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)
LOSS_RTOL, PARAM_ATOL = 2e-5, 1e-5


def _inputs():
    """Seeded graph, node data and parameters of both cells, as numpy."""
    rng = np.random.default_rng(7)
    mesh = make_mesh(2, 2, device="cpu")
    data, torch_in = {}, {}
    for name, arch in (("gin", "gin-tu"), ("mace", "mace")):
        cfg = get_config(arch)
        shape = next(s for s in cfg.shapes if s.name == "full_graph_sm")
        part, cap = _part_and_cap(shape, mesh)
        n, e = shape.n_nodes, shape.n_edges
        s = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
        r = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
        esrc, ridx, nnz = block_edges(part, s, r, cap)
        if name == "gin":
            x = torch.from_numpy(rng.normal(size=(n, shape.d_feat))
                                 .astype(np.float32))
            y = torch.from_numpy(rng.integers(0, cfg.n_classes, n)
                                 .astype(np.int32))
            nodes = [node_blocks(part, x), node_blocks(part, y),
                     node_blocks(part, torch.ones(n))]
            params = gnn_mod.init_gin(cfg, shape.d_feat, cfg.n_classes,
                                      seed=3)
        else:
            sp = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
            pos = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
            nodes = [node_blocks(part, sp), node_blocks(part, pos),
                     torch.tensor([1.5])]
            params = mace_mod.init_mace(cfg, seed=3)
        args = [esrc, ridx, nnz] + nodes
        torch_in[name] = (params, args, (s, r), part)
        for i, a in enumerate(args):
            data[f"{name}/a{i}"] = a.numpy()
        for k, v in params.items():
            data[f"{name}/p/{k}"] = v.numpy()
    return data, torch_in


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    data, torch_in = _inputs()
    d = tmp_path_factory.mktemp("opt")
    np.savez(d / "in.npz", **data)
    r = subprocess.run([sys.executable, os.path.join(_HERE,
                                                     "_torch_cells_main.py"),
                        "optimized", str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, **ONE_THREAD_ENV})
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(d / "out.npz")), torch_in


def _step(name, torch_in):
    build = build_gin2d_cell if name == "gin" else build_mace2d_cell
    cell = build("full_graph_sm", make_mesh(2, 2, device="cpu"))
    params, args, _, _ = torch_in[name]
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    return cell.fn(p, AdamW().init(p), *args)


@pytest.mark.parametrize("name", ["gin", "mace"])
def test_step_equals_reference(run, name):
    want, torch_in = run
    p2, ost2, loss = _step(name, torch_in)
    ref_loss = float(want[f"{name}/loss"])
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert int(ost2.step) == 1
    for k, v in p2.items():
        np.testing.assert_allclose(v.detach().numpy(), want[f"{name}/p/{k}"],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_gin2d_loss_equals_gin_on_one_device(run):
    _, torch_in = run
    params, args, (s, r), part = torch_in["gin"]
    cfg = get_config("gin-tu")
    shape = next(x for x in cfg.shapes if x.name == "full_graph_sm")
    n = shape.n_nodes
    loss2d = gin2d_loss(part, cfg.n_layers)(params, *args)
    x, y = (a.reshape(part.n, *a.shape[3:])[:n] for a in args[3:5])
    _, loss_fn = cells._gnn_loss(cfg, shape, n, 1, shape.d_feat)
    batch = {"senders": s, "receivers": r,
             "edge_mask": torch.ones(s.shape[0]), "x": x, "labels": y,
             "node_mask": torch.ones(n),
             "graph_ids": torch.zeros(n, dtype=torch.int32)}
    loss1 = loss_fn(params, batch)
    assert abs(float(loss2d) - float(loss1)) <= LOSS_RTOL * abs(float(loss1))


def test_block_edges_keep_the_edge_multiset(run):
    _, torch_in = run
    _, args, (s, r), part = torch_in["gin"]
    esrc, ridx, nnz = args[:3]
    assert int(nnz.sum()) == s.shape[0]
    blk = torch.arange(part.p).reshape(part.pr, part.pc)
    live = torch.arange(esrc.shape[-1]) < nnz[..., None]
    i, j = blk // part.pc, blk % part.pc
    u = (esrc + (j * part.nc)[..., None])[live]
    v = (ridx + (i * part.nr)[..., None])[live]
    got = sorted(zip(u.tolist(), v.tolist()))
    assert got == sorted(zip(s.long().tolist(), r.long().tolist()))
    with pytest.raises(ValueError, match="over cap"):
        block_edges(part, s, r, cap=128)
