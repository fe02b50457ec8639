"""Full-graph GNN training with the 2D-partitioned aggregation: GIN on a
synthetic citation graph; checks the expand/fold SpMM against the
``np.add.at`` oracle, then trains.  The JAX package's
``examples/gnn_full_graph.py`` on one card.

    PYTHONPATH=src python -m repro_torch.examples.gnn_full_graph
    PYTHONPATH=src python -m repro_torch.examples.gnn_full_graph --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import GNNShape, get_config, reduced
from repro_torch.core.spmm import spmm_2d
from repro_torch.graph.datasets import build_gnn_batch
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import preprocess
from repro_torch.launch.cells import deterministic_step
from repro_torch.launch.mesh import make_local_mesh, resolve_device
from repro_torch.models import gnn as gnn_mod
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import value_and_grad_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config("gin-tu"), d_hidden=32)
    shape = GNNShape("cora_like", 1024, 8192, d_feat=64, kind="full")
    b = build_gnn_batch(cfg, shape, seed=0, device=dev)

    # 1) the 2D SpMM == the segment-sum oracle (1x1 grid here; the tests
    #    cover the simulated multi-processor grids)
    e = preprocess(b["senders"], b["receivers"], shape.n_nodes,
                   symmetrize=False)
    g2d = build_blocked(e, 1, 1, align=32)
    mesh = make_local_mesh(1, 1, device=dev)
    x = b["x"][:, :8]
    got = spmm_2d(g2d, x, mesh).cpu().numpy()
    xs = x.cpu().numpy()
    want = np.zeros_like(xs)
    np.add.at(want, e.dst.cpu().numpy(), xs[e.src.cpu().numpy()])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    print("2D expand/fold SpMM matches segment_sum oracle")

    # 2) train GIN for a few epochs
    b["node_mask"] = torch.ones(shape.n_nodes, device=dev)
    init, apply = gnn_mod.build_gnn_apply(cfg, 64, cfg.n_classes)
    p = init(seed=0, device=dev)
    opt = AdamW(lr=1e-3, schedule="constant")
    step = deterministic_step(value_and_grad_step(
        lambda p_, b_: gnn_mod.node_xent(apply(p_, b_), b_["labels"],
                                         b_["node_mask"]), opt))
    state = (p, opt.init(p))
    losses = []
    for _ in range(30):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    print(f"GIN loss {losses[0]:.3f} -> {losses[-1]:.3f} over 30 steps")
    assert losses[-1] < losses[0]


if __name__ == "__main__":
    main()
