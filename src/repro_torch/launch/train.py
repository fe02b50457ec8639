"""Training launcher: ``--arch <id>`` picks a registered architecture and
runs the fault-tolerant ``Trainer`` on one card; the JAX package's
``launch/train.py`` with its defaults (reduced dims, an MoE arch cut to 4
experts top-2 as ``launch/serve.py::reduced_lm`` cuts it; ``--full`` for
the registered width, refused where its parameters exceed the device's
memory) and its printed lines.

    PYTHONPATH=src python -m repro_torch.launch.train --arch autoint --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --full --batch 8 --seq 1024 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch bfs-rmat --scale 12
    PYTHONPATH=src python -m repro_torch.launch.train --arch autoint --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \
        --shape ogb_products --steps 20

The lm and recsys kinds train with AdamW (kernels 9 and 9b, or 8 and 8b,
on the card); the bfs kind runs up to 8 searches through the kernel
entries and validates each tree.  The gnn kind trains on the JAX
launcher's smoke graph (512 nodes, 2,048 edges, 32 features) with
AdamW, or with ``--shape`` on one of the arch's registered shapes at
full size, laid out for one device as the JAX package's GNN cells lay it
out (the large graphs' edges from kernel 7 on the card); its steps run
under ``cells.deterministic()``.  ``--device cuda`` (the default) raises
without a card.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import GNNShape, get_config, reduced
from repro_torch.data.pipeline import lm_batch, recsys_batch
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.serve import RECSYS_SMALL, check_fits, reduced_lm
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import Trainer, value_and_grad_step

LM_SEQ_CHUNK = 64        # the JAX launcher's lm_loss(..., seq_chunk=64)
# the JAX launcher's GNN smoke graph
GNN_SMOKE = GNNShape("smoke", 512, 2048, d_feat=32, kind="full")


def run_bfs_kind(cfg, scale: int, steps: int, device) -> None:
    """Up to 8 searches from random roots of an R-MAT graph on the 1x1
    grid, each tree validated on the host."""
    from repro_torch.core.bfs import run_bfs
    from repro_torch.core.ref import validate_parents
    from repro_torch.graph.formats import build_blocked
    from repro_torch.graph.rmat import random_source, rmat_graph
    from repro_torch.launch.mesh import make_local_mesh
    edges = rmat_graph(scale, 16, seed=1, device=device)
    g = build_blocked(edges, 1, 1, align=32)
    mesh = make_local_mesh(1, 1, device=device)
    src, dst = edges.src.cpu().numpy(), edges.dst.cpu().numpy()
    rng = np.random.default_rng(0)
    for i in range(min(steps, 8)):
        root = random_source(edges, rng)
        res = run_bfs(g, root, cfg, mesh, local_mode="kernel")
        ok, msg = validate_parents(edges.n, src, dst, root, res.parents)
        if not ok:
            raise RuntimeError(f"search {i} from root {root}: {msg}")
        print(f"search {i}: root={root} levels={res.n_levels} valid")


def lm_setup(cfg, device, batch: int, seq: int, opt: AdamW,
             seq_chunk: int = LM_SEQ_CHUNK):
    """(state, step_fn, make_batch) of an LM: seeded params, AdamW state,
    ``lm_loss`` over ``lm_batch(cfg, batch, seq, step)`` on ``device``."""
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, seed=0, device=device)
    step_fn = value_and_grad_step(
        lambda p, b: tf.lm_loss(p, b["tokens"], b["labels"], cfg,
                                seq_chunk=seq_chunk), opt)

    def make_batch(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in lm_batch(cfg, batch, seq, step).items()}
    return (params, opt.init(params)), step_fn, make_batch


def recsys_setup(cfg, device, batch: int, opt: AdamW):
    """(state, step_fn, make_batch) of AutoInt: seeded trainable params,
    AdamW state, ``bce_loss`` over ``recsys_batch(cfg, batch, step)``."""
    from repro_torch.models import autoint as ai
    model = ai.AutoInt(cfg, seed=0, device=device, trainable=True)
    params = {k: v.detach() for k, v in model.params().items()}
    step_fn = value_and_grad_step(
        lambda p, b: ai.bce_loss(p, cfg, b["idx"], b["labels"]), opt)

    def make_batch(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in recsys_batch(cfg, batch, step).items()}
    return (params, opt.init(params)), step_fn, make_batch


def gnn_setup(cfg, device, opt: AdamW, shape_name=None, seed: int = 0):
    """(state, step_fn, make_batch) of a GNN arch: seeded params, AdamW
    state and ``cells._gnn_loss`` under ``cells.deterministic()``.  With
    no ``shape_name``, the JAX launcher's smoke graph (every step the same
    batch, ``node_mask`` ones, ``targets_g`` zeros); else the registered
    shape at full size on one device: a full or batched shape's batch
    from ``build_gnn_batch``, or for a sampled shape its CSR and features
    (``cells.sampled_graph``) with the step's seeds and sampler seed a
    function of the step."""
    from repro_torch.graph.datasets import build_gnn_batch
    from repro_torch.launch import cells
    shape = GNN_SMOKE if shape_name is None else next(
        (s for s in cfg.shapes if s.name == shape_name), None)
    if shape is None:
        raise ValueError(f"{cfg.arch} has no shape {shape_name!r}; have "
                         f"{[s.name for s in cfg.shapes]}")
    if shape.kind == "sampled":
        init, loss_fn = cells.sampled_loss(cfg, shape)
        graph = cells.sampled_graph(shape, cfg.n_classes, seed, device)

        def make_batch(step):
            g = torch.Generator().manual_seed(seed + step)
            seeds = torch.randint(0, shape.n_nodes, (shape.batch_nodes,),
                                  generator=g, dtype=torch.int32)
            return {"graph": graph, "seeds": seeds.to(device),
                    "sample_seed": seed + step}
    else:
        b = build_gnn_batch(cfg, shape, seed=seed, device=device)
        n = b["x"].shape[0]
        n_graphs = shape.batch_graphs if shape.kind == "batched" else 1
        b["node_mask"] = torch.ones(n, dtype=torch.float32, device=device)
        b["targets_g"] = torch.zeros(n_graphs, dtype=torch.float32,
                                     device=device)
        init, loss_fn = cells._gnn_loss(cfg, shape, n, n_graphs,
                                        b["x"].shape[1])

        def make_batch(step):
            return b
    params = init(seed=seed, device=device)
    step_fn = cells.deterministic_step(value_and_grad_step(loss_fn, opt))
    return (params, opt.init(params)), step_fn, make_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--scale", type=int, default=12, help="BFS graph scale")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--full", action="store_true",
                    help="train the registered width, not the reduced dims")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a step (default: lm 4, recsys 64)")
    ap.add_argument("--seq", type=int, default=64, help="lm tokens a row")
    ap.add_argument("--shape", default=None,
                    help="gnn: a registered shape at full size (default: "
                         "the smoke graph)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    dev = resolve_device(args.device)

    if cfg.kind == "bfs":
        run_bfs_kind(cfg, args.scale, args.steps, dev)
        return

    opt = AdamW(lr=1e-3, total_steps=args.steps)
    if cfg.kind == "lm":
        if args.full:
            check_fits(cfg, dev)
        else:
            cfg = reduced_lm(cfg)
        state, step_fn, mk = lm_setup(cfg, dev, args.batch or 4, args.seq,
                                      opt)
    elif cfg.kind == "gnn":
        state, step_fn, mk = gnn_setup(cfg, dev, opt, args.shape)
    else:  # recsys
        if not args.full:
            cfg = reduced(cfg, **RECSYS_SMALL)
        state, step_fn, mk = recsys_setup(cfg, dev, args.batch or 64, opt)

    tr = Trainer(step_fn, mk, args.ckpt_dir, ckpt_every=10,
                 meta={"arch": args.arch})
    state, log = tr.run(state, args.steps)
    if not log:
        print(f"{args.arch}: 0 steps (a checkpoint at step {args.steps} or "
              f"later is in {args.ckpt_dir})")
        return
    print(f"{args.arch}: {len(log)} steps, "
          f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
