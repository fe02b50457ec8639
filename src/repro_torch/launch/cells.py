"""The GNN cells' losses and the sampled training step, from the JAX
package's ``launch/cells.py`` on one device.

``_gnn_loss`` picks the loss of a (GNN arch, shape) pair as the JAX
package does: MACE's energy regression, MeshGraphNet's regression on the
first three outputs, the graph readout's cross-entropy on batched
shapes, the masked node cross-entropy otherwise.  ``sampled_batch`` is
the concrete form of ``_gnn_sampled_cell``'s step for ``minibatch_lg``:
``khop_sample`` from the CSR, then the batch it builds, on real tensors
and an explicit generator (the JAX cell lowers the same step on abstract
shapes).  The rest of the JAX module (the other families' cells and the
dry-run's shardings) is not ported.

``deterministic`` runs a step with ``torch.use_deterministic_algorithms``
on, so that the aggregation's ``index_add`` and the gathers' gradients
reduce in a fixed order on a card (their default is atomics), and a
resumed run repeats the uninterrupted one bit for bit.
"""
from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, GNNShape
from repro_torch.graph.datasets import _edges_for
from repro_torch.graph.sampler import khop_sample
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import mace as mace_mod

SAMPLED_D_FEAT = 128      # the JAX cell's feature width on minibatch_lg


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, then the
    setting it found.  cuBLAS's workspace warning is silenced: a GEMM of
    one shape repeats in one process; the reductions it would not cover
    are the scatters, which this mode orders."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def deterministic_step(step_fn: Callable) -> Callable:
    """``step_fn`` run under ``deterministic()`` (the unwrapped function is
    its ``__wrapped__``)."""
    @functools.wraps(step_fn)
    def step(state, batch):
        with deterministic():
            return step_fn(state, batch)
    return step


def _gnn_loss(cfg: GNNConfig, shape: GNNShape, n: int, n_graphs: int,
              d_in: int) -> Tuple[Callable, Callable]:
    """(init(seed=0, device="cpu") -> params, loss_fn(params, batch))."""
    if cfg.model == "mace":
        def loss_fn(p, b):
            e = mace_mod.mace_energy(p, cfg, b["species"], b["pos"],
                                     b["senders"], b["receivers"],
                                     b["edge_mask"], b["graph_ids"],
                                     n_graphs)
            return torch.mean((e - b["targets_g"]) ** 2)

        def init(seed=0, device="cpu"):
            return mace_mod.init_mace(cfg, seed=seed, device=device)
        return init, loss_fn
    init, apply = gnn_mod.build_gnn_apply(cfg, d_in, cfg.n_classes)

    def loss_fn(p, b):
        out = apply(p, b)
        if cfg.model == "meshgraphnet":
            return torch.mean((out[:, :3] - b["targets"]) ** 2)
        if shape.kind == "batched":
            return gnn_mod.graph_readout_xent(out, b["graph_ids"],
                                              b["labels"], n_graphs)
        return gnn_mod.node_xent(out, b["labels"], b["node_mask"])
    return init, loss_fn


def sampled_sizes(shape: GNNShape) -> Tuple[int, int]:
    """(n_sub, E_sub) of the occurrence tree of one sampled batch."""
    Bs, (f0, f1) = shape.batch_nodes, shape.fanout
    return Bs * (1 + f0 + f0 * f1), Bs * (f0 + f0 * f1)


def sampled_graph(shape: GNNShape, n_classes: int, seed: int = 0,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """The full graph a sampled shape draws from, on ``device``: its CSR
    (``row_ptr`` (N+1,), ``col_idx`` (M,), int32: ``_edges_for``'s edges
    sorted by source, the pointers from a count), node features (N, 128)
    float32 and labels (N,) int32 from numpy's ``default_rng(seed)``."""
    N, M = shape.n_nodes, shape.n_edges
    src, dst = _edges_for(N, M, seed, device=device)
    order = torch.sort(src, stable=True).indices
    col_idx = dst[order]
    del order, dst
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=src.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(src, minlength=N), 0)
    del src
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, SAMPLED_D_FEAT)).astype(np.float32)
    labels = rng.integers(0, n_classes, N).astype(np.int32)
    dev = row_ptr.device
    return {"row_ptr": row_ptr, "col_idx": col_idx,
            "feats": torch.from_numpy(feats).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def sampled_batch(gen: torch.Generator, graph: Dict[str, torch.Tensor],
                  seeds: torch.Tensor, fanouts: Sequence[int]
                  ) -> Dict[str, torch.Tensor]:
    """One ``minibatch_lg`` batch: the occurrence tree of ``seeds`` and
    the node and edge data the JAX cell's step builds from it."""
    sub = khop_sample(gen, graph["row_ptr"], graph["col_idx"], seeds,
                      fanouts)
    ids = sub["node_ids"].long()
    n_sub, bs = ids.shape[0], sub["n_seed"]
    x = graph["feats"][ids]
    pos = x[:, :3]
    dev = x.device
    s, r = sub["senders"], sub["receivers"]
    return {
        "senders": s, "receivers": r, "edge_mask": sub["edge_mask"],
        "x": x,
        "graph_ids": torch.zeros(n_sub, dtype=torch.int32, device=dev),
        "labels": graph["labels"][ids],
        "node_mask": (torch.arange(n_sub, device=dev) < bs).float(),
        "species": (ids % 8).to(torch.int32),
        "pos": pos,
        "targets": pos * 0.5,
        "targets_g": torch.zeros(1, dtype=torch.float32, device=dev),
        "e_feat": torch.cat([pos[s] - pos[r],
                             torch.ones(s.shape[0], 1, device=dev)], 1),
    }


def sampled_loss(cfg: GNNConfig, shape: GNNShape
                 ) -> Tuple[Callable, Callable]:
    """(init, loss_fn(params, inputs)) of the sampled cell: ``inputs``
    holds the full ``graph``, the step's ``seeds`` and the ``sample_seed``
    of the sampler's generator (on the graph's device)."""
    n_sub, E_sub = sampled_sizes(shape)
    sub = GNNShape("sub", n_sub, E_sub, SAMPLED_D_FEAT)
    init, _ = _gnn_loss(cfg, sub, n_sub, shape.batch_nodes, SAMPLED_D_FEAT)
    _, loss_b = _gnn_loss(cfg, sub, n_sub, 1, SAMPLED_D_FEAT)

    def loss_fn(p, inputs):
        graph = inputs["graph"]
        gen = torch.Generator(graph["row_ptr"].device).manual_seed(
            int(inputs["sample_seed"]))
        return loss_b(p, sampled_batch(gen, graph, inputs["seeds"],
                                       shape.fanout))
    return init, loss_fn
