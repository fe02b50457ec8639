"""Synthetic graphs and batches of the GNN shape cells, the JAX package's
``graph/datasets.py`` on one device.

``_edges_for`` takes its edges from one of the JAX package's two R-MAT
streams: the legacy host stream (``rmat_graph(..., generator="numpy")``,
deduplicated and symmetrized) up to scale 16 and edge factor 64, the
counter stream beyond that (kernel 7, ``csrc/rmat_counter.cu``, on a
card; its plain version on the CPU), and neither past scale 30.  The
ids are folded into ``n_nodes`` and tiled to ``n_edges`` on the device
that holds them.  ``build_gnn_batch`` draws the node data with numpy's
``default_rng(seed)`` in the JAX package's order, so every array is the
JAX package's; only ``e_feat``'s norm column is computed on the device
(float32, within 2 ulps of numpy's).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, GNNShape
from repro_torch.graph.rmat import rmat_edges_counter, rmat_graph
from repro_torch.launch.mesh import resolve_device

# host materialization bounds: the legacy stream up to here (the one
# every pinned graph uses), counter-stream slices beyond
_MAX_HOST_SCALE = 16
_MAX_HOST_EF = 64
_MAX_COUNTER_SCALE = 30   # int32 vertex-id ceiling of the counter stream


def _edges_for(n_nodes: int, n_edges: int, seed: int = 0, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(senders, receivers): ``n_edges`` int32 ids below ``n_nodes`` on
    ``device``, the JAX package's arrays."""
    dev = resolve_device(device)
    scale = max(int(np.ceil(np.log2(max(n_nodes, 2)))), 2)
    ef = max(1, n_edges // (1 << scale))
    if scale <= _MAX_HOST_SCALE and ef <= _MAX_HOST_EF:
        e = rmat_graph(scale, edge_factor=ef, seed=seed, generator="numpy",
                       device=dev)
        s, d = e.src, e.dst
    elif scale <= _MAX_COUNTER_SCALE and (ef << scale) < 2 ** 32:
        s, d = rmat_edges_counter(scale, edge_factor=ef, seed=seed, start=0,
                                  count=min(n_edges, ef << scale),
                                  device=dev)
    else:
        raise ValueError(
            f"requested graph needs R-MAT scale={scale}, "
            f"edge_factor={ef} (n_nodes={n_nodes}, n_edges={n_edges}), "
            f"beyond the counter stream's limits (scale <= "
            f"{_MAX_COUNTER_SCALE}, edge_factor*2^scale < 2^32); build "
            f"it with graph.dist_build instead of _edges_for")
    s = s.remainder(n_nodes).to(torch.int32)
    d = d.remainder(n_nodes).to(torch.int32)
    if s.numel() >= n_edges:
        return s[:n_edges], d[:n_edges]
    reps = -(-n_edges // s.numel())
    return s.repeat(reps)[:n_edges], d.repeat(reps)[:n_edges]


def build_gnn_batch(cfg: GNNConfig, shape: GNNShape, *, reduce_to: int = 0,
                    seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """The batch of one GNN shape as tensors on ``device``; ``reduce_to >
    0`` scales node and edge counts down for smoke tests, keeping the
    structure."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if shape.kind == "batched":
        n_g = max(shape.batch_graphs // (reduce_to or 1), 2) if reduce_to \
            else shape.batch_graphs
        npg, epg = shape.n_nodes, shape.n_edges
        N, E = n_g * npg, n_g * epg
        s = rng.integers(0, npg, E).astype(np.int32)
        d = rng.integers(0, npg, E).astype(np.int32)
        off = np.repeat(np.arange(n_g, dtype=np.int32) * npg, epg)
        senders = torch.from_numpy(s + off).to(dev)
        receivers = torch.from_numpy(d + off).to(dev)
        graph_ids = np.repeat(np.arange(n_g, dtype=np.int32), npg)
        labels = rng.integers(0, cfg.n_classes, n_g).astype(np.int32)
        d_feat = 16
    else:
        scale = reduce_to or 1
        N = max(shape.n_nodes // scale, 64)
        E = max(shape.n_edges // scale, 256)
        senders, receivers = _edges_for(N, E, seed, device=dev)
        graph_ids = np.zeros(N, np.int32)
        labels = rng.integers(0, cfg.n_classes, N).astype(np.int32)
        d_feat = shape.d_feat or 16
    x = rng.normal(size=(N, d_feat)).astype(np.float32)
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    species = rng.integers(0, 8, N).astype(np.int32)
    targets = rng.normal(size=(N, 3)).astype(np.float32)
    host = {"x": x, "pos": pos, "species": species, "graph_ids": graph_ids,
            "labels": labels, "targets": targets}
    out = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    # the sender-minus-receiver offset and its norm, summed in numpy's
    # order
    rel = out["pos"][senders] - out["pos"][receivers]
    norm = torch.sqrt(rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
                      + rel[:, 2] * rel[:, 2])
    out.update(senders=senders, receivers=receivers,
               edge_mask=torch.ones(senders.numel(), dtype=torch.float32,
                                    device=dev),
               e_feat=torch.cat([rel, norm[:, None]], 1))
    return out
