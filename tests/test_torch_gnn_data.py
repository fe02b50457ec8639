"""The port's GNN data (``graph/datasets.py``) and configs against the JAX
package's: ``build_gnn_batch`` array for array on the four registered
shapes at ``reduce_to=16`` and on the launcher's smoke shape (bit for
bit, but ``e_feat``'s norm column within 2 float32 ulps), ``_edges_for``
through each of its branches, and the four GNN configs field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import GNNShape as RShape
from repro.configs.base import get_config as r_get_config
from repro.graph import datasets as rd
from repro_torch.configs.base import GNNShape, get_config, list_archs
from repro_torch.graph import datasets as td
from _torch_threads import one_thread  # noqa: F401

GNN_ARCHS = ("gin-tu", "gat-cora", "meshgraphnet", "mace")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _same_batch(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "e_feat":
            assert np.array_equal(g[:, :3], w[:, :3])
            ulps = np.abs(g[:, 3].view(np.int32) - w[:, 3].view(np.int32))
            assert ulps.max() <= 2, ulps.max()
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("shape_name", SHAPES)
def test_build_gnn_batch_equals_reference_reduced(shape_name):
    cfg, rcfg = get_config("gin-tu"), r_get_config("gin-tu")
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    rshape = next(s for s in rcfg.shapes if s.name == shape_name)
    want = rd.build_gnn_batch(rcfg, rshape, reduce_to=16, seed=1)
    got = td.build_gnn_batch(cfg, shape, reduce_to=16, seed=1)
    _same_batch(got, want)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_build_gnn_batch_equals_reference_smoke_shape(arch):
    shape = GNNShape("smoke", 512, 2048, d_feat=32, kind="full")
    want = rd.build_gnn_batch(r_get_config(arch),
                              RShape("smoke", 512, 2048, d_feat=32,
                                     kind="full"), seed=0)
    _same_batch(td.build_gnn_batch(get_config(arch), shape, seed=0), want)


@pytest.mark.parametrize("n_nodes,n_edges", [
    (300, 1000),          # legacy host stream, deduplicated, sliced
    (5000, 200),          # legacy, fewer requested than made
    (40, 5000),           # legacy, tiled to n_edges
    (2 ** 17 + 1, 3000),  # counter stream (scale 18)
    (2 ** 17 + 1, 300000),  # counter stream, tiled past ef << scale
    (3000, 3000 * 80),    # counter stream at scale 12: edge factor past 64
])
def test_edges_for_each_branch_equals_reference(n_nodes, n_edges):
    ws, wd = rd._edges_for(n_nodes, n_edges, seed=5)
    gs, gd = td._edges_for(n_nodes, n_edges, seed=5)
    assert gs.dtype == gd.dtype == torch.int32
    assert np.array_equal(gs.numpy(), ws) and np.array_equal(gd.numpy(), wd)


def test_edges_for_past_scale_30_raises():
    with pytest.raises(ValueError, match="beyond the counter stream"):
        td._edges_for(2 ** 31, 2 ** 31)
    with pytest.raises(ValueError, match="beyond the counter stream"):
        rd._edges_for(2 ** 31, 2 ** 31)


def test_gnn_configs_equal_reference():
    assert set(GNN_ARCHS) <= set(list_archs())
    for arch in GNN_ARCHS:
        got, want = get_config(arch), r_get_config(arch)
        assert got.kind == want.kind == "gnn"
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
