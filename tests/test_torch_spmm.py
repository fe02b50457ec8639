"""The port's 2D SpMM (``core/spmm.py``) on the simulated mesh: equal to
the ``np.add.at`` oracle on the 1x1, 4x4, 2x8, 8x2, 1x16 and 16x1 grids
at the JAX package's ``rtol=atol=1e-4`` (its ``tests/_dist_spmm_main.py``
graph: scale 10, edge factor 8, seed 11), equal to the JAX ``spmm_2d``
on 1x1 in this process (the 4x4 and 2x8 grids against the JAX package
run in ``tests/_torch_dist_main.py``'s 16-device subprocess), and one
permute, one all-gather and one reduce-scatter recorded a call."""
import numpy as np
import pytest
import torch

from repro_torch.core import collectives
from repro_torch.core.spmm import make_spmm_fn, spmm_2d
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import one_thread  # noqa: F401

GRIDS = ((1, 1), (4, 4), (2, 8), (8, 2), (1, 16), (16, 1))


@pytest.fixture(scope="module")
def problem():
    e = rmat_graph(10, edge_factor=8, seed=11, device="cpu")
    x = np.random.default_rng(0).normal(size=(e.n, 8)).astype(np.float32)
    want = np.zeros_like(x)
    np.add.at(want, e.dst.numpy(), x[e.src.numpy()])
    return e, x, want


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_spmm_2d_equals_oracle(problem, grid):
    e, x, want = problem
    g = build_blocked(e, *grid, align=32, cap_pad=32)
    got = spmm_2d(g, torch.from_numpy(x),
                  make_local_mesh(*grid, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_spmm_2d_equals_reference_1x1(problem):
    from repro.core.spmm import spmm_2d as r_spmm_2d
    from repro.graph.formats import build_blocked as r_build_blocked
    from repro.graph.rmat import rmat_graph as r_rmat_graph
    from repro.launch.mesh import make_local_mesh as r_mesh
    e, x, _ = problem
    r_e = r_rmat_graph(10, edge_factor=8, seed=11)
    want = np.asarray(r_spmm_2d(r_build_blocked(r_e, 1, 1, align=32,
                                                cap_pad=32), x, r_mesh(1, 1)))
    got = spmm_2d(build_blocked(e, 1, 1, align=32, cap_pad=32),
                  torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


@pytest.mark.parametrize("grid", ((1, 1), (4, 4), (2, 8)),
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_one_permute_gather_and_reduce_scatter_a_call(problem, grid):
    e, x, _ = problem
    g = build_blocked(e, *grid, align=32, cap_pad=32)
    part = g.part
    fn = make_spmm_fn(part, "cpu")
    xb = torch.zeros(part.n, 8)
    xb[:part.n_orig] = torch.from_numpy(x)
    xb = xb.reshape(part.pr, part.pc, part.chunk, 8)
    with collectives.ScheduleRecorder() as rec:
        y1 = fn(g, xb)
        y2 = fn(g, xb)
    assert torch.equal(y1, y2) and y1.shape == xb.shape
    assert [(r.op, r.axes) for r in rec.records] == 2 * [
        ("ppermute", ("data", "model")), ("all_gather", ("data",)),
        ("psum_scatter", ("model",))]
    assert rec.counts() == {"collective-permute": 2, "all-gather": 2,
                            "reduce-scatter": 2, "total": 6}


def test_mesh_must_match_the_graph(problem):
    e, x, _ = problem
    g = build_blocked(e, 2, 2, align=32)
    with pytest.raises(ValueError, match="2x2 graph on a 4x1 mesh"):
        spmm_2d(g, torch.from_numpy(x), make_local_mesh(4, 1, device="cpu"))


def test_psum_scatter_axis_tiles_the_sum():
    x = torch.arange(2 * 3 * 6 * 2, dtype=torch.float32).reshape(2, 3, 6, 2)
    y = collectives.psum_scatter_axis(x, collectives.GRID_2D, "model")
    assert y.shape == (2, 3, 2, 2)
    for i in range(2):
        for j in range(3):
            assert torch.equal(y[i, j], x[i].sum(0)[2 * j:2 * j + 2])
    y = collectives.psum_scatter_axis(x[:, :, :4], collectives.GRID_2D,
                                      "data")
    assert y.shape == (2, 3, 2, 2)
    for i in range(2):
        assert torch.equal(y[i], x[:, :, :4].sum(0)[:, 2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="divides"):
        collectives.psum_scatter_axis(x[:, :, :5], collectives.GRID_2D,
                                      "model")
