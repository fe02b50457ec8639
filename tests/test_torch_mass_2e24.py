"""Frontier edge masses above 2**24: the port's 1x1 dense session against
the JAX package's at scale 20 (edge factor 16, seed 1, config defaults),
where level masses pass 2**24 and float32 sums stop being exact.

The reference sums m_f and m_u in float32 in XLA's order
(``repro/core/decomp.py:250-253``); the port sums them exactly in int64
and rounds once (``repro_torch/core/decomp.py::_masses``).  So the
``m_f`` column of ``level_stats`` may differ in its last bits, and no
fixed order can be matched: XLA's reduction order differs by backend
and version.  The test pins the difference as deliberate:

* parents, n_levels, counters and the mode column are equal;
* the port's n_f and m_f columns are the exact sums (from the tree's
  depths and the out-degrees, in numpy) rounded once to float32;
* ``|reference - port|`` on m_f stays within the float32 summation
  bound stated in ``_sum_bound``;
* both sides' modes follow Beamer's rule on the exact masses.

Both sessions share one edge list (the reference's generator; the
port's own generator is held against it in ``test_torch_graph.py``) and
build their own graphs once per module."""
import numpy as np
import pytest
import torch

from repro.configs.base import BFSConfig as RConfig
from repro.core.engine import plan_bfs as r_plan_bfs
from repro.graph.formats import build_blocked as r_build_blocked
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.launch.mesh import make_local_mesh as r_mesh
from repro_torch.configs.base import BFSConfig
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import EdgeList
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import one_thread  # noqa: F401

SCALE = 20
F32_EPS = 2.0 ** -24          # unit roundoff of float32


@pytest.fixture(scope="module")
def sessions():
    r = r_rmat_graph(SCALE, 16, seed=1)
    ref = r_plan_bfs(r_build_blocked(r, 1, 1), RConfig(), r_mesh(1, 1),
                     local_mode="dense").compile()
    t = EdgeList(n=r.n, src=torch.from_numpy(r.src.astype(np.int32)),
                 dst=torch.from_numpy(r.dst.astype(np.int32)),
                 m_input=r.m_input)
    port = plan_bfs(build_blocked(t, 1, 1), BFSConfig(),
                    make_local_mesh(1, 1, device="cpu"),
                    local_mode="dense").compile()
    deg = r.out_degrees()
    # the first vertex of nonzero degree, and the 1000th
    roots = [int(x) for x in np.flatnonzero(deg > 0)[[0, 1000]]]
    runs = [(root, ref.run(root), port.run(root)) for root in roots]
    return r, deg, port.plan.part.n, runs


def _depths(parents: np.ndarray, root: int) -> np.ndarray:
    """Each vertex's depth in the BFS tree (-1 unreached), by pointer
    doubling on the parents: hops to the current ancestor add up until
    every ancestor is the root."""
    n = parents.shape[0]
    reached = parents >= 0
    anc = np.where(reached, parents, np.arange(n)).astype(np.int64)
    hops = (reached & (np.arange(n) != root)).astype(np.int64)
    while (anc[reached] != root).any():
        hops = hops + hops[anc]
        anc = anc[anc]
    return np.where(reached, hops, -1)


def _exact_levels(deg, depth, n_levels):
    """Per level: (n_f, m_f, m_u, k_f) exactly, k_f the frontier vertices
    of nonzero degree (the nonzero terms of the m_f sum)."""
    out = []
    for lv in range(n_levels):
        front = depth == lv
        unvisited = (depth > lv) | (depth < 0)
        out.append((int(front.sum()), int(deg[front].sum()),
                    int(deg[unvisited].sum()),
                    int(np.count_nonzero(deg[front]))))
    return out


def _sum_bound(exact: int, k: int) -> float:
    """How far a float32 sum of k nonzero non-negative terms (zeros add
    exactly) may lie from the exact ``exact``, in any order: Higham's
    bound for recursive summation, gamma_{k-1} * sum|x| with gamma_j =
    j u / (1 - j u) and u = 2**-24 (Accuracy and Stability of Numerical
    Algorithms, 2nd ed., eq. 4.4; a pairwise tree is one such order).
    The port's value is ``exact`` rounded once, within u * exact, so the
    two sides may differ by the sum of both."""
    j = max(k - 1, 0) * F32_EPS
    return j / (1.0 - j) * exact + F32_EPS * exact


def _beamer_modes(levels, n_total, cfg):
    """The mode column by Beamer's rule on the exact masses: top-down to
    bottom-up when m_f > m_u / alpha, back when n_f < n / beta."""
    mode, modes = 0, []
    for n_f, m_f, m_u, _ in levels:
        if mode == 0 and m_f * cfg.alpha > m_u:
            mode = 1
        elif mode == 1 and n_f * cfg.beta < n_total:
            mode = 0
        modes.append(mode)
    return modes


@pytest.mark.parametrize("which", [0, 1])
def test_sessions_agree_and_masses_are_pinned_past_2e24(sessions, which):
    r, deg, n_total, runs = sessions
    root, want, got = runs[which]
    assert np.array_equal(want.parents, got.parents)
    assert want.n_levels == got.n_levels
    assert want.counters == got.counters
    n = got.n_levels
    ws, gs = want.level_stats[:n], got.level_stats[:n]
    assert np.array_equal(ws[:, 2], gs[:, 2])           # modes
    assert np.array_equal(ws[:, [0, 3, 4]], gs[:, [0, 3, 4]])
    depth = _depths(got.parents[: r.n], root)
    assert depth.max() == n - 1
    levels = _exact_levels(deg, depth, n)
    assert max(m_f for _, m_f, _, _ in levels) > 2 ** 24
    for lv, (n_f, m_f, _, k_f) in enumerate(levels):
        assert gs[lv, 0] == np.float32(n_f), lv
        assert gs[lv, 1] == np.float32(m_f), lv
        gap = abs(float(ws[lv, 1]) - float(gs[lv, 1]))
        assert gap <= _sum_bound(m_f, k_f), (lv, gap)
    cfg = BFSConfig()
    assert gs[:, 2].tolist() == _beamer_modes(levels, n_total, cfg)

