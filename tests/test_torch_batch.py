"""The port's pod-batched searches (``BFSEngine.run_batch``) and their
arch: against the JAX package's ``run_batch`` on 16 forced host devices
in one subprocess (``_torch_dist_pod_main.py``: 2d, 1d and 1ds, dense
and kernel, 4 roots a pod instrumented and 2 not, bit for bit),
then in this process the session contract (one shipment, one build a
roots-per-pod count), the reference's errors and the registry."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs.base import get_config as r_get_config
from repro_torch.configs.base import BFSConfig, get_config
from repro_torch.core.decomp import MAX_LEVELS
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def small():
    e = rmat_graph(9, 8, seed=9, device="cpu")
    deg = e.out_degrees().numpy()
    return e, [int(r) for r in np.flatnonzero(deg > 0)[:8]]


def test_batches_match_reference_on_pod_meshes():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_torch_dist_pod_main.py")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK torch-dist-pod" in r.stdout


def test_multiroot_arch_is_registered_as_the_reference_has_it():
    assert dataclasses.asdict(get_config("bfs-rmat-multiroot")) == \
        dataclasses.asdict(r_get_config("bfs-rmat-multiroot"))


@pytest.mark.parametrize("dec", ["2d", "1ds"])
def test_batch_ships_once_and_builds_once_a_shape(small, dec):
    """One graph shipment whatever the batches; one program build for
    each roots-per-pod count, kept for the next batch of that count;
    ``search_batch`` leaves the parents on the device in the
    ``(*grid, n_roots, chunk)`` layout.
    The rows come back in the caller's order, each with its own tree
    and the lockstep trip count of its scan position."""
    e, roots = small
    if dec == "2d":
        g = build_blocked(e, 2, 2, align=32, cap_pad=32)
        mesh = make_local_mesh(2, 2, device="cpu", pods=2)
        assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    else:
        g = build_blocked_1d(e, 4, align=32, cap_pad=32)
        mesh = make_local_mesh_1d(4, device="cpu", pods=2)
        assert mesh.shape == {"pod": 2, "data": 4}
    eng = plan_bfs(g, BFSConfig(decomposition=dec, storage="dcsc"), mesh,
                   local_mode="kernel").compile()
    assert (eng.ship_count, eng.trace_count, eng.batch_compile_s) == \
        (1, 1, 0.0)
    singles = eng.run_many(roots)
    b4 = eng.run_batch(roots)
    b4_again = eng.run_batch(roots[::-1])
    b2 = eng.run_batch(roots[:4])
    pis, levels, stats = eng.search_batch(roots)
    grid = (2, 2) if dec == "2d" else (4,)
    assert tuple(pis.shape) == (*grid, 8, g.part.chunk)
    assert np.array_equal(levels, b4.n_levels)
    assert np.array_equal(stats, b4.level_stats)
    assert (eng.ship_count, eng.trace_count) == (1, 3)
    assert eng.batch_compile_s > 0
    assert b4.level_stats.shape == (8, MAX_LEVELS, 5)
    assert np.array_equal(b4.roots, roots)
    assert np.array_equal(b4_again.parents, b4.parents[::-1])
    own = np.array([s.n_levels for s in singles])
    # pod 0 scans roots[0:4], pod 1 roots[4:8]: position j pairs j, j+4
    assert np.array_equal(b4.n_levels,
                          np.tile(np.maximum(own[:4], own[4:]), 2))
    assert np.array_equal(b2.n_levels, np.tile(np.maximum(own[:2],
                                                          own[2:4]), 2))
    for i, s in enumerate(singles):
        assert np.array_equal(b4.parents[i], s.parents)
        assert (b4.level_stats[i, s.n_levels:b4.n_levels[i], :2] == 0).all()
        assert (b4.level_stats[i, b4.n_levels[i]:] == 0).all()


def test_batch_errors(small):
    e, roots = small
    g = build_blocked(e, 1, 1, align=32, cap_pad=32)
    eng = plan_bfs(g, BFSConfig(), make_local_mesh(1, 1, device="cpu",
                                                   pods=2)).compile()
    with pytest.raises(ValueError, match="no 'rack' axis"):
        eng.run_batch(roots, pod_axis="rack")
    with pytest.raises(ValueError, match="3 roots do not split evenly "
                                         "over 2 pods"):
        eng.run_batch(roots[:3])
    with pytest.raises(ValueError, match="0 roots do not split"):
        eng.run_batch([])
    with pytest.raises(ValueError, match="out of range"):
        eng.run_batch([roots[0], e.n])
    with pytest.raises(ValueError, match="pods=0"):
        make_local_mesh(1, 1, device="cpu", pods=0)
    assert make_local_mesh(1, 1, device="cpu").shape == {"data": 1,
                                                         "model": 1}
    assert eng.ship_count == 1


def test_uninstrumented_batch_has_zero_stats(small):
    e, roots = small
    g = build_blocked_1d(e, 4, align=32, cap_pad=32)
    mesh = make_local_mesh_1d(4, device="cpu", pods=4)
    fast = plan_bfs(g, BFSConfig(decomposition="1d", instrument=False),
                    mesh).compile().run_batch(roots)
    full = plan_bfs(g, BFSConfig(decomposition="1d"),
                    mesh).compile().run_batch(roots)
    assert not fast.level_stats.any()
    assert np.array_equal(fast.parents, full.parents)
    assert np.array_equal(fast.n_levels, full.n_levels)
    assert full.level_stats[:, :, 3].sum() == full.n_levels.sum()
