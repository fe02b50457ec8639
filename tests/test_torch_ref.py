"""The port's sequential BFS oracles (``core/ref.py``: Algorithms 1 and
2 and depths from a parent array) against the JAX package's numpy
oracles on seeded graphs, tolerance 0: the two searches visit in the
same order, so their parent arrays are equal, not only their depths."""
import numpy as np
import pytest

from repro.core import ref as r_ref
from repro_torch.core import ref
from _torch_threads import one_thread  # noqa: F401

CASES = [(60, 200, 0), (300, 900, 1), (500, 400, 2), (1, 0, 3), (40, 0, 4)]


def _graph(n, m, seed):
    """A seeded directed graph: random edges, both directions of each,
    with self-loops and repeats kept (the oracles take any edge list)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return (np.concatenate([src, dst]).astype(np.int64),
            np.concatenate([dst, src]).astype(np.int64))


@pytest.mark.parametrize("n,m,seed", CASES)
@pytest.mark.parametrize("search", ["bfs_topdown", "bfs_bottomup"])
def test_search_oracles_match_reference(n, m, seed, search):
    src, dst = _graph(n, m, seed)
    rng = np.random.default_rng(seed + 100)
    for root in {0, n - 1, int(rng.integers(0, n))}:
        want = getattr(r_ref, search)(n, src, dst, root)
        got = getattr(ref, search)(n, src, dst, root)
        assert got.dtype == np.int64
        assert np.array_equal(got, want), root
        ok, why = ref.validate_parents(n, src, dst, root, got)
        assert ok, why


@pytest.mark.parametrize("n,m,seed", CASES)
def test_depths_from_parents_match_reference(n, m, seed):
    """Depths from either search's parents equal the reference's and the
    level-synchronous depths; an unreached vertex stays -1."""
    src, dst = _graph(n, m, seed)
    root = int(np.random.default_rng(seed).integers(0, n))
    want_depth = ref.bfs_depths(n, src, dst, root)
    for parent in (ref.bfs_topdown(n, src, dst, root),
                   ref.bfs_bottomup(n, src, dst, root)):
        got = ref.depths_from_parents(n, parent, root)
        assert np.array_equal(got, r_ref.depths_from_parents(n, parent,
                                                             root))
        assert np.array_equal(got, want_depth)
    lone = np.full(n, -1)
    lone[root] = root
    assert (ref.depths_from_parents(n, lone, root) >= 0).sum() == 1
