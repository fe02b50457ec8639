"""The port's ``khop_sample`` (``graph/sampler.py``) against the JAX
package's on the 200-node graph of its ``tests/test_models.py``.

The two draw from different generators (a ``torch.Generator`` here,
``jax.random.randint`` bits there), so the test holds the deterministic
part exactly and the draws by their law: the tree's layout (senders,
receivers, edge mask, seed count, the seeds first) equals the JAX
package's; every child lies in its parent's CSR row and an isolated
parent samples itself; where every vertex has degree 1 there is nothing
to draw and the node ids equal the JAX package's too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.sampler import khop_sample as r_khop_sample
from repro_torch.graph.sampler import khop_sample
from _torch_threads import one_thread  # noqa: F401

FANOUTS = (5, 3)


def _graph(rng, n=200, max_deg=8):
    deg = rng.integers(0, max_deg, n)
    rp = np.zeros(n + 1, np.int32)
    rp[1:] = np.cumsum(deg)
    ci = rng.integers(0, n, int(rp[-1])).astype(np.int32)
    return rp, ci


def _both(rp, ci, seeds, gen_seed=0):
    want = jax.jit(lambda k, r, c, s: r_khop_sample(k, r, c, s, FANOUTS))(
        jax.random.PRNGKey(0), jnp.asarray(rp), jnp.asarray(ci),
        jnp.asarray(seeds))
    got = khop_sample(torch.Generator().manual_seed(gen_seed),
                      torch.from_numpy(rp), torch.from_numpy(ci),
                      torch.from_numpy(seeds), FANOUTS)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def sampled():
    rng = np.random.default_rng(0)
    rp, ci = _graph(rng)
    seeds = rng.integers(0, 200, 16).astype(np.int32)
    return rp, ci, seeds, _both(rp, ci, seeds)


def test_tree_layout_equals_reference(sampled):
    rp, ci, seeds, (got, want) = sampled
    assert got["n_seed"] == int(want["n_seed"]) == 16
    for k in ("senders", "receivers", "edge_mask"):
        assert got[k].dtype == (torch.float32 if k == "edge_mask"
                                else torch.int32)
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert got["node_ids"].shape == want["node_ids"].shape == (16 + 80 + 240,)
    assert np.array_equal(got["node_ids"][:16].numpy(), seeds)
    assert (got["receivers"] < 16 + 80).all() and (got["senders"] >= 16).all()


@pytest.mark.parametrize("gen_seed", [0, 1, 2])
def test_children_lie_in_their_parents_rows(sampled, gen_seed):
    rp, ci, seeds, _ = sampled
    got = khop_sample(torch.Generator().manual_seed(gen_seed),
                      torch.from_numpy(rp), torch.from_numpy(ci),
                      torch.from_numpy(seeds), FANOUTS)
    ids = got["node_ids"].numpy()
    seen_isolated = 0
    for s, r in zip(got["senders"].numpy(), got["receivers"].numpy()):
        parent, child = ids[r], ids[s]
        row = ci[rp[parent]:rp[parent + 1]]
        if row.size:
            assert child in row, (parent, child)
        else:
            assert child == parent
            seen_isolated += 1
    assert seen_isolated > 0       # the graph has isolated vertices
    # the draws spread over a row (a uniform pick, not its first entry)
    assert len(set(ids[16:96].tolist())) > 20


def test_degree_one_graph_node_ids_equal_reference():
    rng = np.random.default_rng(1)
    n = 200
    rp = np.arange(n + 1, dtype=np.int32)
    ci = rng.integers(0, n, n).astype(np.int32)
    seeds = rng.integers(0, n, 16).astype(np.int32)
    got, want = _both(rp, ci, seeds, gen_seed=5)
    assert np.array_equal(got["node_ids"].numpy(), want["node_ids"])


def test_isolated_last_vertex_does_not_read_past_col_idx():
    """The last vertex isolated: its row start equals len(col_idx); the
    JAX gather clamps there, the port clamps before the gather."""
    rp = np.array([0, 2, 3, 3], np.int32)
    ci = np.array([1, 2, 0], np.int32)
    seeds = np.array([2, 2, 0], np.int32)
    got, want = _both(rp, ci, seeds)
    ids = got["node_ids"].numpy()
    assert np.array_equal(ids[3:9], [2] * 6)
    assert np.array_equal(ids[3:9], want["node_ids"][3:9])
