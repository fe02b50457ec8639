"""The port's frontier helpers against the JAX package's, bit for bit, on
random masks made with numpy (tolerance 0: the words are integers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as rf
from repro.core.compat import shard_map
from repro.core.partition import make_partition as r_make_partition
from repro.launch.mesh import make_local_mesh as r_make_local_mesh
from repro_torch.core import collectives
from repro_torch.core import frontier as tf
from repro_torch.core.partition import make_partition
from _torch_threads import one_thread  # noqa: F401


def _mask(rng, n, density):
    return rng.random(n) < density


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
def test_pack_unpack_test_bits(density):
    rng = np.random.default_rng(int(density * 100))
    m = _mask(rng, 32 * 37, density)
    want = np.asarray(rf.pack_bits(jnp.asarray(m)))
    got = tf.pack_bits(torch.from_numpy(m))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(tf.unpack_bits(got).numpy(),
                          np.asarray(rf.unpack_bits(jnp.asarray(want))))
    idx = rng.integers(0, m.size, 200).astype(np.int32)
    assert np.array_equal(
        tf.test_bits(got, torch.from_numpy(idx)).numpy(),
        np.asarray(rf.test_bits(jnp.asarray(want), jnp.asarray(idx))))


def test_pack_bits_batched_leading_dims():
    rng = np.random.default_rng(3)
    m = _mask(rng, 2 * 3 * 64, 0.4).reshape(2, 3, 64)
    got = tf.pack_bits(torch.from_numpy(m))
    assert got.shape == (2, 3, 2)
    for i in range(2):
        for j in range(3):
            want = np.asarray(rf.pack_bits(jnp.asarray(m[i, j])))
            assert np.array_equal(got[i, j].numpy().view(np.uint32), want)


def test_expand_bitmap_1x1_matches_reference():
    """At 1x1 the reference runs in this process: shard_map over its one
    device; the 2x2 and 4x4 grids are checked in the 16-device subprocess
    of test_torch_engine.py."""
    part = make_partition(300, 1, 1, align=32)
    rng = np.random.default_rng(5)
    front = _mask(rng, part.n, 0.2)
    mesh = r_make_local_mesh(1, 1)
    rpart = r_make_partition(300, 1, 1, align=32)
    perm = rpart.transpose_perm()
    P = jax.sharding.PartitionSpec

    def body(f):
        w, wire = rf.expand_bitmap(f.reshape(-1), perm, ("data", "model"))
        return w[None, None], wire

    fn = shard_map(body, mesh=mesh, in_specs=(P("data", "model"),),
                   out_specs=(P("data", "model"), P()), check_vma=False)
    w_ref, wire_ref = fn(jnp.asarray(front.reshape(1, 1, -1)))
    w, wire = tf.expand_bitmap(
        tf.pack_bits(torch.from_numpy(front.reshape(1, 1, -1))),
        collectives.perm_index(part.transpose_perm(), "cpu"))
    assert np.array_equal(w.numpy().view(np.uint32), np.asarray(w_ref))
    assert wire == np.float32(wire_ref)
