"""The port's NN exchanges on the simulated mesh against the JAX
package's shard_map functions on 8 forced host devices, all in one
subprocess (``tests/_torch_dist_nn_main.py``, about 20 s): the
expert-parallel MoE (E >= tp and E < tp, with and without capacity
drops, keep masks compared), the decode psum, the row-sharded lookup
and the three compressed data-parallel modes.  The subprocess asserts
the values (float32 within rtol = atol = 1e-5; lookups exact); the
tests here read its per-case record: the collectives each case issued,
the keep sets and the residuals."""
import json
import os
import subprocess
import sys

import pytest
from _torch_threads import ONE_THREAD_ENV

_HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def cases():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable,
                          os.path.join(_HERE, "_torch_dist_nn_main.py")],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "OK torch-dist-nn (9 cases)", lines[-1]
    return json.loads(lines[-2])


@pytest.mark.parametrize("case,tp_sub", [
    ("moe_ep_e8", 1), ("moe_ep_e2", 2), ("moe_ep_e8_drops", 1),
    ("moe_ep_e2_drops", 2)])
def test_moe_ep_matches_jax_with_two_all_to_alls_a_co_owner(cases, case,
                                                            tp_sub):
    c = cases[case]
    assert c["counts"] == {"all-to-all": 2 * tp_sub, "total": 2 * tp_sub}
    assert c["max_err"] <= 1e-5
    if case.endswith("_drops"):
        # the same kept set as the JAX function, and some pairs dropped
        assert c["keep_equal"] is True
        assert 0.5 * c["pairs"] < c["kept"] < c["pairs"], c
    else:
        assert c["kept"] == c["pairs"]      # generous capacity: no drops


@pytest.mark.parametrize("case", ["moe_decode", "lookup"])
def test_one_psum_over_model(cases, case):
    assert cases[case]["counts"] == {"all-reduce": 1, "total": 1}


def test_sharded_lookup_is_exact(cases):
    assert cases["lookup"]["equal_jax"] is True
    assert cases["lookup"]["equal_no_mesh"] is True


@pytest.mark.parametrize("mode", ["none", "topk", "int8"])
def test_dp_step_matches_jax(cases, mode):
    """Losses, params, momentum and replica 0's residual were held in
    the subprocess; one pmean for the loss and one for the one leaf a
    step; only top-k keeps residuals, and each replica its own."""
    c = cases[f"dp_{mode}"]
    assert c["counts"] == {"all-reduce": 2, "total": 2}
    assert c["residual_nonzero"] is (mode == "topk")
    assert c["replicas_differ"] is (mode == "topk")
    assert len(c["losses"]) == 5 and c["losses"][-1] < c["losses"][0]
