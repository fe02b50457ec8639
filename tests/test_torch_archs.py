"""The paper's Fig. 6 grid in the port: the workload registry against the
JAX package's, the §5.1 storage accounting and the strip ``col_ptr``,
kernel 1's DCSC and strip-col_ptr addressings (their plain versions
against the reference's ``spmsv_dense``, tolerance 0), the 2D archs'
sessions on a 1x1 grid, and the 1D archs against the reference on 4 and
16 strips (one subprocess, ``_torch_dist_archs_main.py 1d``; the 2D
archs' 2x2 and 4x4 run is ``test_torch_archs_2d.py``)."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import list_archs as r_list_archs
from repro.core.engine import plan_bfs as r_plan_bfs
from repro.graph.formats import build_blocked as r_build_blocked
from repro.graph.formats import build_blocked_1d as r_build_blocked_1d
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.kernels.spmsv.ref import spmsv_dense as r_spmsv_dense
from repro.launch.mesh import make_local_mesh as r_mesh
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core import local_ops
from repro_torch.core.engine import plan_bfs
from repro_torch.core.frontier import pack_bits
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels.spmsv import ops as sp_ops
from repro_torch.kernels.spmsv import strip
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)
# bfs-rmat-multiroot is bfs-rmat run through run_batch
# (tests/test_torch_batch.py)
_ARCHS_2D = [a for a in r_list_archs() if a.startswith("bfs-rmat")
             and r_get_config(a).decomposition == "2d"
             and a != "bfs-rmat-multiroot"]


@pytest.fixture(scope="module")
def edges():
    return r_rmat_graph(10, 8, seed=4), rmat_graph(10, 8, seed=4,
                                                   device="cpu")


def _roots(r_edges):
    deg = r_edges.out_degrees()
    return [int(x) for x in np.flatnonzero(deg > 0)[[0, 17, 300]]]


def _frontiers(n, rng, hub):
    one = np.zeros(n, bool)
    one[hub] = True
    return {"empty": np.zeros(n, bool), "one": one,
            "sparse": rng.random(n) < 0.01, "thirty": rng.random(n) < 0.3,
            "dense": np.ones(n, bool)}


def _same(want, got, local_mode):
    """Parents, n_levels, level_stats and counters equal; a kernel
    session's edges_examined is the frontier edge mass, the dense
    session's edges_useful."""
    assert np.array_equal(want.parents, got.parents)
    assert want.n_levels == got.n_levels
    assert np.array_equal(want.level_stats, got.level_stats)
    assert set(want.counters) == set(got.counters)
    for k, v in want.counters.items():
        if local_mode == "kernel" and k == "edges_examined":
            v = want.counters["edges_useful"]
        assert got.counters[k] == v, k


def test_registry_holds_every_reference_bfs_arch():
    want = sorted(a for a in r_list_archs() if a.startswith("bfs-rmat"))
    assert sorted(a for a in list_archs() if a.startswith("bfs")) == want
    for a in want:
        assert dataclasses.asdict(get_config(a)) == \
            dataclasses.asdict(r_get_config(a)), a


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (4, 4)])
def test_storage_words_match_reference_2d(edges, grid):
    r, t = edges
    g_r = r_build_blocked(r, *grid, align=32, cap_pad=32)
    g_t = build_blocked(t, *grid, align=32, cap_pad=32)
    for mode in ("csr", "dcsc"):
        assert g_t.storage_words(mode) == g_r.storage_words(mode), mode
    with pytest.raises(ValueError):
        g_t.storage_words("coo")


@pytest.mark.parametrize("p", [1, 4, 16])
def test_strip_col_ptr_and_storage_words_match_reference(edges, p):
    r, t = edges
    g_r = r_build_blocked_1d(r, p, align=32, cap_pad=32, with_col_ptr=True)
    g_t = build_blocked_1d(t, p, align=32, cap_pad=32, with_col_ptr=True)
    assert g_t.col_ptr.dtype == torch.int32
    assert np.array_equal(g_t.col_ptr.numpy(), g_r.col_ptr)
    lean = build_blocked_1d(t, p, align=32, cap_pad=32)
    assert lean.col_ptr is None and "col_ptr" not in lean.device_arrays()
    for k, v in lean.device_arrays().items():
        assert torch.equal(v, g_t.device_arrays()[k]), k
    for mode in ("csr", "dcsc"):
        assert g_t.storage_words(mode) == g_r.storage_words(mode), mode
        assert lean.storage_words(mode) == g_r.storage_words(mode), mode


def test_every_local_ops_entry_accounts_storage(edges):
    r, t = edges
    g2 = build_blocked(t, 2, 2, align=32, cap_pad=32)
    g1 = build_blocked_1d(t, 4, align=32, cap_pad=32)
    for combo in local_ops.registered_combos():
        ops = local_ops.get_local_ops(*combo)
        g = g2 if combo[0] == "2d" else g1
        assert ops.storage_words(g) == g.storage_words(combo[2]), combo


@pytest.mark.parametrize("i,j", [(0, 0), (1, 0), (1, 1)])
def test_spmsv_dcsc_plain_matches_reference(edges, i, j):
    """Kernel 1's DCSC addressing (plain version) against the reference's
    ``spmsv_dense`` on the same block, and its prep against the reference
    wrapper's found rule (``spmsv_block_dcsc``: the search over the
    padded ``jc``, the slot clamped to cap_nzc-1, ``slot < nzc``)."""
    r, t = edges
    g_r = r_build_blocked(r, 2, 2, align=32, cap_pad=32)
    g_t = build_blocked(t, 2, 2, align=32, cap_pad=32)
    part = g_t.part
    b = {k: v[i, j] for k, v in g_t.device_arrays().items()}
    rb = {k: v[i, j] for k, v in g_r.device_arrays().items()}
    coff = j * part.nc
    lens = b["cp"][1:] - b["cp"][:-1]
    hub = int(b["jc"][int(torch.argmax(lens))])
    for name, f in _frontiers(part.nc, np.random.default_rng(i + 2 * j),
                              hub).items():
        want = np.asarray(r_spmsv_dense(
            jnp.asarray(rb["edge_src"]), jnp.asarray(rb["row_idx"]),
            jnp.int32(int(rb["nnz"])), jnp.asarray(f), part.nr,
            jnp.int32(coff)))
        fm = torch.from_numpy(f)
        got = sp_ops.spmsv_dcsc_min(fm, b["jc"], b["cp"], b["nzc"],
                                    b["row_idx"], part.nr, coff)
        assert np.array_equal(got.numpy(), want), name
        ids, slot, offs, total = sp_ops.prepare_dcsc(fm, b["jc"], b["cp"],
                                                     b["nzc"])
        jc = jnp.asarray(rb["jc"])
        pos = jnp.minimum(jnp.searchsorted(jc, jnp.asarray(ids.numpy())),
                          jc.shape[0] - 1)
        found = (jc[pos] == jnp.asarray(ids.numpy())) & (pos < int(rb["nzc"]))
        assert np.array_equal(slot.numpy(), np.asarray(pos)), name
        assert np.array_equal((offs[1:] > offs[:-1]).numpy(),
                              np.asarray(found) & (lens[slot] > 0).numpy())
        assert total == int(np.where(f, np.diff(rb["col_ptr"]), 0).sum())
    with pytest.raises(ValueError, match="exceeds cap_f=1"):
        sp_ops.spmsv_dcsc_min(torch.ones(part.nc, dtype=torch.bool),
                              b["jc"], b["cp"], b["nzc"], b["row_idx"],
                              part.nr, coff, cap_f=1)


@pytest.mark.parametrize("p", [4, 16])
def test_spmsv_strips_csr_plain_matches_reference(edges, p):
    """Kernel 1's strip col_ptr addressing (plain version, all strips at
    once) against the reference's ``spmsv_dense`` strip by strip, its
    edges examined against the frontier's segments, and against the
    strip DCSC kernel's plain version."""
    r, t = edges
    g_r = r_build_blocked_1d(r, p, align=32, cap_pad=32)
    g_t = build_blocked_1d(t, p, align=32, cap_pad=32, with_col_ptr=True)
    part = g_t.part
    hub = int(torch.argmax(g_t.deg_A.reshape(-1)))
    for name, f in _frontiers(part.n, np.random.default_rng(p), hub).items():
        want = np.stack([np.asarray(r_spmsv_dense(
            jnp.asarray(g_r.edge_src[i]), jnp.asarray(g_r.row_idx[i]),
            jnp.int32(int(g_r.nnz[i])), jnp.asarray(f), part.chunk,
            jnp.int32(0))) for i in range(p)])
        fw = pack_bits(torch.from_numpy(f))
        got, ex = sp_ops.spmsv_strips_csr_min(fw, g_t.col_ptr, g_t.row_idx,
                                              part.chunk)
        assert np.array_equal(got.numpy(), want), name
        cp = g_t.col_ptr.numpy().astype(np.int64)
        assert int(ex) == int(np.where(f, np.diff(cp, axis=1), 0).sum())
        cand, ex_d = strip.spmsv_strip_dcsc(g_t.jc, g_t.cp, g_t.nzc,
                                            g_t.row_idx, fw, part.chunk)
        assert torch.equal(cand, got) and int(ex_d) == int(ex), name


def test_strip_csr_kernel_entry_needs_the_col_ptr(edges):
    r, t = edges
    mesh = make_local_mesh_1d(4, device="cpu")
    lean = build_blocked_1d(t, 4, align=32, cap_pad=32)
    for dec in ("1d", "1ds"):
        with pytest.raises(ValueError, match=r"lacks arrays \['col_ptr'\]"):
            plan_bfs(lean, get_config(f"bfs-rmat-{dec}"), mesh,
                     local_mode="kernel")


@pytest.mark.parametrize("arch", _ARCHS_2D)
def test_2d_arch_sessions_match_reference_1x1(edges, arch):
    """Each registered 2D arch, the port's dense and kernel sessions
    against the reference's dense session on one device."""
    r, t = edges
    ref = r_plan_bfs(r_build_blocked(r, 1, 1, align=32, cap_pad=32),
                     r_get_config(arch), r_mesh(1, 1),
                     local_mode="dense").compile()
    g_t = build_blocked(t, 1, 1, align=32, cap_pad=32)
    for local_mode in ("dense", "kernel"):
        eng = plan_bfs(g_t, get_config(arch), make_local_mesh(1, 1,
                                                              device="cpu"),
                       local_mode=local_mode).compile()
        for root in _roots(r):
            _same(ref.run(root), eng.run(root), local_mode)


def test_1d_archs_match_reference_on_4_and_16_strips():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable,
                          os.path.join(_HERE, "_torch_dist_archs_main.py"),
                          "1d"], capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "OK torch-dist-archs 1d" in out.stdout
