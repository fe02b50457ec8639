"""The port's Graph500 validator (``repro_torch.core.validate``) against
the JAX package's ``core/validate.py``, tolerance 0: the report plumbing,
the clean matrix of every registered (decomposition, storage,
instrument) on 1x1 and 1 strip in both local modes, the ``(6,)`` verdict
counts of clean and seeded-fault trees, the host-array edge cases, the
device ``run(validate=True)`` and the collective budget; the 2x2 and
4-strip meshes run in one subprocess (``_torch_dist_validate_main.py``).
The fixture is the reference tests' graph: R-MAT scale 8, edge factor
8, seed 4, ``align=32``, ``cap_pad=32``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.base import BFSConfig as RConfig
from repro.core import comm_model as r_comm_model
from repro.core import validate as RV
from repro.core.engine import plan_bfs as r_plan_bfs
from repro.graph.formats import build_blocked as r_build_2d
from repro.graph.formats import build_blocked_1d as r_build_1d
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.launch.mesh import make_local_mesh as r_mesh
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d
from repro.runtime.faultinject import inject_parents as r_inject
from repro_torch.configs.base import BFSConfig
from repro_torch.core import comm_model, ref
from repro_torch.core import validate as V
from repro_torch.core.decomp import get_decomposition
from repro_torch.core.engine import plan_bfs
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
from repro_torch.runtime.faultinject import PARENT_FAULTS, inject_parents
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)
ROOT = 5
DECOMPS = ("1d", "1ds", "2d")


@pytest.fixture(scope="module")
def fixed():
    """(reference edges, port edges, {d: (reference graph, port graph,
    reference mesh, port mesh)}) on 1x1 and 1 strip."""
    r_e = r_rmat_graph(8, edge_factor=8, seed=4)
    t_e = rmat_graph(8, edge_factor=8, seed=4, device="cpu")
    g = {"2d": (r_build_2d(r_e, 1, 1, align=32, cap_pad=32),
                build_blocked(t_e, 1, 1, align=32, cap_pad=32),
                r_mesh(1, 1), make_local_mesh(1, 1, device="cpu"))}
    strips = (r_build_1d(r_e, 1, align=32, cap_pad=32, with_col_ptr=True),
              build_blocked_1d(t_e, 1, align=32, cap_pad=32,
                               with_col_ptr=True),
              r_mesh_1d(1), make_local_mesh_1d(1, device="cpu"))
    g["1d"] = g["1ds"] = strips
    return r_e, t_e, g


@pytest.fixture(scope="module")
def engines(fixed):
    """{d: (reference engine, port kernel engine)}, uninstrumented, as the
    reference tests' ``engines`` fixture."""
    _, _, g = fixed
    out = {}
    for d in DECOMPS:
        g_r, g_t, m_r, m_t = g[d]
        out[d] = (r_plan_bfs(g_r, RConfig(decomposition=d,
                                          instrument=False), m_r).compile(),
                  plan_bfs(g_t, BFSConfig(decomposition=d, instrument=False),
                           m_t, local_mode="kernel").compile())
    return out


def test_checks_and_report_plumbing_match_reference():
    assert V.CHECKS == RV.CHECKS
    assert (V.CAP, V.DOUBLING_ROUNDS) == (RV.CAP, RV.DOUBLING_ROUNDS)
    assert 2 ** V.DOUBLING_ROUNDS > V.CAP
    for counts in ([0, 0, 0, 0, 0, 17], [1, 0, 2, 0, 0, 17],
                   [0, 3, 1, 9, 4, 250]):
        got = V.report_from_counts(3, np.array(counts))
        want = RV.report_from_counts(3, np.array(counts))
        assert got.to_json() == want.to_json()
        assert got.summary() == want.summary()
        assert str(V.ValidationError(got)) == str(RV.ValidationError(want))
    assert V.report_from_counts(3, [0] * 5 + [17]) == V.ValidationReport(
        3, True, dict.fromkeys(V.CHECKS, 0), 17)


@pytest.mark.parametrize("local_mode", ["kernel", "dense"])
@pytest.mark.parametrize("instrument", [False, True])
@pytest.mark.parametrize("storage", ["csr", "dcsc"])
@pytest.mark.parametrize("d", DECOMPS)
def test_clean_run_validates(fixed, engines, d, storage, instrument,
                             local_mode):
    """A clean run validates in every registered combination, its verdict
    counts equal the JAX package's for the same parents, and the host
    oracle agrees."""
    r_e, t_e, g = fixed
    eng = plan_bfs(g[d][1], BFSConfig(decomposition=d, storage=storage,
                                      instrument=instrument), g[d][3],
                   local_mode=local_mode).compile()
    res = eng.run(ROOT, validate=True)
    rep = res.validation
    assert rep.ok and rep.root == ROOT
    assert not any(rep.violations.values())
    assert rep.n_tree == int(np.sum(res.parents >= 0))
    want = RV.validate_parents(engines[d][0], ROOT, res.parents)
    assert rep.to_json() == want.to_json()
    ok, msg = ref.validate_parents(t_e.n, t_e.src.numpy(), t_e.dst.numpy(),
                                   ROOT, res.parents)
    assert ok, msg


@pytest.mark.parametrize("kind", PARENT_FAULTS)
@pytest.mark.parametrize("d", DECOMPS)
def test_fault_counts_equal_reference(fixed, engines, d, kind):
    """For the same (root, parents) the port's (6,) counts equal the JAX
    package's, clean and after each seeded fault, and every fault the
    reference flags the port flags."""
    r_e, t_e, _ = fixed
    r_eng, t_eng = engines[d]
    good = t_eng.run(ROOT).parents
    assert np.array_equal(good, r_eng.run(ROOT).parents)
    assert V.validate_parents(t_eng, ROOT, good).to_json() == \
        RV.validate_parents(r_eng, ROOT, good).to_json()
    for seed in range(3):
        bad, info = r_inject(kind, good, ROOT, seed, n=r_e.n, src=r_e.src,
                             dst=r_e.dst, chunk=r_eng.plan.part.chunk)
        want = RV.validate_parents(r_eng, ROOT, bad)
        got = V.validate_parents(t_eng, ROOT, bad)
        assert got.to_json() == want.to_json(), (d, kind, seed, info)
        assert not got.ok


def test_padded_block_shaped_and_wrong_length_inputs(fixed, engines):
    r_e, _, _ = fixed
    for d in DECOMPS:
        r_eng, eng = engines[d]
        part = eng.plan.part
        parents = eng.run(ROOT).parents
        want = RV.validate_parents(r_eng, ROOT, parents).to_json()
        full = np.full(part.n, -1, np.int64)
        full[: part.n_orig] = parents
        assert V.validate_parents(eng, ROOT, full).to_json() == want
        grid = (part.p,) if d != "2d" else (part.pr, part.pc)
        blocks = full.reshape(*grid, part.chunk)
        assert V.validate_parents(eng, ROOT, blocks).to_json() == want
        with pytest.raises(ValueError, match="entries"):
            V.validate_parents(eng, ROOT, np.zeros(7, np.int64))
        with pytest.raises(ValueError, match="out of range"):
            V.validate_parents(eng, part.n_orig, parents)


def test_int64_garbage_is_clamped_as_the_reference_clamps_it(fixed, engines):
    """Host garbage above int32 and below -1 reads as the JAX package
    reads it: an out-of-range parent, and not in the tree."""
    r_eng, eng = engines["1ds"]
    parents = eng.run(ROOT).parents.copy()
    v = int(np.flatnonzero(parents >= 0)[3])
    for value in (parents[v] | (1 << 40), -(1 << 40), -7):
        bad = parents.copy()
        bad[v] = value
        got = V.validate_parents(eng, ROOT, bad)
        assert got.to_json() == \
            RV.validate_parents(r_eng, ROOT, bad).to_json(), value
        assert not got.ok


def test_isolated_root_validates(fixed, engines):
    """A root with no edges yields a one-vertex tree, still valid."""
    _, t_e, _ = fixed
    deg = t_e.out_degrees().numpy()
    lonely = int(np.argmin(deg))
    assert deg[lonely] == 0, "the fixture graph has isolated vertices"
    for d in DECOMPS:
        res = engines[d][1].run(lonely, validate=True)
        assert res.validation.n_tree == 1 and res.validation.ok, d
        assert res.validation.to_json() == RV.validate_parents(
            engines[d][0], lonely, res.parents).to_json()


@pytest.mark.parametrize("d", DECOMPS)
def test_run_validate_raises_on_corrupted_device_parents(fixed, engines, d):
    """``run(root, validate=True)`` checks the device tensor the search
    returned: corrupt it there (a phantom parent) and the run raises
    ``ValidationError`` with the report ``validate_parents`` gives for the
    same array."""
    _, t_e, g = fixed
    eng = plan_bfs(g[d][1], BFSConfig(decomposition=d), g[d][3],
                   local_mode="kernel").compile()
    good = eng.run(ROOT).parents
    bad, info = inject_parents("phantom_parent", good, ROOT, 1, n=t_e.n,
                               src=t_e.src, dst=t_e.dst)
    search = eng._fn

    def corrupted(root):
        pi, level, ctr, stats = search(root)
        flat = pi.reshape(-1).clone()
        flat[info["vertex"]] = info["new"]
        return flat.reshape(pi.shape), level, ctr, stats

    eng._fn = corrupted
    with pytest.raises(V.ValidationError, match="INVALID parent tree") as ei:
        eng.run(ROOT, validate=True)
    assert ei.value.report == V.validate_parents(eng, ROOT, bad)
    assert ei.value.report.violations["tree_edge_missing"] >= 1


def test_pieced_walk_gives_the_same_counts(fixed, engines, monkeypatch):
    """Walking each shard's slots in pieces of 7 slots changes no count."""
    r_e, _, _ = fixed
    for d in DECOMPS:
        r_eng, eng = engines[d]
        good = eng.run(ROOT).parents
        bad, _ = r_inject("drop_subrange", good, ROOT, 0, n=r_e.n,
                          src=r_e.src, dst=r_e.dst, chunk=64)
        want = [V.validate_parents(eng, ROOT, x) for x in (good, bad)]
        monkeypatch.setattr(V, "PIECE", 7)
        eng._vfn = None
        got = [V.validate_parents(eng, ROOT, x) for x in (good, bad)]
        monkeypatch.undo()
        eng._vfn = None
        assert got == want, d


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4), (4, 1), (4,), (1,)])
def test_csr_side_hook_enumerates_the_reference_slots(fixed, grid):
    """The port's ``local_edges`` reads the CSR side; the JAX package's
    hook the CSC side (2D: ``edge_src``/``row_idx``) or ``edge_dst``
    (strips).  Over each shard the valid (u, v) pairs are the same
    multiset, and over the mesh the edge list."""
    _, t_e, _ = fixed
    if len(grid) == 2:
        g = build_blocked(t_e, *grid, align=32, cap_pad=32)
        entry = get_decomposition("2d")
    else:
        g = build_blocked_1d(t_e, grid[0], align=32, cap_pad=32)
        entry = get_decomposition("1ds")
    part = g.part
    arrays = g.device_arrays()
    everything = []
    for shard in np.ndindex(*g.nnz.shape):
        cap = int(arrays["col_idx"][shard].numel())
        u, v, valid = entry.local_edges(arrays, part, shard, 0, cap)
        assert int(u.min()) >= 0 and int(u.max()) < part.n
        assert int(v.min()) >= 0 and int(v.max()) < part.n
        got = np.unique((u[valid] * part.n + v[valid]).numpy(),
                        return_counts=True)
        k = int(g.nnz[shard])
        if len(grid) == 2:    # the JAX package's _local_edges_2d
            i, j = shard
            ru = j * part.nc + g.edge_src[shard][:k].to(torch.int64)
            rv = i * part.nr + g.row_idx[shard][:k].to(torch.int64)
        else:                 # the JAX package's _local_edges_1d
            (i,) = shard
            ru = g.col_idx[shard][:k].to(torch.int64)
            rv = i * part.chunk + g.edge_dst[shard][:k].to(torch.int64)
        want = np.unique((ru * part.n + rv).numpy(), return_counts=True)
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), shard
        assert int(valid.sum()) == k
        everything.append(got[0])
    keys = np.sort(np.concatenate(everything))
    want = np.sort(t_e.src.numpy().astype(np.int64) * part.n
                   + t_e.dst.numpy())
    assert np.array_equal(keys, want)


@pytest.mark.parametrize("d", ["2d", "1d", "1ds"])
def test_validate_collective_budget_matches_reference(d):
    assert comm_model.validate_collective_budget(d) == \
        r_comm_model.validate_collective_budget(d)


def test_validate_collective_budget_rejects_unknown_decomposition():
    for budget in (comm_model.validate_collective_budget,
                   r_comm_model.validate_collective_budget):
        with pytest.raises(ValueError, match="no validator collective"):
            budget("3d")


def test_counts_match_reference_on_2x2_and_4_strips():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_torch_dist_validate_main.py")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK torch-dist-validate (15 faults flagged" in r.stdout
