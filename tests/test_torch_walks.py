"""The plain versions and launch preparation behind the walks of the
bottom-up sub-step (one launch for all p strips of a 1D level) and of
the pipelined strip SpMSV (the frontier walk or step k's columns),
against the JAX package's oracles (tolerance 0: integer ids), on a real
R-MAT strip layout and on the synthetic cases of
``repro_torch.kernels.edge_cases``.  The CUDA kernels are held against
these plain versions in ``test_torch_cuda.py``, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.local_ops import (_dcsc_edges_examined,
                                  _dcsc_edges_examined_chunk)
from repro.kernels.bottomup.ref import bottomup_substep as r_bottomup
from repro.kernels.spmsv.ref import spmsv_dense as r_spmsv_dense
from repro_torch.configs.base import BFSConfig
from repro_torch.core import local_ops
from repro_torch.core.engine import plan_bfs
from repro_torch.core.frontier import INT_INF, pack_bits, unpack_bits
from repro_torch.graph.formats import build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels import build
from repro_torch.kernels import edge_cases as ec
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.bottomup import ref as bu_ref
from repro_torch.kernels.spmsv import strip
from repro_torch.launch.mesh import make_local_mesh_1d
from _torch_threads import one_thread  # noqa: F401

P = 16
BU_P, BU_CHUNK = 2, 1 << 15          # bottom-up cases: 65,536 sources
ST_P, ST_CHUNK = 4, 1 << 14          # strip cases: a 10^4-edge column fits


@pytest.fixture(scope="module")
def strips():
    e = rmat_graph(11, 16, seed=1, device="cpu")
    return build_blocked_1d(e, P, align=32, cap_pad=32)


@pytest.fixture(scope="module")
def bu_cases():
    return ec.bottomup_cases(BU_P, BU_CHUNK)


@pytest.fixture(scope="module")
def st_case():
    g, hub, empty = ec.strip_graph(ST_P, ST_CHUNK)
    return g, hub, empty, ec.strip_frontiers(ST_P, ST_CHUNK, hub)


def _ref_strip(rp, ci, fw, cv, ne, col_offset=0):
    """The JAX package's bottom-up oracle on one strip."""
    return np.asarray(r_bottomup(
        jnp.asarray(rp.numpy()), jnp.asarray(ci.numpy()),
        jnp.asarray(fw.numpy().view(np.uint32)), jnp.asarray(cv.numpy()),
        jnp.int32(col_offset), jnp.int32(ne)))


# ---------------------------------------------------------------------------
# Bottom-up: the stacked entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("front_frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("done_frac", [0.0, 0.5, 1.0])
def test_stacked_bottomup_plain_matches_strips_and_reference(
        strips, front_frac, done_frac):
    g, part = strips, strips.part
    rng = np.random.default_rng(int(10 * front_frac + 100 * done_frac))
    fw = pack_bits(torch.from_numpy(rng.random(part.n) < front_frac))
    cv = torch.from_numpy((rng.random((P, part.chunk)) < done_frac)
                          .astype(np.int32))
    got = bu_ops.bottomup_substep_strips(g.row_ptr, g.col_idx, fw, cv,
                                         g.nnz)
    assert got.shape == (P, part.chunk) and got.dtype == torch.int32
    for i in range(P):
        args = (g.row_ptr[i], g.col_idx[i], fw, cv[i], 0, int(g.nnz[i]))
        assert torch.equal(got[i], bu_ops.bottomup_substep(*args)), i
        assert torch.equal(got[i], bu_ref.bottomup_substep(*args)), i
        assert np.array_equal(got[i].numpy(), _ref_strip(*args[:4], args[5]))
    if done_frac == 1.0:
        assert bool((got == INT_INF).all())


@pytest.mark.parametrize("case", ["lengths", "cut", "completed",
                                  "last word"])
def test_bottomup_edge_cases_plain_match_reference(bu_cases, case):
    rp, ci, fw, cv, ne = bu_cases[case]
    got = bu_ops.bottomup_substep_strips(rp, ci, fw, cv, ne)
    found = 0
    for i in range(BU_P):
        want = _ref_strip(rp[i], ci[i], fw, cv[i], int(ne[i]))
        assert np.array_equal(got[i].numpy(), want), i
        # the single-segment entry with a column offset, as 2D calls it
        one = bu_ops.bottomup_substep(rp[i], ci[i], fw, cv[i], 777,
                                      int(ne[i]))
        assert torch.equal(one, torch.where(got[i] == INT_INF, INT_INF,
                                            got[i] + 777))
        found += int((got[i] != INT_INF).sum())
    if case == "completed":
        assert found == 0
    else:
        assert found > 0


def test_bottomup_edge_cases_have_what_they_promise(bu_cases):
    rp, ci, fw, cv, ne = bu_cases["lengths"]
    lens = (rp[:, 1:] - rp[:, :-1]).reshape(-1)
    for length in (0, 1, 31, 32, 33, 1100):
        assert bool((lens == length).any()), length
    # a row past 1,024 edges whose first hit lies past edge 32
    got = bu_ops.bottomup_substep_strips(rp, ci, fw, cv, ne)[0]
    rows = torch.nonzero((lens[:BU_CHUNK] > 1024) & (got != INT_INF)
                         & (cv[0] == 0)).reshape(-1)
    pos = [int(torch.nonzero(ci[0, int(rp[0, r]):int(rp[0, r + 1])]
                             == got[r])[0]) for r in rows]
    assert max(pos) > 32
    cut = bu_cases["cut"]
    assert bool((cut[4] < rp[:, -1]).all())
    cut_row = [int(torch.searchsorted(rp[i], cut[4][i], right=True)) - 1
               for i in range(BU_P)]
    assert all(int(rp[i, r]) < int(cut[4][i]) < int(rp[i, r + 1])
               for i, r in enumerate(cut_row))
    last = bu_cases["last word"][2]
    assert bool((last[:-1] == 0).all()) and int(last[-1]) == -1


def test_bottomup_launch_prep(strips):
    cv = torch.zeros((P, strips.part.chunk), dtype=torch.int32)
    out = bu_ops.new_output(cv)
    assert out.shape == cv.shape and out.dtype == torch.int32
    assert bu_ops.new_output(cv[0]).shape == (strips.part.chunk,)


def test_stacked_bottomup_checks_inputs(strips):
    g = strips
    fw = torch.zeros(g.part.n // 32, dtype=torch.int32)
    cv = torch.zeros((P, g.part.chunk), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        bu_ops.bottomup_substep_strips(g.row_ptr, g.col_idx, fw, cv,
                                       g.nnz.long())
    with pytest.raises(ValueError, match="shapes"):
        bu_ops.bottomup_substep_strips(g.row_ptr[:, 1:].contiguous(),
                                       g.col_idx, fw, cv, g.nnz)
    with pytest.raises(ValueError, match="shapes"):
        bu_ops.bottomup_substep_strips(g.row_ptr, g.col_idx, fw, cv,
                                       g.nnz[1:])


def test_stacked_bottomup_raises_when_the_library_cannot_load(monkeypatch):
    def load(self):
        raise RuntimeError(f"cannot load {self.name}")

    def fail(*a, **kw):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(build.CudaKernel, "load", load)
    monkeypatch.setattr(bu_ops, "bottomup_substep_strips_plain", fail)
    monkeypatch.setattr(strip, "spmsv_strip_dcsc_chunk_plain", fail)
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="cannot load bottomup_substep"):
        bu_ops.bottomup_substep_strips(meta(2, 9), meta(2, 30), meta(2),
                                       meta(2, 8), meta(2))
    with pytest.raises(RuntimeError, match="cannot load spmsv_strip_chunk"):
        strip.spmsv_strip_dcsc_chunk(meta(2, 8), meta(2, 9), meta(2),
                                     meta(2, 30), meta(2), 32, n=64, k=0,
                                     n_chunks=1)


@pytest.mark.parametrize("dec", ["1d", "1ds"])
def test_kernel_session_scans_all_strips_once_a_level(strips, monkeypatch,
                                                      dec):
    """A kernel session's bottom-up level is one call of the stacked
    entry, with the shipped (p,) int32 edge counts; the parents equal
    the dense session's, which scans strip by strip."""
    calls = []
    real = bu_ops.bottomup_substep_strips

    def rec(row_ptr, col_idx, f_words, cvec, n_edges):
        calls.append(n_edges)
        return real(row_ptr, col_idx, f_words, cvec, n_edges)
    monkeypatch.setattr(bu_ops, "bottomup_substep_strips", rec)
    mesh = make_local_mesh_1d(P, device="cpu")
    cfg = BFSConfig(decomposition=dec, storage="dcsc")
    eng = plan_bfs(strips, cfg, mesh, local_mode="kernel").compile()
    dense = plan_bfs(strips, cfg, mesh, local_mode="dense").compile()
    assert local_ops.get_local_ops(dec, "dense", "dcsc").bottomup_strips \
        is None
    root = int(np.flatnonzero(strips.deg_A.reshape(-1).numpy() > 0)[0])
    calls.clear()
    got = eng.run(root)
    n_bu = int((got.level_stats[:got.n_levels, 2] == 1).sum())
    assert n_bu > 0 and len(calls) == n_bu
    for ne in calls:
        assert ne.dtype == torch.int32 and ne.shape == (P,)
        assert torch.equal(ne, strips.nnz)
    calls.clear()
    want = dense.run(root)
    assert not calls
    assert np.array_equal(got.parents, want.parents)
    assert np.array_equal(got.level_stats, want.level_stats)


# ---------------------------------------------------------------------------
# Strip SpMSV of one pipelined step: the frontier walk's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_frontier_ids_of_a_step_are_its_set_bits(st_case, n_chunks):
    g, hub, _, fronts = st_case
    n, chunk = g.part.n, g.part.chunk
    sub = chunk // n_chunks
    for name, fw in fronts.items():
        words = fw.reshape(ST_P, n_chunks, -1)
        full = unpack_bits(fw)
        for k in range(n_chunks):
            ids = strip.frontier_ids_chunk(words[:, k].reshape(-1), ST_P,
                                           chunk, k)
            gid = torch.arange(n)
            in_k = (gid % chunk >= k * sub) & (gid % chunk < (k + 1) * sub)
            want = torch.nonzero(full & in_k).reshape(-1)
            assert ids.dtype == torch.int32
            assert torch.equal(ids.to(torch.int64), want), (name, k)


def test_sub_range_ends_are_columns_of_the_case_graph(st_case):
    g, hub, empty, fronts = st_case
    ends = ec.sub_range_ends(ST_P, ST_CHUNK)
    cols = set()
    for s in range(ST_P):
        cols |= set(g.jc[s, :int(g.nzc[s])].tolist())
    assert set(ends.tolist()) <= cols and hub in cols
    assert int(g.nzc[empty]) == 0 and g.maxdeg_col >= ec.HUB_EDGES
    assert int(unpack_bits(fronts["sub-range ends"]).sum()) == ends.shape[0]


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_looking_frontier_ids_up_finds_the_live_slots(st_case, n_chunks):
    """The frontier walk's lookup, in torch: each step's ids searched in
    every strip's jc[:nzc] find exactly the slots the column test marks
    live."""
    g, _, _, fronts = st_case
    n, chunk = g.part.n, g.part.chunk
    for name, fw in fronts.items():
        words = fw.reshape(ST_P, n_chunks, -1)
        for k in range(n_chunks):
            sub = words[:, k].reshape(-1).contiguous()
            live = strip.live_slots_chunk(g.jc, g.nzc, sub, k, n_chunks,
                                          chunk, n)
            ids = strip.frontier_ids_chunk(sub, ST_P, chunk, k)
            found = torch.zeros_like(live)
            for s in range(ST_P):
                jcs = g.jc[s, :int(g.nzc[s])]
                slot = torch.searchsorted(jcs, ids)
                ok = slot < jcs.shape[0]
                ok[ok.clone()] &= jcs[slot[ok]] == ids[ok]
                found[s, slot[ok]] = True
            assert torch.equal(found, live), (name, k)


@pytest.mark.parametrize("front", ["empty", "sub-range ends", "hub",
                                   "last word", "1%", "30%", "all"])
def test_strip_chunk_plain_on_edge_cases_matches_oracles(st_case, front):
    g, _, _, fronts = st_case
    n, chunk = g.part.n, g.part.chunk
    fw = fronts[front]
    f = unpack_bits(fw).numpy()
    want = np.stack([np.asarray(r_spmsv_dense(
        jnp.asarray(g.edge_src[i].numpy()), jnp.asarray(g.row_idx[i].numpy()),
        jnp.asarray(g.nnz[i].numpy()), jnp.asarray(f), chunk, jnp.int32(0)))
        for i in range(ST_P)])
    want_ex = sum(float(_dcsc_edges_examined(
        jnp.asarray(g.jc[i].numpy()), jnp.asarray(g.cp[i].numpy()),
        jnp.asarray(g.nzc[i].numpy()), jnp.asarray(f))) for i in range(ST_P))
    for c in (1, 4):
        words = fw.reshape(ST_P, c, -1)
        acc, ex_sum = None, 0
        for k in range(c):
            sub = words[:, k].reshape(-1).contiguous()
            cand, ex = strip.spmsv_strip_dcsc_chunk(
                g.jc, g.cp, g.nzc, g.row_idx, sub, chunk, n=n, k=k,
                n_chunks=c)
            ref_ex = sum(float(_dcsc_edges_examined_chunk(
                jnp.asarray(g.jc[i].numpy()), jnp.asarray(g.cp[i].numpy()),
                jnp.asarray(g.nzc[i].numpy()),
                jnp.asarray(sub.numpy().view(np.uint32)), k, c, chunk, n))
                for i in range(ST_P))
            assert int(ex) == ref_ex, (c, k)
            acc = cand if acc is None else torch.minimum(acc, cand)
            ex_sum += int(ex)
        assert np.array_equal(acc.numpy(), want) and ex_sum == want_ex, c


def test_strip_chunk_launch_prep(st_case):
    g = st_case[0]
    cap = strip.list_capacity(g.cap_nzc, 4)
    L = g.cap_nzc.bit_length()
    num, den = strip.PROBE_COST
    # the frontier walk while count * L * num/den <= cap_nzc / C
    assert cap * L * 4 * num <= g.cap_nzc * den < (cap + 1) * L * 4 * num
    assert strip.list_capacity(1, 4) == 1
    cand, stats, scratch = strip.chunk_scratch(ST_P, ST_CHUNK, cap, "cpu")
    assert cand.shape == (ST_P, ST_CHUNK) and cand.dtype == torch.int32
    assert bool((cand == INT_INF).all())
    assert stats.dtype == torch.int64 and stats.tolist() == [0, 0, 0, 0]
    # the ids, then 2 slot-range bounds per (strip, owner)
    assert scratch.dtype == torch.int32
    assert scratch.numel() == cap + 2 * ST_P * ST_P


def test_strip_chunk_walk_rule(st_case):
    g, _, _, fronts = st_case
    cap = strip.list_capacity(g.cap_nzc, 4)
    sub = lambda name: fronts[name].reshape(ST_P, 4, -1)[:, 0].reshape(-1)
    assert strip.chunk_walk(sub("empty"), cap) == strip.WALK_FRONTIER
    assert strip.chunk_walk(sub("sub-range ends"), cap) == \
        strip.WALK_FRONTIER
    assert strip.chunk_walk(sub("all"), cap) == strip.WALK_COLUMNS
    assert strip.chunk_walk(sub("all"), 0) == strip.WALK_COLUMNS
    assert strip.chunk_walk(sub("empty"), 0) == strip.WALK_FRONTIER
    assert strip.popcount(sub("all")) == ST_P * ST_CHUNK // 4


# ---------------------------------------------------------------------------
# Strip SpMSV against the whole bitmap (kernel 3): the walks of kernel 4
# at one step, any number of strips
# ---------------------------------------------------------------------------


def _oracle_whole(g, fw, p):
    """Candidates and edges examined of every strip from the JAX
    package's ``spmsv_dense`` and ``_dcsc_edges_examined``."""
    f = unpack_bits(fw).numpy()
    chunk = g.part.chunk
    want = np.stack([np.asarray(r_spmsv_dense(
        jnp.asarray(g.edge_src[i].numpy()), jnp.asarray(g.row_idx[i].numpy()),
        jnp.asarray(g.nnz[i].numpy()), jnp.asarray(f), chunk, jnp.int32(0)))
        for i in range(p)])
    ex = sum(float(_dcsc_edges_examined(
        jnp.asarray(g.jc[i].numpy()), jnp.asarray(g.cp[i].numpy()),
        jnp.asarray(g.nzc[i].numpy()), jnp.asarray(f))) for i in range(p))
    return want, ex


@pytest.mark.parametrize("front", ["empty", "sub-range ends", "hub",
                                   "last word", "1%", "30%", "all"])
def test_strip_plain_on_edge_cases_matches_oracles(st_case, front):
    """Kernel 3's entry (its plain version on the CPU) on the synthetic
    cases: an empty strip, a 10^4-edge column, sub-range ends, the last
    word; equal to the chunk entry at one step."""
    g, _, _, fronts = st_case
    fw = fronts[front]
    cand, ex = strip.spmsv_strip_dcsc(g.jc, g.cp, g.nzc, g.row_idx, fw,
                                      ST_CHUNK)
    want, want_ex = _oracle_whole(g, fw, ST_P)
    assert np.array_equal(cand.numpy(), want) and int(ex) == want_ex
    one = strip.spmsv_strip_dcsc_chunk(g.jc, g.cp, g.nzc, g.row_idx, fw,
                                       ST_CHUNK, n=g.part.n, k=0, n_chunks=1)
    assert torch.equal(one[0], cand) and int(one[1]) == int(ex)


def test_strip_launch_prep(st_case):
    """Kernel 3's threshold is list_capacity at one step, its scratch the
    id list alone (no slot ranges), and its walk the same rule on the
    whole bitmap."""
    g, _, _, fronts = st_case
    cap = strip.list_capacity(g.cap_nzc, 1)
    L = g.cap_nzc.bit_length()
    num, den = strip.PROBE_COST
    # the frontier walk while count * L * num/den <= cap_nzc
    assert cap * L * num <= g.cap_nzc * den < (cap + 1) * L * num
    assert cap >= 4 * strip.list_capacity(g.cap_nzc, 4) - 4
    cand, stats, ids = strip.walk_scratch(ST_P, ST_CHUNK, cap, "cpu")
    assert cand.shape == (ST_P, ST_CHUNK) and bool((cand == INT_INF).all())
    assert stats.dtype == torch.int64 and stats.tolist() == [0, 0, 0, 0]
    assert ids.dtype == torch.int32 and ids.numel() == cap
    assert strip.chunk_walk(fronts["empty"], cap) == strip.WALK_FRONTIER
    assert strip.chunk_walk(fronts["hub"], cap) == strip.WALK_FRONTIER
    assert strip.chunk_walk(fronts["all"], cap) == strip.WALK_COLUMNS
    assert strip.chunk_walk(fronts["hub"], 0) == strip.WALK_COLUMNS
    assert strip.chunk_walk(fronts["all"], g.part.n) == strip.WALK_FRONTIER
    n_set = strip.popcount(fronts["30%"])
    assert strip.chunk_walk(fronts["30%"], n_set) == strip.WALK_FRONTIER
    assert strip.chunk_walk(fronts["30%"], n_set - 1) == strip.WALK_COLUMNS


def test_strip_takes_40_strips():
    """No cap on the strips for kernel 3 (kernel 4's tile prefix caps it
    at MAX_CHUNK_STRIPS): 40 strips through the entry and the launch
    prep."""
    p, chunk = 40, 1 << 14
    assert p > strip.MAX_CHUNK_STRIPS
    g, hub, empty = ec.strip_graph(p, chunk, edge_factor=1)
    fronts = ec.strip_frontiers(p, chunk, hub)
    cap = strip.list_capacity(g.cap_nzc, 1)
    cand, stats, ids = strip.walk_scratch(p, chunk, cap, "cpu")
    assert cand.shape == (p, chunk) and ids.numel() == cap
    for front in ("hub", "30%"):
        got, ex = strip.spmsv_strip_dcsc(g.jc, g.cp, g.nzc, g.row_idx,
                                         fronts[front], chunk)
        want, want_ex = _oracle_whole(g, fronts[front], p)
        assert np.array_equal(got.numpy(), want) and int(ex) == want_ex
        assert bool((got[empty] == INT_INF).all())
    assert strip.chunk_walk(fronts["hub"], cap) == strip.WALK_FRONTIER
    assert strip.chunk_walk(fronts["30%"], cap) == strip.WALK_COLUMNS
    # the chunk kernel's wrapper refuses what its tile prefix cannot hold
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most"):
        strip.launch_chunk(meta(p, 8), meta(p, 9), meta(p), meta(p, 30),
                           meta(p), 32, p * 32, 0, 1)
