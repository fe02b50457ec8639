"""Kernel 1's prep and walk bookkeeping on the CPU: the plain twin of the
device prep against the plain preps (``prepare``, ``prepare_dcsc``,
``prepare_strips``), kernel 1's synthetic cases of
``repro_torch.kernels.edge_cases`` through the three addressings against
the JAX package's oracles (tolerance 0: integer ids), the cost function,
and the ``cap_f`` checks that ride the level loop's read on the card.
The CUDA kernel is held against these plain versions in
``test_torch_cuda.py``, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.local_ops import _dcsc_edges_examined as r_dcsc_examined
from repro.graph.formats import build_blocked as r_build_blocked
from repro.graph.rmat import rmat_graph as r_rmat_graph
from repro.kernels.spmsv.ref import spmsv_dense as r_spmsv_dense
from repro_torch.core import decomp
from repro_torch.core.frontier import pack_bits, unpack_bits
from repro_torch.graph.formats import build_blocked, build_blocked_1d
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels import edge_cases as ec
from repro_torch.kernels.spmsv import ops as sp_ops
from _torch_threads import one_thread  # noqa: F401

BLOCK_N = 1 << 17              # a 10^5-edge hub column fits
STRIP_P, STRIP_N = 2, 1 << 18


@pytest.fixture(scope="module")
def blocks():
    r = r_rmat_graph(11, 16, seed=2)
    t = rmat_graph(11, 16, seed=2, device="cpu")
    return (r_build_blocked(r, 2, 2, align=32, cap_pad=32),
            build_blocked(t, 2, 2, align=32, cap_pad=32))


@pytest.fixture(scope="module")
def block_case():
    b = ec.spmsv_block(BLOCK_N, BLOCK_N, seed=3)
    segs = {"csr": sp_ops.csr(b[0], b[1]),
            "dcsc": sp_ops.dcsc(b[2], b[3], b[4], b[1])}
    caps = tuple(sp_ops.list_capacity(s) for s in segs.values())
    return b, segs, ec.spmsv_frontiers(b[0], b[5], caps, seed=3)


def _masks(n, rng, hub, absent):
    masks = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
             "1%": rng.random(n) < 0.01, "30%": rng.random(n) < 0.3}
    hub_m = np.zeros(n, bool)
    hub_m[hub] = True
    masks["hub"] = hub_m
    ab = np.zeros(n, bool)
    ab[absent] = True
    masks["absent from jc"] = ab
    return masks


@pytest.mark.parametrize("i,j", [(0, 0), (1, 0), (1, 1)])
def test_prep_twin_matches_the_plain_preps_2d(blocks, i, j):
    """The device prep's twin gives ``prepare``'s and ``prepare_dcsc``'s
    ids and their count; the walk follows the count against the
    threshold; ids absent from ``jc`` are listed but not found."""
    _, g = blocks
    part = g.part
    b = {k: v[i, j] for k, v in g.device_arrays().items()}
    lens = (b["col_ptr"][1:] - b["col_ptr"][:-1]).numpy()
    absent = np.flatnonzero(lens == 0)[:40]
    assert absent.size
    rng = np.random.default_rng(10 * i + j)
    for name, m in _masks(part.nc, rng, int(np.argmax(lens)),
                          absent).items():
        f = torch.from_numpy(m)
        words = pack_bits(f)
        for cap in (1, 64, part.nc):
            ids, count, walk = sp_ops.prep_plain(words, cap)
            assert count.dtype == torch.int64 and int(count) == m.sum()
            assert walk == (sp_ops.WALK_FRONTIER if m.sum() <= cap
                            else sp_ops.WALK_COLUMNS), (name, cap)
        p_ids, _, total = sp_ops.prepare(f, b["col_ptr"])
        d_ids, slot, offs, d_total = sp_ops.prepare_dcsc(
            f, b["jc"], b["cp"], b["nzc"])
        assert torch.equal(ids, p_ids) and torch.equal(ids, d_ids), name
        assert total == int(lens[m].sum())
        assert d_total == total, name
        if name == "absent from jc":
            assert ids.numel() == absent.size and d_total == 0
            assert int(((offs[1:] - offs[:-1]) > 0).sum()) == 0


@pytest.mark.parametrize("p", [4, 16])
def test_prep_twin_matches_prepare_strips(p):
    """The twin on the allgathered words gives ``prepare_strips``'s ids
    (taken once for all strips) and their count."""
    t = rmat_graph(11, 16, seed=4, device="cpu")
    g = build_blocked_1d(t, p, align=32, cap_pad=32, with_col_ptr=True)
    n = g.part.n
    deg = (g.col_ptr[:, 1:] - g.col_ptr[:, :-1]).sum(0).numpy()
    rng = np.random.default_rng(p)
    for name, m in _masks(n, rng, int(np.argmax(deg)),
                          np.flatnonzero(deg == 0)[:40]).items():
        words = pack_bits(torch.from_numpy(m))
        ids, count, _ = sp_ops.prep_plain(words, n)
        s_ids, offs, total = sp_ops.prepare_strips(words, g.col_ptr)
        assert torch.equal(ids, s_ids), name
        assert int(count) == s_ids.numel() == m.sum()
        assert offs.shape[0] == p * ids.numel() + 1
        assert total == int(deg[m].sum()), name


def _edge_src(col_ptr):
    lens = (col_ptr[1:] - col_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(torch.arange(lens.shape[0]), lens)


def test_kernel1_block_cases_match_reference(block_case):
    """The block cases (a 10^5-edge hub, the last word, columns absent
    from ``jc``, a frontier at and one past each walk threshold, ``nzc <
    cap_nzc``) through the csr and dcsc addressings, as words and as a
    mask: the reference's ``spmsv_dense`` candidates and, for the edges
    examined, its ``_dcsc_edges_examined``."""
    b, segs, fronts = block_case
    col_ptr, row_idx, jc, cp, nzc, hub = b
    assert int(nzc) < jc.shape[0]
    assert int(col_ptr[hub + 1] - col_ptr[hub]) >= ec.SPMSV_HUB_EDGES
    src = jnp.asarray(_edge_src(col_ptr).numpy().astype(np.int32))
    ri = jnp.asarray(row_idx.numpy())
    nnz = jnp.int32(row_idx.shape[0])
    coff = 3 * BLOCK_N
    for name, words in fronts.items():
        mask = unpack_bits(words)
        fm = jnp.asarray(mask.numpy())
        want = np.asarray(r_spmsv_dense(src, ri, nnz, fm, BLOCK_N,
                                        jnp.int32(coff)))
        ex = float(r_dcsc_examined(jnp.asarray(jc.numpy()),
                                   jnp.asarray(cp.numpy()),
                                   jnp.int32(int(nzc)), fm))
        for kind, seg in segs.items():
            for front in (words, mask):
                got, got_ex = sp_ops.spmsv_min(seg, front, BLOCK_N, coff)
                assert np.array_equal(got.numpy(), want), (name, kind)
                assert got_ex.dtype == torch.int64
                assert int(got_ex) == ex, (name, kind)
        if name.startswith("past"):
            t = int(name.split()[1])
            assert sp_ops.prep_plain(words, t)[2] == sp_ops.WALK_COLUMNS
            assert sp_ops.prep_plain(words, t + 1)[2] == sp_ops.WALK_FRONTIER


def test_kernel1_strip_cases_match_reference():
    """The strip case (one hub column with 10^5 edges in every strip)
    through the strip addressing: each strip's candidates are the
    reference's ``spmsv_dense`` of that strip, the edges examined the
    frontier's segments in every strip."""
    col_ptr, row_idx, hub = ec.spmsv_strips(STRIP_P, STRIP_N, seed=5)
    nr = STRIP_N // STRIP_P
    seg = sp_ops.strips(col_ptr, row_idx)
    fronts = ec.spmsv_frontiers(col_ptr, hub, (sp_ops.list_capacity(seg),),
                                seed=5)
    for name in ("empty", "hub", "last word", "absent from jc", "1%",
                 f"past {sp_ops.list_capacity(seg)}"):
        words = fronts[name]
        fm = jnp.asarray(unpack_bits(words).numpy())
        got, ex = sp_ops.spmsv_min(seg, words, nr)
        want_ex = 0
        for s in range(STRIP_P):
            cp_s = col_ptr[s]
            nnz = int(cp_s[-1])
            want = np.asarray(r_spmsv_dense(
                jnp.asarray(_edge_src(cp_s).numpy().astype(np.int32)),
                jnp.asarray(row_idx[s, :nnz].numpy()), jnp.int32(nnz), fm,
                nr, jnp.int32(0)))
            assert np.array_equal(got[s].numpy(), want), (name, s)
            lens = (cp_s[1:] - cp_s[:-1]).numpy()
            want_ex += int(lens[unpack_bits(words).numpy()].sum())
        assert int(ex) == want_ex, name
    hub_lens = col_ptr[:, hub + 1] - col_ptr[:, hub]
    assert int(hub_lens.min()) >= ec.SPMSV_HUB_EDGES


def test_public_entries_are_the_folded_body(block_case):
    """The three public names run ``spmsv_min`` on their addressing; the
    2D ones take the mask or its words."""
    b, segs, fronts = block_case
    col_ptr, row_idx, jc, cp, nzc, _ = b
    words = fronts["1%"]
    mask = unpack_bits(words)
    want = sp_ops.spmsv_min(segs["csr"], words, BLOCK_N, 7)[0]
    assert torch.equal(sp_ops.spmsv_csr_min(mask, col_ptr, row_idx, BLOCK_N,
                                            7), want)
    assert torch.equal(sp_ops.spmsv_csr_min(words, col_ptr, row_idx,
                                            BLOCK_N, 7), want)
    assert torch.equal(sp_ops.spmsv_dcsc_min(words, jc, cp, nzc, row_idx,
                                             BLOCK_N, 7), want)
    stacked = sp_ops.spmsv_strips_csr_min(words, col_ptr.reshape(1, -1),
                                          row_idx.reshape(1, -1), BLOCK_N)
    assert torch.equal(stacked[0][0], sp_ops.spmsv_min(
        segs["csr"], words, BLOCK_N)[0])
    with pytest.raises(ValueError, match="int32 words"):
        sp_ops.spmsv_csr_min(words[:-1], col_ptr, row_idx, BLOCK_N, 0)
    with pytest.raises(ValueError, match=r"\(n/32,\) int32 words"):
        sp_ops.spmsv_strips_csr_min(mask, col_ptr.reshape(1, -1),
                                    row_idx.reshape(1, -1), BLOCK_N)
    with pytest.raises(ValueError, match="exceeds cap_f=2"):
        sp_ops.spmsv_min(segs["dcsc"], words, BLOCK_N, 0, cap_f=2)


def test_forward_cost_reads_the_kernel_tables_bytes():
    """The bytes the kernel table has carried for each addressing (the
    ids, offsets, pointers, row ids and candidates), with the device
    prep's words only where the caller states them."""
    n, e, nr = 1000, 50_000, 1 << 20
    assert sp_ops.forward_cost("csr", n, e, nr) == (
        0, 4 * n + 8 * (n + 1) + 8 * n + 4 * e + 4 * nr)
    assert sp_ops.forward_cost("dcsc", n, e, nr) == (
        0, 4 * n + 4 * n + 8 * (n + 1) + 4 * n + 4 * e + 4 * nr)
    assert sp_ops.forward_cost("strips", n, e, nr, p=16) == (
        0, 4 * n + 8 * (16 * n + 1) + 4 * 16 * n + 4 * e + 4 * 16 * nr)
    words = nr // 32
    assert sp_ops.forward_cost("csr", n, e, nr, n_words=words)[1] == \
        sp_ops.forward_cost("csr", n, e, nr)[1] + 4 * words


def test_deferred_cap_checks_ride_the_tail_read():
    """Inside a level loop a card call's ``cap_f`` check waits for the
    loop's read (``reduce_state``): the first call past its cap raises
    there with the message the CPU raises at the call; none past it
    leaves the state as it was.  Outside a loop the check reads at once
    (here on CPU counts, as the card's calls hand them in)."""
    pi = torch.tensor([0, -1, -1, 2], dtype=torch.int32)
    front = torch.tensor([True, False, True, False])
    deg = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    want = decomp.reduce_state(pi, front, deg)
    with sp_ops.deferred_cap_checks() as pending:
        sp_ops._bound(torch.tensor(3), 4)
        sp_ops._bound(torch.tensor(4), 4)
        assert len(pending) == 2
        assert decomp.reduce_state(pi, front, deg, pending=pending) == want
        assert pending == []
        for count, cap in ((3, 4), (9, 5), (12, 5)):
            sp_ops._bound(torch.tensor(count), cap)
        with pytest.raises(ValueError,
                           match="frontier of 9 columns exceeds cap_f=5"):
            decomp.reduce_state(pi, front, deg, pending=pending)
        assert pending == []
        sp_ops._bound(torch.tensor(7), 0)
        assert pending == []
    with pytest.raises(ValueError, match="frontier of 6 columns exceeds "
                                         "cap_f=5"):
        sp_ops._bound(torch.tensor(6), 5)
