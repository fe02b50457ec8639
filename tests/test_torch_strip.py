"""The port's 1D strip SpMSV (plain versions of the strip kernels and
of their per-sub-chunk form) against the JAX package's oracles on strip
arrays: ``spmsv_dense`` per strip for the candidates, and the jnp
``_dcsc_edges_examined``/``_dcsc_edges_examined_chunk`` for the edges
examined (tolerance 0: integers).  The strip Pallas kernels call
``pl.load``, which the installed jax lacks, so the oracles stand in;
the CUDA kernels are held against these plain versions on a card
(``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.local_ops import (_dcsc_edges_examined,
                                  _dcsc_edges_examined_chunk)
from repro.graph import formats as r_formats
from repro.graph import rmat as r_rmat
from repro.kernels.spmsv.ref import spmsv_dense as r_spmsv_dense
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.graph import formats as t_formats
from repro_torch.graph import rmat as t_rmat
from repro_torch.kernels.spmsv import strip
from _torch_threads import one_thread  # noqa: F401

P = 16


@pytest.fixture(scope="module")
def strips():
    t = t_formats.build_blocked_1d(t_rmat.rmat_graph(11, 16, seed=1,
                                                     device="cpu"),
                                   P, align=32, cap_pad=32)
    r = r_formats.build_blocked_1d(r_rmat.rmat_graph(11, 16, seed=1), P,
                                   align=32, cap_pad=32)
    return t, r


def _fronts(t, n):
    rng = np.random.default_rng(7)
    hub = np.zeros(n, bool)
    hub[int(np.argmax(t.deg_A.numpy().reshape(-1)))] = True
    return {"empty": np.zeros(n, bool), "hub": hub,
            "1%": rng.random(n) < 0.01, "30%": rng.random(n) < 0.3,
            "all": np.ones(n, bool)}


def _reference(r, f):
    """Candidates and edges examined of every strip from the oracles."""
    cand, ex = [], 0.0
    chunk = r.part.chunk
    for i in range(P):
        cand.append(np.asarray(r_spmsv_dense(
            jnp.asarray(r.edge_src[i]), jnp.asarray(r.row_idx[i]),
            jnp.asarray(r.nnz[i]), jnp.asarray(f), chunk, jnp.int32(0))))
        ex += float(_dcsc_edges_examined(jnp.asarray(r.jc[i]),
                                         jnp.asarray(r.cp[i]),
                                         jnp.asarray(r.nzc[i]),
                                         jnp.asarray(f)))
    return np.stack(cand), ex


@pytest.mark.parametrize("front", ["empty", "hub", "1%", "30%", "all"])
def test_strip_spmsv_plain_matches_oracles(strips, front):
    t, r = strips
    n, chunk = t.part.n, t.part.chunk
    f = _fronts(t, n)[front]
    fw = pack_bits(torch.from_numpy(f))
    cand, ex = strip.spmsv_strip_dcsc(t.jc, t.cp, t.nzc, t.row_idx, fw,
                                      chunk)
    want, want_ex = _reference(r, f)
    assert cand.shape == (P, chunk) and cand.dtype == torch.int32
    assert np.array_equal(cand.numpy(), want)
    assert ex.dtype == torch.int64 and float(ex) == want_ex
    assert int(strip.dcsc_edges_examined(t.jc, t.cp, t.nzc, fw)) == want_ex
    if front == "empty":
        assert bool((cand == INT_INF).all()) and int(ex) == 0


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("front", ["hub", "30%", "all"])
def test_strip_spmsv_chunk_plain_matches_oracles(strips, front, n_chunks):
    t, r = strips
    n, chunk = t.part.n, t.part.chunk
    f = _fronts(t, n)[front]
    words = pack_bits(torch.from_numpy(f)).reshape(P, n_chunks, -1)
    want, want_ex = _reference(r, f)
    acc, ex_sum = None, 0
    for k in range(n_chunks):
        sub = words[:, k].reshape(-1).contiguous()
        cand, ex = strip.spmsv_strip_dcsc_chunk(
            t.jc, t.cp, t.nzc, t.row_idx, sub, chunk, n=n, k=k,
            n_chunks=n_chunks)
        acc = cand if acc is None else torch.minimum(acc, cand)
        ex_sum += int(ex)
        sub_u32 = jnp.asarray(sub.numpy().view(np.uint32))
        ref_ex = sum(float(_dcsc_edges_examined_chunk(
            jnp.asarray(r.jc[i]), jnp.asarray(r.cp[i]),
            jnp.asarray(r.nzc[i]), sub_u32, k, n_chunks, chunk, n))
            for i in range(P))
        assert int(ex) == ref_ex, k
        assert int(strip.dcsc_edges_examined_chunk(
            t.jc, t.cp, t.nzc, sub, k, n_chunks, chunk, n)) == ref_ex
    # the steps min-combine to the whole-bitmap result
    assert np.array_equal(acc.numpy(), want) and ex_sum == want_ex


def test_strip_wrappers_check_their_inputs(strips):
    t, _ = strips
    fw = torch.zeros(t.part.n // 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        strip.spmsv_strip_dcsc(t.jc.to(torch.int64), t.cp, t.nzc, t.row_idx,
                               fw, t.part.chunk)
    with pytest.raises(ValueError, match="shapes"):
        strip.spmsv_strip_dcsc(t.jc, t.cp[:, 1:].contiguous(), t.nzc,
                               t.row_idx, fw, t.part.chunk)
    with pytest.raises(ValueError, match="sub-chunk"):
        strip.spmsv_strip_dcsc_chunk(t.jc, t.cp, t.nzc, t.row_idx, fw,
                                     t.part.chunk, n=t.part.n, k=0,
                                     n_chunks=2)
    with pytest.raises(ValueError, match="step"):
        strip.spmsv_strip_dcsc_chunk(t.jc, t.cp, t.nzc, t.row_idx,
                                     fw[: t.part.n // 64], t.part.chunk,
                                     n=t.part.n, k=2, n_chunks=2)
