"""The port's local-discovery kernels: their plain versions and the ref.py
twins against the JAX package's oracles (tolerance 0: integer ids), and
the no-fallback rule of the wrappers.  The CUDA kernels themselves are
held against their plain versions in test_torch_cuda.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontier import pack_bits as r_pack_bits
from repro.kernels.bottomup.ref import bottomup_substep as r_bottomup
from repro.kernels.spmsv.ops import _scatter_min as r_scatter_min
from repro.kernels.spmsv.ref import spmsv_dense as r_spmsv_dense
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.graph import rmat as trmat
from repro_torch.graph.formats import build_blocked
from repro_torch.kernels import build
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.bottomup import ref as bu_ref
from repro_torch.kernels.spmsv import ops as sp_ops
from repro_torch.kernels.spmsv import ref as sp_ref
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def graph():
    e = trmat.rmat_graph(10, 16, seed=1, device="cpu")
    return build_blocked(e, 2, 2, align=32, cap_pad=32)


def _block(g, i, j):
    return {k: v[i, j] for k, v in g.device_arrays().items()}


def _frontiers(b, nc, rng):
    lens = (b["col_ptr"][1:] - b["col_ptr"][:-1]).numpy()
    one = np.zeros(nc, bool)
    one[int(np.flatnonzero(lens)[0])] = True
    maxdeg = np.zeros(nc, bool)
    maxdeg[int(np.argmax(lens))] = True
    return {"empty": np.zeros(nc, bool), "one": one, "maxdeg": maxdeg,
            "sparse": rng.random(nc) < 0.01, "thirty": rng.random(nc) < 0.3,
            "dense": np.ones(nc, bool)}


def _gathered(b, ids, maxdeg):
    """The (cap_f, maxdeg) dest rows the JAX package's gather kernel
    writes, -1 padded, built in numpy."""
    cp, ri = b["col_ptr"].numpy(), b["row_idx"].numpy()
    out = np.full((max(len(ids), 1), max(maxdeg, 1)), -1, np.int32)
    for k, u in enumerate(ids):
        seg = ri[cp[u]:cp[u + 1]]
        out[k, :len(seg)] = seg
    return out


@pytest.mark.parametrize("i,j", [(0, 0), (1, 1), (0, 1)])
def test_spmsv_plain_and_twins_match_reference(graph, i, j):
    part = graph.part
    b = _block(graph, i, j)
    col_offset = j * part.nc
    for name, f in _frontiers(b, part.nc, np.random.default_rng(i * 2 + j)).items():
        ids = np.flatnonzero(f).astype(np.int32)
        want = np.asarray(r_spmsv_dense(
            jnp.asarray(b["edge_src"].numpy()), jnp.asarray(b["row_idx"].numpy()),
            jnp.int32(int(b["nnz"])), jnp.asarray(f), part.nr,
            jnp.int32(col_offset)))
        got = sp_ops.spmsv_csr_min(torch.from_numpy(f), b["col_ptr"],
                                   b["row_idx"], part.nr, col_offset)
        assert np.array_equal(got.numpy(), want), name
        twin = sp_ref.spmsv_dense(b["edge_src"], b["row_idx"], b["nnz"],
                                  torch.from_numpy(f), part.nr, col_offset)
        assert np.array_equal(twin.numpy(), want), name
        dst = _gathered(b, ids, graph.maxdeg_col)
        ids_pad = np.full(dst.shape[0], part.nc, np.int32)
        ids_pad[:len(ids)] = ids
        sm = np.asarray(r_scatter_min(jnp.asarray(dst), jnp.asarray(ids_pad),
                                      jnp.int32(col_offset), part.nr,
                                      dst.shape[0]))
        assert np.array_equal(sm, want), name
        assert np.array_equal(
            sp_ref.scatter_min(torch.from_numpy(dst), torch.from_numpy(ids_pad),
                               col_offset, part.nr).numpy(), want), name


def test_spmsv_segment_offsets():
    col_ptr = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int32)
    offs, total = sp_ops.segment_offsets(torch.tensor([0, 1, 2, 3],
                                                      dtype=torch.int32),
                                         col_ptr)
    assert offs.tolist() == [0, 3, 3, 7, 8] and total == 8
    ids, offs, total = sp_ops.prepare(torch.tensor([False, True, True, True]),
                                      col_ptr, cap_f=3)
    assert ids.tolist() == [1, 2, 3] and ids.dtype == torch.int32
    assert offs.tolist() == [0, 0, 4, 5] and total == 5
    ids, offs, total = sp_ops.prepare(torch.zeros(4, dtype=torch.bool),
                                      col_ptr)
    assert ids.numel() == 0 and offs.tolist() == [0] and total == 0
    with pytest.raises(ValueError, match="exceeds cap_f=2"):
        sp_ops.prepare(torch.ones(4, dtype=torch.bool), col_ptr, cap_f=2)


def _segment(g, i, j, s):
    part = g.part
    b = _block(g, i, j)
    seg_id = (j - s) % part.pc
    e0 = int(b["seg_ptr"][seg_id])
    e1 = int(b["seg_ptr"][seg_id + 1])
    chunk = part.chunk
    rp = b["row_ptr"][seg_id * chunk:(seg_id + 1) * chunk + 1] - e0
    ue = b["col_idx"][e0:e0 + g.cap_seg]
    ve = b["edge_dst"][e0:e0 + g.cap_seg] - seg_id * chunk
    return rp, ue, ve, e1 - e0, j * part.nc


@pytest.mark.parametrize("s", [0, 1])
@pytest.mark.parametrize("front_frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("done_frac", [0.0, 0.5, 1.0])
def test_bottomup_plain_and_twin_match_reference(graph, s, front_frac,
                                                 done_frac):
    part = graph.part
    rng = np.random.default_rng(int(10 * front_frac + 100 * done_frac) + s)
    rp, ue, ve, n_edges, col_offset = _segment(graph, 1, 1, s)
    front = rng.random(part.nc) < front_frac
    cvec = (rng.random(part.chunk) < done_frac).astype(np.int32)
    words = np.asarray(r_pack_bits(jnp.asarray(front)))
    want = np.asarray(r_bottomup(
        jnp.asarray(rp.numpy()), jnp.asarray(ue.numpy()), jnp.asarray(words),
        jnp.asarray(cvec), jnp.int32(col_offset), jnp.int32(n_edges)))
    f_words = pack_bits(torch.from_numpy(front))
    args = (rp, ue, f_words, torch.from_numpy(cvec), col_offset, n_edges)
    got = bu_ops.bottomup_substep(*args)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(bu_ref.bottomup_substep(*args).numpy(), want)
    assert np.array_equal(bu_ref.bottomup_substep(*args, ve_win=ve).numpy(),
                          want)
    if front_frac == 1.0 and done_frac == 0.0:
        assert (got.numpy() != INT_INF).any()


# ---------------------------------------------------------------------------
# No fallback: a tensor that is not on the CPU never takes the plain path
# ---------------------------------------------------------------------------


def _meta(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _fail_plain(*a, **kw):
    raise AssertionError("the plain version ran for a non-CPU tensor")


@pytest.fixture
def broken_load(monkeypatch):
    def load(self):
        raise RuntimeError(f"cannot load {self.name}")
    monkeypatch.setattr(build.CudaKernel, "load", load)
    monkeypatch.setattr(sp_ops, "spmsv_csr_min_plain", _fail_plain)
    monkeypatch.setattr(bu_ops, "bottomup_substep_plain", _fail_plain)
    monkeypatch.setattr(trmat, "rmat_edges_counter_plain", _fail_plain)


def test_wrappers_raise_when_the_library_cannot_load(broken_load):
    with pytest.raises(RuntimeError, match="cannot load spmsv_csr_min"):
        sp_ops.spmsv_csr_min(torch.empty(8, dtype=torch.bool, device="meta"),
                             _meta(9), _meta(30), 8, 0)
    with pytest.raises(RuntimeError, match="cannot load bottomup_substep"):
        bu_ops.bottomup_substep(_meta(9), _meta(64), _meta(2), _meta(8), 0,
                                10)
    with pytest.raises(RuntimeError, match="cannot load rmat_counter"):
        trmat.rmat_edges_counter(8, 16, device="meta")


def test_rmat_kernel_path_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel path runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        trmat.rmat_edges_counter(8, 16, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        trmat.rmat_graph(8, 16, generator="counter")


def test_wrappers_check_inputs():
    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sp_ops.spmsv_csr_min(torch.zeros(7, dtype=torch.bool), i32.long(),
                             i32, 8, 0)
    with pytest.raises(ValueError, match="bool mask over the block's 7"):
        sp_ops.spmsv_csr_min(torch.zeros(8, dtype=torch.bool), i32, i32, 8, 0)
    with pytest.raises(ValueError, match="rows"):
        bu_ops.bottomup_substep(i32, i32, i32, i32, 0, 4)
    with pytest.raises(ValueError, match="n_edges"):
        bu_ops.bottomup_substep(torch.zeros(9, dtype=torch.int32), i32, i32,
                                i32, 0, 99)
