"""The 2D level epilogue (``kernels/epilogue/ops.py``) on the CPU: its
plain twin against the sequence the 2D steps ran before it (the
``where`` update, ``pack_bits`` of the newly found mask, the loop's
``_masses``) on the cases of ``edge_cases.epilogue_cases`` over 1x1, 2x2
and 1x4 grids and chunks that are not a multiple of the kernel's block;
bottom-up slots applied in sub-step order; and the 2D steps' words and
masses on a 2x2 grid against ``pack_bits`` and ``_masses`` of the parents
they wrote, with compact updates and the split ring too.  The kernel
against the twin is ``test_torch_cuda.py``'s."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import BFSConfig
from repro_torch.core import decomp
from repro_torch.core.engine import plan_bfs
from repro_torch.core.frontier import INT_INF, pack_bits
from repro_torch.core.steps import bottomup_level, topdown_level
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels import edge_cases as ec
from repro_torch.kernels.epilogue import ops as ep
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import one_thread  # noqa: F401

# (pr, pc, chunk): chunks of 3 and 37 groups of 32, off the kernel's
# 32 groups a block step
GRIDS = [(1, 1, 96), (2, 2, 64), (1, 4, 32 * 37)]


def _before(pi, deg, cand, recv, root):
    """The 2D steps' update as it was: the top-down ``where`` (the start:
    the root's own id), or the bottom-up exchange with the self slot
    written into it, applied in sub-step order; then ``pack_bits`` and
    ``_masses``."""
    pi = pi.clone()
    pr, pc, chunk = pi.shape
    if cand is None:
        gidx = torch.arange(pi.numel(), dtype=torch.int32).reshape(pi.shape)
        pi = torch.where(gidx == root, root, -1).to(torch.int32)
        front = gidx == root
    elif recv is None:
        front = (pi == -1) & (cand != INT_INF)
        pi = torch.where(front, cand, pi)
    else:
        jj = torch.arange(pc)
        recv = recv.clone()
        recv[:, jj, jj] = cand
        front = torch.zeros(pi.shape, dtype=torch.bool)
        for s in range(pc):
            upd = recv[:, jj, (jj + s) % pc]
            newly = (upd != INT_INF) & (pi == -1)
            pi = torch.where(newly, upd, pi)
            front |= newly
    return pi, pack_bits(front), decomp._masses(pi, front, deg)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("case", sorted(ec.epilogue_cases(1, 1, 32)))
def test_twin_matches_the_steps_update_it_replaced(grid, case):
    pi, deg, cand, recv, root = ec.epilogue_cases(*grid)[case]
    want_pi, want_words, want_masses = _before(pi, deg, cand, recv, root)
    out = ep.level_epilogue(pi, deg, cand, recv, root)
    assert isinstance(out, ep.Front)
    assert torch.equal(pi, want_pi)                  # updated in place
    assert torch.equal(out.words, want_words)
    assert out.masses.dtype == torch.int64
    assert out.masses.tolist() == want_masses


def test_masses_are_exact_past_2_31():
    pi, deg, cand, recv, _ = ec.epilogue_cases(2, 2, 64)["heavy degrees"]
    unvisited = (pi == -1).numpy()
    found = unvisited & (cand != INT_INF).numpy()
    # the bottom-up slots find more: take the twin's own newly found mask
    before = pi.clone()
    out = ep.level_epilogue(pi, deg, cand, recv)
    newly = ((before == -1) & (pi != -1)).numpy()
    assert (newly >= found).all()
    d = deg.numpy().astype(object)
    n_f, m_f, m_u = out.masses.tolist()
    assert n_f == int(newly.sum())
    assert m_f == int(d[newly].sum()) > 2**31
    assert m_u == int(d[unvisited & ~newly].sum()) > 2**31


def test_bottomup_slots_apply_in_sub_step_order():
    """One vertex of each block offered a parent in every slot: the self
    slot wins; without it, the sub-step 1 slot; a visited vertex takes
    none."""
    pr, pc, chunk = 1, 4, 32
    shape = (pr, pc, chunk)
    pi = torch.full(shape, -1, dtype=torch.int32)
    pi[0, :, 2] = 5
    deg = torch.ones(shape, dtype=torch.int32)
    cand = torch.full(shape, INT_INF, dtype=torch.int32)
    recv = torch.full((pr, pc, pc, chunk), INT_INF, dtype=torch.int32)
    for q in range(pc):
        for src in range(pc):
            recv[0, q, src, :3] = 100 * q + 10 * ((src - q) % pc) + src
        cand[0, q, 0] = 1000 + q
    out = ep.level_epilogue(pi, deg, cand, recv)
    for q in range(pc):
        assert int(pi[0, q, 0]) == 1000 + q               # slot 0
        assert int(pi[0, q, 1]) == int(recv[0, q, (q + 1) % pc, 1])
        assert int(pi[0, q, 2]) == 5                      # visited
    words = out.words.view(pc, 1)
    assert (words == 0b11).all()
    assert out.masses.tolist() == [2 * pc, 2 * pc, pr * pc * chunk - 3 * pc]


def test_wrapper_checks_its_inputs():
    pi = torch.full((1, 1, 32), -1, dtype=torch.int32)
    deg = torch.zeros_like(pi)
    with pytest.raises(ValueError, match="multiple of 32"):
        ep.level_epilogue(pi[..., :16].contiguous(), deg[..., :16]
                          .contiguous())
    with pytest.raises(ValueError, match="int32"):
        ep.level_epilogue(pi, deg.to(torch.int64))
    with pytest.raises(ValueError, match="recv"):
        ep.level_epilogue(pi, deg, pi.clone(),
                          torch.zeros((1, 1, 2, 32), dtype=torch.int32))
    assert ep.level_bytes(1024, 10, 3, 5) == (
        0, 4 * 1024 + 128 + 80 + 20 + 12)
    assert ep.level_bytes(1024, 1024, 1, start=True) == (
        0, 4 * 1024 + 128 + 4 * 1024 + 4)


@pytest.fixture(scope="module")
def graph():
    return build_blocked(rmat_graph(10, 16, seed=3, device="cpu"), 2, 2,
                         align=32, cap_pad=32)


@pytest.mark.parametrize("cfg", [{}, {"compact_updates": True},
                                 {"expand_chunks": 2}],
                         ids=["dense", "compact", "split-ring"])
def test_2d_steps_return_the_words_pack_bits_gives(graph, cfg):
    """A top-down then a bottom-up step on a 2x2 grid, from the hub: each
    returns the words of its newly found vertices and their masses, as
    ``pack_bits`` and ``_masses`` give them from the parents."""
    eng = plan_bfs(graph, BFSConfig(decomposition="2d", instrument=False,
                                    **cfg),
                   make_local_mesh(2, 2, device="cpu")).compile()
    g = eng._gdev
    args = eng.plan._level_args(g)
    deg = g["deg_A"]
    root = int(torch.argmax(deg.reshape(-1)))
    start, _ = eng.plan.entry.state(g, eng.plan.part, args, eng.plan.cfg)
    pi, front = start(root)
    assert torch.equal(front.words, pack_bits(pi == root))
    lv = {"n_f": np.float32(1), "m_f": np.float32(0), "over": False}
    for step in (topdown_level, bottomup_level):
        before = pi.clone()
        pi, front, _ = step(g, pi, front, args, lv)
        newly = (before == -1) & (pi != -1)
        assert newly.any(), step.__name__
        assert torch.equal(front.words, pack_bits(newly)), step.__name__
        assert front.masses.tolist() == decomp._masses(pi, newly, deg)


def test_dense_entries_end_a_level_with_the_twin():
    """The 2D dense oracle stays plain PyTorch on the card: its entries
    end a level with the twin, the kernel entries with the kernel, which
    their sessions build at compile."""
    from repro_torch.core.local_ops import get_local_ops
    for storage in ("csr", "dcsc"):
        dense = get_local_ops("2d", "dense", storage)
        kernel = get_local_ops("2d", "kernel", storage)
        assert dense.epilogue is ep.level_epilogue_plain
        assert kernel.epilogue is ep.level_epilogue
        assert ep.KERNEL in kernel.kernels
        assert ep.KERNEL not in dense.kernels
