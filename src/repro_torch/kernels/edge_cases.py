"""Synthetic inputs that break the walks of the bottom-up sub-step
(``kernels/bottomup``) and of the pipelined strip SpMSV
(``kernels/spmsv/strip.py``), at any width: the CPU tests run them
through the plain versions, the card tests and ``chip_smoke.py`` through
the kernels as well.  Every case comes from a numpy seed.

Bottom-up (``bottomup_cases``): stacked strips ``row_ptr (p, chunk+1)``,
``col_idx (p, cap)``, one frontier bitmap ``f_words (p*chunk/32,)``,
``cvec (p, chunk)`` and ``n_edges (p,)``.  Every ``gap``-th row has
edges, with lengths cycling through ``ROW_LENGTHS`` (0, 1, 31, 32, 33
and past 1,024) and the first frontier hit at none, the first edge, edge
33, the last edge or edge 1,050, cycling independently; the rest are
empty.  Sources ascend within a row; the frontier is every vertex
whose id is 31 mod 32 (bit 31 of every word).  The cases:

  lengths    that layout, 10% of the rows completed
  cut        the same, each strip's edge count ending halfway through
             its last row of more than 1,024 edges
  completed  every row completed
  last word  the frontier only in the last word; rows with a hit end on
             a source there

Strip SpMSV (``strip_graph`` and ``strip_frontiers``): a p-strip graph
with random edges, three edges out of both ends of every sub-range of
``SUB_STEPS`` steps of every owner, a hub column of ``HUB_EDGES`` edges
into one strip, and one strip that no edge enters (nzc 0); frontiers
empty, those sub-range ends, the hub alone, the last word, 1%, 30% and
all.

Kernel 1 (``spmsv_block``, ``spmsv_strips`` and ``spmsv_frontiers``,
``kernels/spmsv/ops.py``): a 2D block, or p strips of the same columns,
with random edges out of about half the columns (the rest empty, so
absent from ``jc``), a hub column of ``SPMSV_HUB_EDGES`` edges and
edges out of every column of the last word; its DCSC padded past
``nzc`` with the sentinel.  Frontiers (packed words): empty, the hub
alone, the last word, empty columns only (none found in ``jc``), 1%,
exactly at each given walk threshold and one id past it, and all.
``spmsv_strips_uniform`` builds strips whose edges pass 2^31 together,
on the card from a ``torch.Generator`` seed.

The 2D level epilogue (``epilogue_cases``, ``kernels/epilogue/ops.py``)
on a (pr, pc, chunk) grid: ``(pi, deg, cand, recv, root)`` with half the
vertices visited, candidates in a third of the slots, and, where pc > 1,
bottom-up slots that offer several parents for one vertex; no
candidate at all; one vertex found; everything visited; the start (no
``cand``, one ``root``); and degrees near 2^30, whose masses pass 2^31.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.frontier import pack_bits
from repro_torch.graph.formats import build_blocked_1d
from repro_torch.graph.rmat import EdgeList

ROW_LENGTHS = (0, 1, 31, 32, 33, 1100, 2, 40, 64, 8, 9, 16, 17, 1030)
HITS = (-1, 0, 33, "last", 1050)      # first hit: none, edge i, last edge
GAP = 16                              # every GAP-th row has edges
M = 32                                # frontier: ids that are M-1 mod M
SUB_STEPS = 4                         # sub-range ends of 4, 2 and 1 steps
HUB_EDGES = 10_000
SPMSV_HUB_EDGES = 100_000


def _hit(length: int, mode) -> int:
    if length == 0 or mode == -1:
        return -1
    if mode == "last":
        return length - 1
    return mode if mode < length else -1


def bottomup_cases(p: int, chunk: int, device="cpu", seed: int = 0,
                   gap: int = GAP) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """name -> (row_ptr, col_idx, f_words, cvec, n_edges), int32 on
    ``device``; every ``gap``-th row has edges.  The longest rows need
    p*chunk > (1,100 + 2) * M + 64 sources, so that they fit below the
    last word."""
    n = p * chunk
    longest = max(ROW_LENGTHS)
    if n <= (longest + 2) * M + 64 or chunk % 32:
        raise ValueError(f"p*chunk={n} too small for rows of {longest} "
                         f"edges, or chunk={chunk} not a multiple of 32")
    rng = np.random.default_rng(seed)
    rows = p * chunk
    lens = np.zeros(rows, np.int64)
    hits = np.full(rows, -1, np.int64)
    sel = np.arange(0, rows, gap)
    i = np.arange(sel.shape[0])
    lens[sel] = np.asarray(ROW_LENGTHS)[i % len(ROW_LENGTHS)]
    hits[sel] = [_hit(int(ln), HITS[j % len(HITS)])
                 for ln, j in zip(lens[sel], i)]
    # sources: row base (a multiple of M) + t*M + r, r < M-1 before the
    # hit, r = M-1 at it, any r after it; they ascend within a row
    e_row = np.repeat(np.arange(rows), lens)
    starts = np.cumsum(lens) - lens
    t = np.arange(e_row.shape[0]) - starts[e_row]
    base = rng.integers(0, (n - (lens + 2) * M) // M, rows) * M
    h = hits[e_row]
    r = np.where(t < h, rng.integers(0, M - 1, t.shape[0]),
                 rng.integers(0, M, t.shape[0]))
    r = np.where(h < 0, rng.integers(0, M - 1, t.shape[0]), r)
    r = np.where(t == h, M - 1, r)
    src = base[e_row] + t * M + r

    def stacked(src, lens, cvec, cut):
        lens2 = lens.reshape(p, chunk)
        row_ptr = np.zeros((p, chunk + 1), np.int64)
        row_ptr[:, 1:] = np.cumsum(lens2, axis=1)
        nnz = row_ptr[:, -1]
        cap = max(int(nnz.max()), 1)
        col_idx = np.zeros((p, cap), np.int64)
        for s in range(p):
            lo = s * chunk
            e0, e1 = starts[lo], starts[lo] + nnz[s]
            col_idx[s, :nnz[s]] = src[e0:e1]
        n_edges = nnz.copy()
        if cut:
            for s in range(p):
                long_rows = np.flatnonzero(lens2[s] > 1024)
                if long_rows.size:
                    rr = long_rows[-1]
                    n_edges[s] = row_ptr[s, rr] + lens2[s, rr] // 2
        return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                     for a in (row_ptr, col_idx, cvec, n_edges))

    mask = np.zeros(n, bool)
    mask[M - 1::M] = True
    f_words = pack_bits(torch.from_numpy(mask)).to(device)
    done = (rng.random(rows) < 0.1).astype(np.int64).reshape(p, chunk)
    cases = {}
    for name, cv, cut in (("lengths", done, False), ("cut", done, True),
                          ("completed", np.ones_like(done), False)):
        rp, ci, cv, ne = stacked(src, lens, cv, cut)
        cases[name] = (rp, ci, f_words, cv, ne)
    # the last word: rows with a hit end on a source in it instead, the
    # only frontier vertices
    last = src.copy()
    ends = starts + lens - 1
    with_hit = (lens > 0) & (hits >= 0)
    last[ends[with_hit]] = n - 32 + rng.integers(0, 32,
                                                 int(with_hit.sum()))
    mask = np.zeros(n, bool)
    mask[n - 32:] = True
    f_last = pack_bits(torch.from_numpy(mask)).to(device)
    rp, ci, cv, ne = stacked(last, lens, np.zeros_like(done), False)
    cases["last word"] = (rp, ci, f_last, cv, ne)
    return cases


def sub_range_ends(p: int, chunk: int) -> np.ndarray:
    """Both ends of every sub-range of SUB_STEPS steps of every owner:
    o*chunk + k*sub and o*chunk + (k+1)*sub - 1."""
    sub = chunk // SUB_STEPS
    o = np.arange(p)[:, None] * chunk
    k = np.arange(SUB_STEPS)[None, :] * sub
    return np.concatenate([(o + k).ravel(), (o + k + sub - 1).ravel()])


def strip_graph(p: int, chunk: int, device="cpu", seed: int = 0,
                edge_factor: int = 4):
    """(graph, hub id, empty strip): the p-strip build of a random edge
    list, plus three edges out of every sub-range end and a hub of
    HUB_EDGES edges into strip 1, with no edge into the last strip."""
    n = p * chunk
    if chunk < HUB_EDGES or chunk % (32 * SUB_STEPS) or p < 3:
        raise ValueError(f"chunk={chunk} must be a multiple of "
                         f"{32 * SUB_STEPS} and hold {HUB_EDGES} rows, p "
                         f"at least 3")
    rng = np.random.default_rng(seed)
    empty = p - 1
    m = edge_factor * n
    src = [rng.integers(0, n, m)]
    dst = [rng.integers(0, empty * chunk, m)]
    ends = sub_range_ends(p, chunk)
    src.append(np.repeat(ends, 3))
    dst.append(rng.integers(0, empty * chunk, 3 * ends.shape[0]))
    hub = int(rng.integers(0, n))
    src.append(np.full(HUB_EDGES, hub))
    dst.append(chunk + np.arange(HUB_EDGES))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    edges = EdgeList(n=n, src=torch.from_numpy((key // n).astype(np.int32))
                     .to(device),
                     dst=torch.from_numpy((key % n).astype(np.int32))
                     .to(device), m_input=int(keep.sum()))
    return build_blocked_1d(edges, p, align=32, cap_pad=32), hub, empty


def strip_frontiers(p: int, chunk: int, hub: int, device="cpu",
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """name -> the (p*chunk/32,) int32 frontier bitmap."""
    n = p * chunk
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("empty", "sub-range ends", "hub", "last word", "1%", "30%",
                 "all"):
        mask = np.zeros(n, bool)
        if name == "sub-range ends":
            mask[sub_range_ends(p, chunk)] = True
        elif name == "hub":
            mask[hub] = True
        elif name == "last word":
            mask[n - 32:] = True
        elif name == "1%":
            mask = rng.random(n) < 0.01
        elif name == "30%":
            mask = rng.random(n) < 0.3
        elif name == "all":
            mask[:] = True
        out[name] = pack_bits(torch.from_numpy(mask)).to(device)
    return out


def spmsv_block(nc: int, nr: int, device="cpu", seed: int = 0,
                hub: int = None, edge_factor: int = 2):
    """One block of kernel 1: ``(col_ptr (nc+1,), row_idx, jc (cap_nzc,),
    cp (cap_nzc+1,), nzc (0-d), hub)``, int32 on ``device``.  About half
    the columns carry ``edge_factor * nc`` random edges in all; the hub
    column (drawn when ``hub`` is None) adds SPMSV_HUB_EDGES distinct
    rows; every column of the last word has an edge; ``cap_nzc`` is
    ``nzc`` rounded up to 8, plus 8."""
    if nr < SPMSV_HUB_EDGES or nc % 32 or nc < 64:
        raise ValueError(f"need nr >= {SPMSV_HUB_EDGES} rows for the hub "
                         f"and nc a multiple of 32 (at least 64), got nr="
                         f"{nr}, nc={nc}")
    rng = np.random.default_rng(seed)
    live = rng.random(nc) < 0.5
    if hub is None:
        hub = int(rng.integers(0, nc - 32))
    live[hub] = True
    cols = np.flatnonzero(live)
    m = edge_factor * nc
    src = np.concatenate([rng.choice(cols, m), np.full(SPMSV_HUB_EDGES, hub),
                          np.arange(nc - 32, nc)])
    dst = np.concatenate([rng.integers(0, nr, m),
                          rng.permutation(nr)[:SPMSV_HUB_EDGES],
                          rng.integers(0, nr, 32)])
    key = np.unique(src.astype(np.int64) * nr + dst)
    src, dst = key // nr, key % nr
    counts = np.bincount(src, minlength=nc)
    col_ptr = np.concatenate([[0], np.cumsum(counts)])
    nz = np.flatnonzero(counts)
    cap_nzc = -(-nz.shape[0] // 8) * 8 + 8
    jc = np.full(cap_nzc, nc)
    jc[:nz.shape[0]] = nz
    cp = np.full(cap_nzc + 1, col_ptr[-1])
    cp[:nz.shape[0]] = col_ptr[nz]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)
                                ).to(device)
    return (t(col_ptr), t(dst), t(jc), t(cp),
            torch.tensor(nz.shape[0], dtype=torch.int32, device=device), hub)


def spmsv_strips(p: int, n: int, device="cpu", seed: int = 0):
    """Kernel 1's strip case: p strips of ``spmsv_block(n, n // p)`` (one
    hub column shared by every strip, each strip's edges its own),
    stacked as ``(col_ptr (p, n+1), row_idx (p, cap), hub)`` with cap
    the largest strip's edge count."""
    blocks, hub = [], None
    for s in range(p):
        b = spmsv_block(n, n // p, seed=seed + s, hub=hub)
        hub = b[5]
        blocks.append(b)
    cap = max(int(b[0][-1]) for b in blocks)
    row_idx = torch.zeros((p, cap), dtype=torch.int32)
    for s, b in enumerate(blocks):
        row_idx[s, :b[1].shape[0]] = b[1]
    col_ptr = torch.stack([b[0] for b in blocks])
    return col_ptr.to(device), row_idx.to(device), hub


def spmsv_frontiers(col_ptr: torch.Tensor, hub: int, thresholds=(),
                    device="cpu", seed: int = 0) -> Dict[str, torch.Tensor]:
    """name -> the packed (nc/32,) int32 frontier words of kernel 1's
    cases over the columns of ``col_ptr`` ((nc+1,), or the strips' (p,
    nc+1), whose first strip picks the empty columns)."""
    cp = col_ptr.reshape(-1, col_ptr.shape[-1])[0].cpu().numpy()
    nc = cp.shape[0] - 1
    rng = np.random.default_rng(seed)
    empty = np.flatnonzero(np.diff(cp) == 0)
    masks = {"empty": np.zeros(nc, bool)}
    for name in ("hub", "last word", "absent from jc", "1%", "all"):
        mask = np.zeros(nc, bool)
        if name == "hub":
            mask[hub] = True
        elif name == "last word":
            mask[nc - 32:] = True
        elif name == "absent from jc":
            mask[empty[:: max(1, empty.shape[0] // 64)]] = True
        elif name == "1%":
            mask = rng.random(nc) < 0.01
        else:
            mask[:] = True
        masks[name] = mask
    for t in thresholds:
        for name, k in ((f"at {t}", t), (f"past {t}", t + 1)):
            mask = np.zeros(nc, bool)
            mask[rng.choice(nc, min(k, nc), replace=False)] = True
            masks[name] = mask
    return {name: pack_bits(torch.from_numpy(m)).to(device)
            for name, m in masks.items()}


def spmsv_strips_uniform(p: int, n: int, nr: int, degree: int, device,
                         seed: int = 0):
    """``(col_ptr (p, n+1), row_idx (p, n * degree))``: every column of
    every strip has ``degree`` rows drawn in [0, nr) from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; at p * n *
    degree >= 2^31 the strips' edges together pass int32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    col_ptr = (torch.arange(n + 1, dtype=torch.int32, device=device)
               * degree).expand(p, n + 1).contiguous()
    row_idx = torch.randint(0, nr, (p, n * degree), generator=gen,
                            dtype=torch.int32, device=device)
    return col_ptr, row_idx


# the degree of the heavy case: 64 such vertices pass 2^36
HEAVY_DEG = (1 << 30) + 12345


def epilogue_cases(pr: int, pc: int, chunk: int, device="cpu",
                   seed: int = 0) -> Dict[str, Tuple]:
    """name -> (pi, deg, cand, recv, root) for ``level_epilogue`` on a
    (pr, pc, chunk) grid, int32 on ``device`` (``cand``/``recv`` None
    where the case has none; ``root`` -1 unless the case is a start).
    Each call makes fresh tensors: the epilogue writes ``pi``."""
    if chunk % 32:
        raise ValueError(f"chunk={chunk} is not a multiple of 32")
    rng = np.random.default_rng(seed)
    shape, n = (pr, pc, chunk), pr * pc * chunk

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(
            np.int32)).to(device)

    inf = np.int64(2**31 - 1)
    visited = rng.random(shape) < 0.5
    pi = np.where(visited, rng.integers(0, n, shape), -1)
    deg = rng.integers(0, 1000, shape)
    cand = np.where(rng.random(shape) < 0.33, rng.integers(0, n, shape), inf)
    recv = None
    if pc > 1:
        recv = np.where(rng.random((pr, pc, pc, chunk)) < 0.33,
                        rng.integers(0, n, (pr, pc, pc, chunk)), inf)
    cases = {"random": (pi, deg, cand, recv, -1),
             "no candidate": (pi, deg, np.full(shape, inf),
                              None if recv is None else np.full_like(recv,
                                                                     inf),
                              -1)}
    one = np.full(shape, inf)
    v = np.flatnonzero(pi.reshape(-1) == -1)[-1]
    one.reshape(-1)[v] = 7
    cases["one vertex"] = (pi, deg, one, None if recv is None
                           else np.full_like(recv, inf), -1)
    cases["all visited"] = (np.abs(pi), deg, cand, recv, -1)
    cases["start"] = (np.full(shape, -1), deg, None, None,
                      int(rng.integers(0, n)))
    heavy = np.where(rng.random(shape) < 0.5, HEAVY_DEG, deg)
    cases["heavy degrees"] = (pi, heavy, cand, recv, -1)
    return {k: (t(a), t(d), None if c is None else t(c),
                None if r is None else t(r), root)
            for k, (a, d, c, r, root) in cases.items()}
