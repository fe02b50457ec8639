"""BFS-tree oracles: the sequential top-down and bottom-up searches
(Algorithms 1 and 2), level-synchronous depths, depths from a parent
array and the Graph500 parent-tree checks, in numpy on the host and in
torch on any device.

Parent choice in BFS may differ between correct implementations (any
depth-(d-1) in-neighbour is legal), so validation checks tree validity
and depths, not parent equality.  The four checks: (1) the root is its
own parent, (2) the reached set equals the oracle's, (3) every tree edge
is an input edge, (4) a parent's depth is its child's depth - 1.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    order = np.lexsort((dst, src))
    s, d = src[order], dst[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, s + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, d


def bfs_topdown(n: int, src: np.ndarray, dst: np.ndarray, root: int
                ) -> np.ndarray:
    """Algorithm 1: parent[n] (the root its own parent, -1 unreachable);
    each vertex takes the first frontier vertex, in frontier order, with
    an edge into it."""
    ptr, adj = _csr(n, src, dst)
    parent = np.full(n, -1, dtype=np.int64)
    parent[root] = root
    frontier = np.array([root], dtype=np.int64)
    while frontier.size:
        nxt = []
        for u in frontier:
            for v in adj[ptr[u]:ptr[u + 1]]:
                if parent[v] == -1:
                    parent[v] = u
                    nxt.append(v)
        frontier = np.array(nxt, dtype=np.int64)
    return parent


def bfs_bottomup(n: int, src: np.ndarray, dst: np.ndarray, root: int
                 ) -> np.ndarray:
    """Algorithm 2: each unvisited vertex scans its in-neighbours (the
    sources u of edges u -> v, ascending) and stops at the first in the
    frontier."""
    ptr, radj = _csr(n, dst, src)
    parent = np.full(n, -1, dtype=np.int64)
    parent[root] = root
    frontier = np.zeros(n, dtype=bool)
    frontier[root] = True
    while frontier.any():
        nxt = np.zeros(n, dtype=bool)
        for u in range(n):
            if parent[u] == -1:
                for v in radj[ptr[u]:ptr[u + 1]]:
                    if frontier[v]:
                        parent[u] = v
                        nxt[u] = True
                        break
        frontier = nxt
    return parent


def bfs_depths(n: int, src: np.ndarray, dst: np.ndarray, root: int) -> np.ndarray:
    """Level-synchronous depths on the host (-1 = unreachable)."""
    ptr, adj = _csr(n, src, dst)
    depth = np.full(n, -1, dtype=np.int64)
    depth[root] = 0
    frontier = np.array([root], dtype=np.int64)
    d = 0
    while frontier.size:
        counts = ptr[frontier + 1] - ptr[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        out = np.empty(total, dtype=np.int64)
        pos = 0
        for u, c in zip(frontier, counts):
            out[pos:pos + c] = adj[ptr[u]:ptr[u] + c]
            pos += c
        nbrs = np.unique(out)
        new = nbrs[depth[nbrs] == -1]
        depth[new] = d + 1
        frontier = new
        d += 1
    return depth


def depths_from_parents(n: int, parent: np.ndarray, root: int) -> np.ndarray:
    """Depths from a parent array, by following the parent chains: parents
    may differ between correct searches, depths do not, so they are the
    key for comparing two searches (-1 = unreached)."""
    parent = np.asarray(parent, dtype=np.int64)
    depth = np.full(n, -1, np.int64)
    depth[root] = 0
    for _ in range(n):
        upd = (depth == -1) & (parent >= 0) & (depth[parent] >= 0)
        if not upd.any():
            break
        depth[upd] = depth[parent[upd]] + 1
    return depth


def validate_parents(n: int, src: np.ndarray, dst: np.ndarray, root: int,
                     parent: np.ndarray) -> Tuple[bool, str]:
    """The four checks on the host, against ``bfs_depths``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    depth = bfs_depths(n, src, dst, root)
    parent = np.asarray(parent, dtype=np.int64)
    if parent[root] != root:
        return False, "root parent mismatch"
    reach_ref = depth >= 0
    reach_got = parent >= 0
    if not np.array_equal(reach_ref, reach_got):
        miss = int(np.sum(reach_ref != reach_got))
        return False, f"reachable-set mismatch on {miss} vertices"
    vs = np.flatnonzero(reach_got)
    vs = vs[vs != root]
    ps = parent[vs]
    key_edges = set((src * np.int64(n) + dst).tolist())
    bad_edges = [(int(p), int(v)) for p, v in zip(ps, vs)
                 if int(p) * n + int(v) not in key_edges]
    if bad_edges:
        return False, f"{len(bad_edges)} tree edges not in graph, e.g. {bad_edges[:3]}"
    if not np.array_equal(depth[vs], depth[ps] + 1):
        bad = int(np.sum(depth[vs] != depth[ps] + 1))
        return False, f"{bad} vertices with parent depth != depth-1"
    return True, "ok"


class TreeValidator:
    """The same four checks on the edge list's device.

    The oracle depths come from an edge-parallel level-synchronous BFS
    over the edge list, and tree-edge existence from a binary search in
    the sorted 64-bit edge keys, which are built once per graph so that
    many trees validate against one sort (none for an already sorted
    list)."""

    def __init__(self, n: int, src: torch.Tensor, dst: torch.Tensor):
        self.n = n
        self.src = src
        self.dst = dst
        # a copy even of int64 ids: the caller's edge list stays as it is
        key = src.to(torch.int64, copy=True).mul_(n).add_(dst)
        # an EdgeList comes sorted by (src, dst): its keys need no sort,
        # whose value, index and scratch copies would triple their memory
        if not bool((key[1:] >= key[:-1]).all()):
            key = torch.sort(key).values
        self.keys = key

    def depths(self, root: int) -> torch.Tensor:
        """(n,) int32 oracle depths, -1 unreachable."""
        depth = torch.full((self.n,), -1, dtype=torch.int32,
                           device=self.src.device)
        depth[root] = 0
        d = 0
        while True:
            live = depth[self.dst] == -1
            live &= depth[self.src] == d
            new = self.dst[live]
            if new.numel() == 0:
                return depth
            depth[new.to(torch.int64)] = d + 1
            d += 1

    def check(self, root: int, parent: torch.Tensor) -> Tuple[bool, str]:
        """``parent``: (n,) tree on the same device; one host read."""
        n = self.n
        parent = parent.to(torch.int64)
        depth = self.depths(root)
        reach_ref = depth >= 0
        reach_got = parent >= 0
        vs = torch.nonzero(reach_got & reach_ref).reshape(-1)
        vs = vs[vs != root]
        ps = parent[vs].clamp(0, n - 1)
        q = parent[vs] * n + vs
        pos = torch.searchsorted(self.keys, q).clamp_(max=self.keys.numel() - 1)
        root_ok, n_miss, n_bad_edge, n_bad_depth = torch.stack([
            (parent[root] == root).to(torch.int64),
            (reach_ref != reach_got).sum(),
            (self.keys[pos] != q).sum(),
            (depth[vs] != depth[ps] + 1).sum()]).tolist()
        if not root_ok:
            return False, "root parent mismatch"
        if n_miss:
            return False, f"reachable-set mismatch on {n_miss} vertices"
        if n_bad_edge:
            return False, f"{n_bad_edge} tree edges not in graph"
        if n_bad_depth:
            return False, f"{n_bad_depth} vertices with parent depth != depth-1"
        return True, "ok"
