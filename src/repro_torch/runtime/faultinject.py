"""Deterministic fault injection for the robustness layer: the parent-array
injectors and the capacity squeeze of the JAX package's
``runtime/faultinject.py``.

Every injector is keyed by an integer seed: which vertex's parent gets
bit-flipped, how small a capacity gets squeezed, is a pure function of
(seed, graph), so a run replays the identical faults and a failure is
reproducible from its seed alone.  Given the same arguments the port
makes the JAX package's mutation and ``info``, its seeded candidate
orders included.

* **parent-array corruption** (``inject_parents``): bit-flipped parents,
  phantom (non-edge) parents, off-by-one level skews, orphaned reachable
  vertices, dropped sub-bucket ranges.  Each injector guarantees the
  mutated array is invalid: it searches a seeded candidate order for a
  mutation the Graph500 conditions reject, consulting the graph's edges
  and true depths.
* **undersized capacities** (``undersize_cap``): squeeze ``cap_x`` so
  the replan-retry escalation (``core/engine.py::run_bfs_healed``) runs.

The oracle answers edge membership from the sorted 64-bit edge keys
``src * n + dst`` on the edge list's device (the JAX package builds a
Python set of every edge tuple, which no host holds at scale 24), and
takes the true depths from one edge-parallel BFS there.  Depths and edge
membership are unique facts, so the mutations are the same.  A caller
injecting many faults into one graph passes ``keys`` (a
``core/ref.py::TreeValidator``'s ``keys``) and ``depth`` (its
``depths(root)``) to make them once.

Injectors never import the engine; they mutate host arrays only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ref import TreeValidator

PARENT_FAULTS = ("flip_bit", "phantom_parent", "level_skew",
                 "orphan_leaf", "drop_subrange")


class InjectionError(RuntimeError):
    """The graph admits no invalid mutation of the requested class
    (degenerate inputs: a star graph has no same-level edges)."""


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class _Oracle:
    """Edge membership and true depths, the context the injectors consult
    to guarantee their mutation violates a Graph500 condition."""

    def __init__(self, n: int, src, dst, root: int, parents,
                 keys: Optional[torch.Tensor] = None, depth=None):
        self.n = int(n)
        self.root = int(root)
        self.src, self.dst = _tensor(src), _tensor(dst)
        tree = None
        if keys is None or depth is None:
            tree = TreeValidator(self.n, self.src, self.dst)
        self.keys = tree.keys if keys is None else keys
        if depth is None:
            depth = tree.depths(self.root)
        self.depth = np.asarray(depth.cpu() if isinstance(
            depth, torch.Tensor) else depth).astype(np.int64)
        self.in_tree = np.nonzero(np.asarray(parents) >= 0)[0]

    def _has(self, u: int, v: int) -> bool:
        if not (0 <= u < self.n and 0 <= v < self.n):
            return False
        q = torch.tensor(u * self.n + v, dtype=torch.int64,
                         device=self.keys.device)
        pos = int(torch.searchsorted(self.keys, q))
        return pos < self.keys.numel() and int(self.keys[pos]) == int(q)

    def is_edge(self, u: int, v: int) -> bool:
        return self._has(u, v) or self._has(v, u)

    def neighbours(self, v: int) -> np.ndarray:
        """Every w with an edge v -> w or w -> v, as a host array (the
        JAX package's ``concatenate([dst[src == v], src[dst == v]])``)."""
        return torch.cat([self.dst[self.src == v],
                          self.src[self.dst == v]]).cpu().numpy()

    def valid_parent(self, v: int, p: int) -> bool:
        """Would ``parent[v] = p`` still satisfy every per-vertex
        Graph500 condition?  (Any true-BFS parent is acceptable.)"""
        if v == self.root:
            return p == self.root
        if p < 0 or p >= self.n:
            return False
        return self.is_edge(p, v) and self.depth[p] == self.depth[v] - 1


def inject_parents(kind: str, parents, root: int, seed: int, *, n: int,
                   src, dst, chunk: Optional[int] = None,
                   expand_chunks: int = 1,
                   keys: Optional[torch.Tensor] = None, depth=None
                   ) -> Tuple[np.ndarray, Dict]:
    """Return (mutated_parents, info) for one seeded parent fault.

    ``parents`` is a correct (n_orig,) parent array from a real run; the
    mutation is guaranteed invalid.  ``src``/``dst`` are the edge list
    (numpy arrays or tensors on any device).  ``chunk``/``expand_chunks``
    parameterize ``drop_subrange``, the 1ds sub-bucket geometry whose
    loss the fault simulates.  ``keys`` (sorted ``src * n + dst``) and
    ``depth`` (the true depths from ``root``) are made here when not
    given."""
    if kind not in PARENT_FAULTS:
        raise ValueError(f"unknown parent fault {kind!r}; "
                         f"have {PARENT_FAULTS}")
    rng = np.random.default_rng(seed)
    out = np.asarray(parents).astype(np.int64).copy()
    orc = _Oracle(n, src, dst, root, out, keys=keys, depth=depth)
    cands = orc.in_tree[orc.in_tree != root]
    if not cands.size:
        raise InjectionError("tree has no non-root vertices to corrupt")
    # the JAX package shuffles a list; a 1-D array takes the same draws
    rng.shuffle(cands)
    cands = cands.tolist()

    if kind == "flip_bit":
        bits = list(range(33))          # value bits 0..31 + sign bit 32
        for v in cands:
            order = rng.permutation(bits)
            for b in order:
                newp = int(out[v]) ^ (1 << int(b)) if b < 32 \
                    else -int(out[v]) - 1           # flip two's-compl sign
                if newp != out[v] and not orc.valid_parent(v, newp):
                    info = {"kind": kind, "vertex": v, "bit": int(b),
                            "old": int(out[v]), "new": int(newp)}
                    out[v] = newp
                    return out, info
        raise InjectionError("no invalidating bit flip found")

    if kind == "phantom_parent":
        # the same set operations as the JAX package, so the pool comes
        # out of the same set iteration order
        intree = set(cands) | {root}
        for v in cands:
            pool = rng.permutation(list(intree - {v}))
            for u in pool[:256]:
                u = int(u)
                if not orc.is_edge(u, v):
                    info = {"kind": kind, "vertex": v,
                            "old": int(out[v]), "new": u}
                    out[v] = u
                    return out, info
        raise InjectionError("no non-adjacent in-tree pair found")

    if kind == "level_skew":
        # a REAL edge whose endpoints sit on the same level (or worse):
        # the tree edge exists and anchors, only the level arithmetic
        # breaks, invisible to every check except the +-1 level condition
        depth = orc.depth
        for want_gap in (0, 1):          # same level, then child-as-parent
            for v in cands:
                nbrs = rng.permutation(np.unique(orc.neighbours(v)))
                for w in nbrs:
                    w = int(w)
                    if w == out[v] or w == v or out[w] < 0:
                        continue
                    if depth[w] == depth[v] + want_gap:
                        info = {"kind": kind, "vertex": v,
                                "old": int(out[v]), "new": w,
                                "gap": int(want_gap)}
                        out[v] = w
                        return out, info
        raise InjectionError("no same-level edge found")

    if kind == "orphan_leaf":
        is_parent = np.zeros(max(int(out.max()) + 1, out.shape[0]), bool)
        is_parent[out[out >= 0]] = True
        for v in cands:
            if not is_parent[v]:
                info = {"kind": kind, "vertex": v, "old": int(out[v])}
                out[v] = -1
                return out, info
        raise InjectionError("tree has no leaf")

    # drop_subrange: lose one 1ds sub-bucket, a contiguous [k*chunk +
    # s*sub, +sub) slice of discovered vertices reads as never-arrived
    if chunk is None:
        raise ValueError("drop_subrange needs the strip chunk size")
    sub = max(1, chunk // max(1, expand_chunks))
    n_orig = out.shape[0]
    starts = np.arange(0, n_orig, sub)
    rng.shuffle(starts)
    for s in starts.tolist():
        sel = out[s: s + sub] >= 0
        if s <= root < s + sub:
            sel[root - s] = False
        if sel.any():
            info = {"kind": kind, "start": int(s), "sub": int(sub),
                    "dropped": int(sel.sum())}
            out[s: s + sub][sel] = -1
            return out, info
    raise InjectionError("no sub-range holds in-tree vertices")


def undersize_cap(cap: int, seed: int, align: int = 32) -> int:
    """A seeded, deliberately-too-small capacity: cap / 2^k (k in 2..4),
    floored to ``align``: small enough to overflow realistic runs,
    aligned enough to plan."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 5))
    return max(align, (cap >> k) // align * align)
