"""Graph500 parent-tree validation where the graph lives.

The Graph500 spec requires every timed BFS to be validated: the returned
parent array must (1) self-parent the root, (2) use only real graph
edges as tree edges, (3) place each child exactly one level below its
parent, and (4) mark a vertex reachable iff it is in the tree.

This module runs those checks on the engine's own shards, on their
device, the JAX package's ``core/validate.py`` check for check: only the
(6,) int verdict crosses back to the host, in one read.  No edge list
and no depth array is ever made on the host.

The work, for every decomposition:

- the candidate parents in global layout-A order: on the simulated mesh
  the ``(*grid, chunk)`` parent array read flat (the JAX package's tiled
  ``all_gather`` over each mesh axis);
- every vertex's tree depth by pointer doubling over the parents
  (``DOUBLING_ROUNDS`` rounds: 2**7 > MAX_LEVELS + 1), saturating at
  ``CAP = MAX_LEVELS + 1`` so cycles, chains through out-of-tree vertices
  and out-of-range parents all read as unanchored;
- tree-edge existence against each shard's edge slots through the
  entry's ``local_edges`` hook (``core/decomp.py``): a vertex is marked
  when its (parent -> vertex) edge is stored in some shard (the JAX
  package's scatter-max and psum, here one shared mark array);
- violation counts per check over the vertices and the edge slots,
  summed over the shards (the JAX package's psum of six counters).

Each shard's slots are walked in pieces of ``PIECE`` slots, so the
per-slot temporaries stay a fixed size whatever the shard (at scale 24
on one 2D block a shard holds 5.2e8 slots).  The counts are integer sums
and do not depend on the order, so they equal the JAX package's bit for
bit.  The shards' edge counts, which bound the walk, are read to the
host once, when the validator is built.

Violation counters (``CHECKS`` order):

- ``root_self_parent``: the root's stored parent is not the root.
- ``tree_edge_missing``: an in-tree non-root vertex whose claimed parent
  edge exists in no shard.
- ``parent_chain_broken``: an in-tree vertex whose parent chain never
  reaches the root.
- ``level_span``: a graph edge whose endpoints' tree depths differ by
  more than one.
- ``reach_mismatch``: a graph edge with exactly one endpoint in the tree.

Edge-level counts are violation sites (each stored orientation of an
undirected edge counts once); the report is pass/fail plus per-check
tallies.  Padded ghost vertices (ids in [n_orig, n)) have no edges and
parent -1 in any legal run, so they never contribute a violation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.decomp import MAX_LEVELS

CHECKS = ("root_self_parent", "tree_edge_missing", "parent_chain_broken",
          "level_span", "reach_mismatch")

# depth saturation: anything that fails to anchor at the root within
# MAX_LEVELS hops reads as CAP; 2**DOUBLING_ROUNDS must exceed CAP
CAP = MAX_LEVELS + 1
DOUBLING_ROUNDS = 7

# edge slots a piece of the walk over one shard
PIECE = 1 << 25


@dataclass(frozen=True)
class ValidationReport:
    """Host-side verdict for one (root, parents) pair."""
    root: int
    ok: bool
    violations: Dict[str, int]   # CHECKS -> violation-site count
    n_tree: int                  # vertices with parent >= 0

    def summary(self) -> str:
        if self.ok:
            return (f"valid parent tree: root={self.root}, "
                    f"{self.n_tree} vertices in tree")
        bad = ", ".join(f"{k}={v}" for k, v in self.violations.items()
                        if v)
        return (f"INVALID parent tree: root={self.root}, "
                f"{self.n_tree} vertices in tree; {bad}")

    def to_json(self) -> Dict:
        return {"root": self.root, "ok": self.ok,
                "violations": dict(self.violations),
                "n_tree": self.n_tree}


class ValidationError(RuntimeError):
    """Raised by ``BFSEngine.run(..., validate=True)`` on a bad tree."""

    def __init__(self, report: ValidationReport):
        super().__init__(report.summary())
        self.report = report


def report_from_counts(root: int, counts) -> ValidationReport:
    c = [int(x) for x in np.asarray(counts).reshape(-1)]
    viol = dict(zip(CHECKS, c[: len(CHECKS)]))
    return ValidationReport(root=int(root), ok=not any(viol.values()),
                            violations=viol, n_tree=c[len(CHECKS)])


def build_validate_fn(plan):
    """``fn(g, pi, root) -> (6,) int64 counts`` on the device of ``pi``.

    ``g`` holds the shipped graph arrays (the entry's ``edge_keys``, which
    every LocalOps entry ships), ``pi`` is the parent array as
    ``BFSEngine.search`` returns it
    (``(*grid, chunk)`` int32; any shape of ``n`` entries in global
    order) and ``root`` a host int.  The plan must carry its graph: the
    shards' edge counts are read from it here, once.
    """
    entry, part = plan.entry, plan.part
    if entry.local_edges is None:
        raise ValueError(
            f"decomposition {entry.name!r} registers no local_edges hook; "
            "the Graph500 validator requires one")
    if plan.graph is None:
        raise ValueError("plan has no graph attached; build it with "
                         "plan_bfs(graph, cfg, mesh)")
    missing = [k for k in entry.edge_keys if k not in plan.keys]
    if missing:
        raise ValueError(f"the validator reads {missing}, which "
                         f"local_mode={plan.ops.local_mode!r} does not ship")
    n = part.n
    nnz = plan.graph.device_arrays()["nnz"].cpu().numpy()

    def fn(g, pi, root: int):
        dev = pi.device
        collectives.at(-1, "validate")
        # the parents replicated in global order: one tiled gather a
        # graph axis, innermost first
        pi_all = collectives.all_gather_tiled(pi, entry.axes).reshape(
            n).to(torch.int32)
        vid = torch.arange(n, dtype=torch.int32, device=dev)
        in_tree = pi_all >= 0
        ok_ref = in_tree & (pi_all < n)      # parent is a usable index
        is_root = vid == root
        # pointer doubling: hop[v] saturates at CAP unless v's chain
        # reaches the root through in-tree, in-range parents
        anc = torch.where(ok_ref & ~is_root, pi_all, vid).to(torch.int64)
        hop = torch.where(is_root, 0, torch.where(ok_ref, 1, CAP)).to(
            torch.int32)
        for _ in range(DOUBLING_ROUNDS):
            hop = torch.clamp_max(hop + hop[anc], CAP)
            anc = anc[anc]
        depth = hop
        del anc
        want = torch.where(ok_ref, pi_all, n).to(torch.int64)
        # found[v]: (parent[v] -> v) is a stored edge slot of some shard;
        # slot misses write the spare entry n
        found = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        v_span, v_reach = zero, zero
        for shard in np.ndindex(*nnz.shape):
            for start in range(0, int(nnz[shard]), PIECE):
                stop = min(start + PIECE, int(nnz[shard]))
                u, v, valid = entry.local_edges(g, part, shard, start, stop)
                hit = valid & (u == want[v])
                found[torch.where(hit, v, n)] = True
                tu, tv = in_tree[u], in_tree[v]
                far = (depth[u] - depth[v]).abs_() > 1
                v_span = v_span + (valid & tu & tv & far).sum()
                v_reach = v_reach + (valid & (tu != tv)).sum()
                del u, v, valid, hit, tu, tv, far
        # the tree-edge marks OR-ed over the shards (the shard loop above)
        collectives.noted("psum", entry.axes)
        not_root = in_tree & ~is_root
        counts = collectives.psum_stacked([
            (is_root & (pi_all != root)).sum(),
            (not_root & ~found[:n]).sum(),
            (not_root & (depth >= CAP)).sum(),
            v_span, v_reach, in_tree.sum()], entry.axes)
        return counts

    return fn


def _validate_fn(engine):
    if getattr(engine, "_vfn", None) is None:
        engine._vfn = build_validate_fn(engine.plan)
    return engine._vfn


def validate_device(engine, root: int, pi_dev) -> ValidationReport:
    """Validate a parent array in the grid layout on the engine's device
    (``search``'s own output) in place; one host read, the verdict."""
    counts = _validate_fn(engine)(engine._gdev, pi_dev, int(root))
    return report_from_counts(root, counts.tolist())


def validate_parents(engine, root: int, parents) -> ValidationReport:
    """Validate a HOST parent array (``(n_orig,)`` or ``(n,)`` flat, or
    already block-shaped) against the engine's graph shards.

    The entry point for post-hoc validation: results restored from disk,
    batch outputs, fault-injection probes.  The array is padded with -1
    ghosts to ``n`` and shipped to the engine's device (the validator
    reads it flat, in global order); only the (6,) verdict returns.
    """
    plan = engine.plan
    part = plan.part
    root = engine._check_root(root)
    flat = np.asarray(parents).reshape(-1).astype(np.int64)
    if flat.shape[0] == part.n_orig:
        full = np.full(part.n, -1, np.int64)
        full[: part.n_orig] = flat
    elif flat.shape[0] == part.n:
        full = flat
    else:
        raise ValueError(
            f"parents has {flat.shape[0]} entries; expected n_orig="
            f"{part.n_orig} or padded n={part.n}")
    # device parents are int32; clamp so host int64 garbage (a bit flip
    # above bit 31) still reads as an out-of-range parent instead of
    # wrapping back into range
    full = np.clip(full, -1, np.iinfo(np.int32).max).astype(np.int32)
    pi_dev = torch.from_numpy(full).to(plan.mesh.device)
    return validate_device(engine, root, pi_dev)
