"""Deterministic fault injection for the robustness layer, the JAX
package's ``runtime/faultinject.py``.

Every injector is keyed by an integer seed: which vertex's parent gets
bit-flipped, which store shard byte gets corrupted, how small a capacity
gets squeezed, is a pure function of (seed, graph), so a run replays the
identical faults and a failure is reproducible from its seed alone.
Given the same arguments the port makes the JAX package's mutation and
``info``, its seeded candidate orders included.

* **parent-array corruption** (``inject_parents``): bit-flipped parents,
  phantom (non-edge) parents, off-by-one level skews, orphaned reachable
  vertices, dropped sub-bucket ranges.  Each injector guarantees the
  mutated array is invalid: it searches a seeded candidate order for a
  mutation the Graph500 conditions reject, consulting the graph's edges
  and true depths.
* **store corruption** (``corrupt_shard``): flip a byte or truncate a
  ``GraphStore`` shard file; the store's CRC check must quarantine and
  regenerate it.
* **undersized capacities** (``undersize_cap``, ``undersize_route_slack``):
  squeeze ``cap_x`` or ``route_slack`` so the replan-retry escalations
  (``core/engine.py::run_bfs_healed``, ``graph/dist_build.py::
  dist_build``) run.
* the CLI (``python -m repro_torch.runtime.faultinject``) replays the
  whole seeded matrix (``run_fault_matrix``) on a simulated mesh of
  ``--devices`` shards and writes a JSON report.

The oracle answers edge membership from the sorted 64-bit edge keys
``src * n + dst`` on the edge list's device (the JAX package builds a
Python set of every edge tuple, which no host holds at scale 24), and
takes the true depths from one edge-parallel BFS there.  Depths and edge
membership are unique facts, so the mutations are the same.  A caller
injecting many faults into one graph passes ``keys`` (a
``core/ref.py::TreeValidator``'s ``keys``) and ``depth`` (its
``depths(root)``) to make them once.

Injectors never import the engine; they mutate host arrays and files
only.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
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


# ---------------------------------------------------------------------------
# store + capacity injectors
# ---------------------------------------------------------------------------


def corrupt_shard(store, name: str, seed: int, mode: str = "flip",
                  shard: Optional[int] = None,
                  step: Optional[int] = None) -> str:
    """Corrupt one shard file of a stored graph in place (seeded shard
    and byte choice).  ``mode``: "flip" XORs one byte of the file's
    second half, "truncate" cuts the file to a seeded fraction.  Returns
    the path."""
    rng = np.random.default_rng(seed)
    gdir = os.path.join(store.root, "graphs", name)
    if step is None:
        step = checkpoint.latest_step(gdir)
        if step is None:
            raise FileNotFoundError(f"no graph steps under {gdir}")
    shards = sorted(glob.glob(os.path.join(
        gdir, f"step_{step:010d}", "shard_*.npz")))
    if not shards:
        raise FileNotFoundError(f"no shard files under {gdir}")
    path = shards[int(rng.integers(len(shards))) if shard is None
                  else shard]
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "flip":
        pos = int(rng.integers(len(data) // 2, len(data)))
        data[pos] ^= int(rng.integers(1, 256))
        payload = bytes(data)
    elif mode == "truncate":
        cut = int(len(data) * float(rng.uniform(0.2, 0.7)))
        payload = bytes(data[:cut])
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(payload)
    return path


def undersize_cap(cap: int, seed: int, align: int = 32) -> int:
    """A seeded, deliberately-too-small capacity: cap / 2^k (k in 2..4),
    floored to ``align``: small enough to overflow realistic runs,
    aligned enough to plan."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 5))
    return max(align, (cap >> k) // align * align)


def undersize_route_slack(seed: int) -> float:
    """A seeded route_slack in [0.2, 0.45): overflows R-MAT skew at small
    p, heals within <= 3 doublings."""
    rng = np.random.default_rng(seed)
    return float(rng.uniform(0.2, 0.45))


# ---------------------------------------------------------------------------
# the seeded fault matrix (CLI)
# ---------------------------------------------------------------------------


def _grid_for(devices: int) -> Tuple[int, int]:
    grids = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4), 16: (4, 4)}
    if devices not in grids:
        raise ValueError(f"fault matrix supports devices in "
                         f"{sorted(grids)}, got {devices}")
    return grids[devices]


def run_fault_matrix(seed: int = 0, scale: int = 8, edge_factor: int = 8,
                     devices: int = 1, device="cuda") -> Dict:
    """Replay the whole seeded fault schedule on a simulated mesh of
    ``devices`` shards on ``device`` and report each case's verdict: the
    clean run's validation a decomposition, the parent-fault kill
    matrix, ``cap_x`` and ``route_slack`` healing (parents and arrays
    bit-identical to the unfaulted runs), and store shard corruption ->
    quarantine + regeneration; 22 cases, the JAX package's.  A case's
    failure is recorded in its verdict, not raised; the store's
    directory is removed at the end."""
    from repro_torch.ckpt.graph_store import GraphStore
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core import validate as V
    from repro_torch.core.engine import plan_bfs, run_bfs_healed
    from repro_torch.graph.dist_build import BuildSpec, dist_build
    from repro_torch.graph.rmat import rmat_graph
    from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d

    pr, pc = _grid_for(devices)
    spec = BuildSpec(scale=scale, edge_factor=edge_factor, seed=3)
    edges = rmat_graph(scale, edge_factor, seed=3, generator="counter",
                       device=device)
    mesh1 = make_local_mesh_1d(devices, device=device)
    mesh2 = make_local_mesh(pr, pc, device=device)
    root = 5
    cases: List[Dict] = []

    def case(name: str, fn):
        try:
            detail = fn() or {}
            cases.append({"name": name, "ok": True, "detail": detail})
        except Exception as e:                # noqa: BLE001 — report it
            cases.append({"name": name, "ok": False,
                          "detail": {"error": f"{type(e).__name__}: {e}"}})

    def same_arrays(a, b, what):
        b = b.device_arrays()
        for k, v in a.device_arrays().items():
            if not torch.equal(v, b[k].to(v.device)):
                raise AssertionError(f"{what} differs at {k}")

    engines = {}
    results = {}
    for decomp in ("1d", "1ds", "2d"):
        mesh = mesh2 if decomp == "2d" else mesh1
        grid = (pr, pc) if decomp == "2d" else devices
        graph, _ = dist_build(spec, decomp, mesh, grid, align=32,
                              cap_pad=32)
        cfg = BFSConfig(decomposition=decomp, instrument=False)
        eng = plan_bfs(graph, cfg, mesh).compile()
        engines[decomp] = eng

        def clean(eng=eng):
            res = eng.run(root, validate=True)
            results[eng.plan.cfg.decomposition] = res
            return res.validation.to_json()
        case(f"clean/{decomp}", clean)

        for kind in PARENT_FAULTS:
            def kill(eng=eng, kind=kind, decomp=decomp):
                res = results[decomp]
                bad, info = inject_parents(
                    kind, res.parents, root, seed, n=edges.n,
                    src=edges.src, dst=edges.dst,
                    chunk=eng.plan.part.chunk)
                rep = V.validate_parents(eng, root, bad)
                if rep.ok:
                    raise AssertionError(
                        f"validator MISSED injected {kind}: {info}")
                return {"fault": info,
                        "violations": rep.violations}
            case(f"kill/{decomp}/{kind}", kill)

    def heal_cap_x():
        cfg = BFSConfig(decomposition="1ds", instrument=True,
                        direction_optimizing=False)
        base = engines["1ds"].plan
        good = plan_bfs(base.graph, cfg, mesh1).compile().run(root)
        squeezed = undersize_cap(base.part.chunk, seed)
        h = run_bfs_healed(base.graph, cfg, mesh1, root,
                           cap_x=squeezed, validate=True)
        if not np.array_equal(h.result.parents, good.parents):
            raise AssertionError("healed parents differ from unfaulted")
        return {"cap_x0": squeezed, "retry_log": h.retry_log}
    case("heal/cap_x", heal_cap_x)

    def heal_route():
        slack = undersize_route_slack(seed)
        g, info = dist_build(spec, "1ds", mesh1, devices, align=32,
                             cap_pad=32, route_slack=slack)
        same_arrays(engines["1ds"].plan.graph, g, "healed build")
        return {"route_slack0": slack, "retry_log": info["retry_log"]}
    case("heal/route_slack", heal_route)

    tmp = tempfile.mkdtemp(prefix="faultstore_")
    try:
        store = GraphStore(tmp, device=device)
        for decomp, mode in (("1ds", "flip"), ("2d", "truncate")):
            def repair(decomp=decomp, mode=mode):
                g = engines[decomp].plan.graph
                name = f"g_{decomp}"
                store.save_graph(name, g, spec=spec)
                path = corrupt_shard(store, name, seed, mode=mode)
                loaded = store.load_graph(name, expect_spec=spec)
                rep = store.last_load_report
                if not rep["repaired"]:
                    raise AssertionError(f"corruption of {path} undetected")
                same_arrays(g, loaded, "regen")
                return {"corrupted": os.path.basename(path), "mode": mode,
                        "repaired": rep["repaired"]}
            case(f"store/{decomp}/{mode}", repair)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return {"seed": seed, "scale": scale, "edge_factor": edge_factor,
            "devices": devices, "cases": cases,
            "ok": all(c["ok"] for c in cases)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Replay the seeded fault-injection matrix "
                    "(validator kill matrix, capacity healing, store "
                    "shard regeneration) and report JSON verdicts.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scale", type=int, default=8)
    parser.add_argument("--edge-factor", type=int, default=8)
    parser.add_argument("--devices", type=int, default=16,
                        help="shards of the simulated mesh (1, 2, 4, 8 "
                             "or 16)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "versions)")
    parser.add_argument("--json", type=str, default=None,
                        help="write the report to this path")
    args = parser.parse_args(argv)

    report = run_fault_matrix(seed=args.seed, scale=args.scale,
                              edge_factor=args.edge_factor,
                              devices=args.devices, device=args.device)
    for c in report["cases"]:
        status = "ok  " if c["ok"] else "FAIL"
        print(f"  [{status}] {c['name']}")
        if not c["ok"]:
            print(f"         {c['detail']}")
    print(f"fault matrix: {sum(c['ok'] for c in report['cases'])}/"
          f"{len(report['cases'])} cases ok (seed={report['seed']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
