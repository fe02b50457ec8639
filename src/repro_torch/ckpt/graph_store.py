"""The graph store: a built graph persisted shard by shard, loaded back
onto a mesh with each shard's CRC checked, and a corrupted shard
regenerated from the counter stream (the JAX package's
``ckpt/graph_store.py``, format for format).

Built on ``ckpt/checkpoint.py``'s primitives (atomic tmp + rename
publish, step directories, retention, meta validation), the store keeps
the device arrays of a ``Blocked1DGraph`` / ``BlockedGraph`` (host- or
device-built) plus what reconstructs the dataclass: partition,
capacities, per-field shapes and dtypes, and the config hash of the
BuildSpec that generated the edges.  Loading with a mesh lands each field
on the mesh's device in its ``(p, ...)`` or ``(pr, pc, ...)`` layout.  A
graph load FAILS on a spec-hash or mesh-shape mismatch: a wrong graph is
worse than a rebuild.

The JAX package also persists its compiled search program
(``serialize_executable``).  The port builds no program it could
persist (a session is its CUDA kernels, built once per checkout, and
Python), so ``save_executable``/``load_executable`` return None, as the
JAX package's do where its serializer is absent, and a session always
builds fresh.

Store layout (format v2, one file PER SHARD), the JAX package's, so a
store written by either package loads in the other::

    <root>/graphs/<name>/step_NNNNNNNNNN/{shard_00000.npz, ...,
                                          meta.json}

**Content integrity.**  ``meta.json`` carries a CRC32 per shard (over
each array's name, numpy dtype, shape and raw bytes, not over the npz
container, whose zip timestamps are not reproducible).  ``load_graph``
checks every shard's CRC; a corrupted, truncated or unreadable shard is
quarantined (renamed ``*.quarantined``) and regenerated in place from
the stored BuildSpec's counter stream (``graph/dist_build.py::
regen_shard``, on the store's device: the counter kernel on a card).  The
regenerated arrays must reproduce the stored CRC exactly or the load
fails; ``store.last_load_report`` records what was checked and
repaired.  Writers that crash between ``mkdtemp`` and the atomic rename
leak ``.tmp_*`` directories, which ``GraphStore.__init__`` sweeps.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zlib
from dataclasses import asdict, is_dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.core.engine import plan_bfs
from repro_torch.core.partition import Partition1D, Partition2D
from repro_torch.graph.dist_build import BuildSpec, regen_shard
from repro_torch.graph.formats import Blocked1DGraph, BlockedGraph
from repro_torch.launch.mesh import resolve_device

FORMAT_VERSION = 2

_GRAPH_KINDS = {"Blocked1DGraph": Blocked1DGraph,
                "BlockedGraph": BlockedGraph}
# dataclass fields that are ints/metadata, not shipped arrays
_SCALAR_FIELDS = {
    "Blocked1DGraph": ("cap", "cap_nzc", "maxdeg_col"),
    "BlockedGraph": ("cap", "cap_seg", "maxdeg_col"),
}


def _mesh_axes(mesh) -> list:
    return [[str(k), int(v)] for k, v in mesh.shape.items()]


def shard_crc32(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 over one shard's host arrays in a canonical byte stream: for
    each field in sorted order, its name, numpy dtype string ("int32"),
    shape as int64 bytes and raw C-contiguous bytes.  The JAX package's
    to the bit: the same arrays give the same CRC in either package."""
    c = 0
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        c = zlib.crc32(k.encode(), c)
        c = zlib.crc32(str(v.dtype).encode(), c)
        c = zlib.crc32(np.asarray(v.shape, np.int64).tobytes(), c)
        c = zlib.crc32(v.tobytes(), c)
    return c & 0xFFFFFFFF


def _shard_slice(arrays: Dict[str, np.ndarray], part,
                 k: int) -> Dict[str, np.ndarray]:
    """Shard ``k``'s slice of every field (leading block dims dropped:
    (p, ...) -> (...) for strips, (pr, pc, ...) -> (...) for 2d)."""
    if isinstance(part, Partition1D):
        return {f: v[k] for f, v in arrays.items()}
    return {f: v[k // part.pc, k % part.pc] for f, v in arrays.items()}


def _part_from_meta(meta: Dict) -> Any:
    pm = json.loads(meta["part"])
    if pm["kind"] == "1d":
        return Partition1D(n=pm["n"], n_orig=pm["n_orig"], p=pm["p"])
    return Partition2D(n=pm["n"], n_orig=pm["n_orig"], pr=pm["pr"],
                       pc=pm["pc"])


class GraphStore:
    """One directory of persisted graphs (see the module docstring for
    its layout).  ``keep`` bounds the retained steps a name, as the
    checkpoint retention does; ``device`` is where a corrupted shard is
    regenerated (the card unless the caller asks for the CPU)."""

    def __init__(self, root: str, keep: int = 3, device="cuda"):
        self.root = root
        self.keep = keep
        self.device = resolve_device(device)
        # the most recent load_graph's forensics (shards checked,
        # shards repaired and why); None until a graph is loaded
        self.last_load_report: Optional[Dict[str, Any]] = None
        # a writer that died between mkdtemp and the atomic rename left
        # a .tmp_* dir that can never be published: swept on open (one
        # writer at a time: opening a store while another process saves
        # into it is outside the store's contract)
        self.swept: List[str] = self._sweep_tmp()

    def _sweep_tmp(self) -> List[str]:
        removed = []
        if not os.path.isdir(self.root):
            return removed
        for dirpath, dirnames, _ in os.walk(self.root):
            for d in list(dirnames):
                if d.startswith(".tmp_"):
                    full = os.path.join(dirpath, d)
                    shutil.rmtree(full, ignore_errors=True)
                    dirnames.remove(d)
                    removed.append(full)
        return removed

    # ------------------------------------------------------------------
    # graphs
    # ------------------------------------------------------------------

    def _graph_dir(self, name: str) -> str:
        return os.path.join(self.root, "graphs", name)

    def save_graph(self, name: str, graph, spec=None,
                   step: Optional[int] = None,
                   extra_meta: Optional[Dict] = None) -> str:
        """Persist a graph's arrays and its reconstruction metadata under
        ``graphs/<name>/step_*`` (atomic publish, ``keep`` retention).
        ``spec`` (a ``dist_build.BuildSpec``) is hashed into the meta so
        that loads can check they get the graph they asked for, and
        stored so that a corrupted shard can be regenerated."""
        kind = type(graph).__name__
        if kind not in _GRAPH_KINDS:
            raise TypeError(f"cannot store graph of type {kind!r}")
        part = graph.part
        arrays = {k: v.cpu().numpy()
                  for k, v in graph.device_arrays().items()}
        if isinstance(part, Partition1D):
            part_meta = {"kind": "1d", "n": part.n, "n_orig": part.n_orig,
                         "p": part.p}
        else:
            part_meta = {"kind": "2d", "n": part.n, "n_orig": part.n_orig,
                         "pr": part.pr, "pc": part.pc}
        meta = {
            "graph_kind": kind, "format_version": FORMAT_VERSION,
            "part": json.dumps(part_meta, sort_keys=True),
            "m": int(graph.m), "m_input": int(graph.m_input),
            "scalars": json.dumps(
                {f: int(getattr(graph, f)) for f in _SCALAR_FIELDS[kind]},
                sort_keys=True),
            "fields": json.dumps(
                {k: [list(v.shape), str(v.dtype)]
                 for k, v in sorted(arrays.items())}),
            **({"spec_hash": checkpoint.config_hash(spec),
                "spec": json.dumps(asdict(spec), sort_keys=True)}
               if is_dataclass(spec) and spec is not None else {}),
            **(extra_meta or {}),
        }
        if step is None:
            latest = checkpoint.latest_step(self._graph_dir(name))
            step = 0 if latest is None else latest + 1
        shards = [_shard_slice(arrays, part, k) for k in range(part.p)]
        meta["shards"] = len(shards)
        meta["shard_crc32"] = [shard_crc32(s) for s in shards]
        gdir = self._graph_dir(name)
        os.makedirs(gdir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=gdir, prefix=".tmp_")
        try:
            for k, s in enumerate(shards):
                np.savez(os.path.join(tmp, f"shard_{k:05d}.npz"), **s)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({**meta, "step": step, "saved_at": time.time()},
                          f)
            final = os.path.join(gdir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        checkpoint._retain(gdir, self.keep)
        return final

    def _read_shard(self, path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def _repair_shard(self, path: str, k: int, meta: Dict, part,
                      want_crc: int) -> Dict[str, np.ndarray]:
        """Quarantine shard ``k``'s file and regenerate its arrays from
        the stored BuildSpec's counter stream on the store's device; the
        result must hit the stored CRC exactly (stream-slice independence
        makes the regeneration bit-identical to the build) or the repair
        fails."""
        if "spec" not in meta:
            raise RuntimeError(
                f"shard {k} of {os.path.dirname(path)} failed its CRC "
                f"check and the graph was stored without a BuildSpec — "
                f"cannot regenerate")
        if os.path.exists(path):
            os.replace(path, path + ".quarantined")
        spec = BuildSpec(**json.loads(meta["spec"]))
        arrs = regen_shard(spec, meta["graph_kind"], part, k,
                           json.loads(meta["scalars"]),
                           json.loads(meta["fields"]), device=self.device)
        got = shard_crc32(arrs)
        if got != want_crc:
            raise RuntimeError(
                f"regenerated shard {k} CRC {got:#010x} does not match "
                f"the stored CRC {want_crc:#010x} — the store meta and "
                f"the BuildSpec disagree; refusing to publish")
        tmp = path + ".tmp_regen.npz"
        try:
            np.savez(tmp, **arrs)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return arrs

    def load_graph(self, name: str, mesh=None,
                   step: Optional[int] = None, expect_spec=None,
                   row_axis: str = "data", col_axis: str = "model",
                   repair: bool = True):
        """Reconstruct a stored graph, checking every shard's CRC.

        ``expect_spec`` makes a stale graph fail (a spec-hash mismatch
        raises instead of handing back the wrong edges); ``mesh`` has its
        axis sizes checked against the stored partition, and every array
        lands on ``mesh.device`` in the grid layout, ready for
        ``BFSEngine`` to use as it is.  Without a mesh the arrays stay on
        the host (CPU tensors).

        A shard whose file is corrupted, truncated or missing is
        quarantined and regenerated from the stored BuildSpec
        (``repair=False`` raises instead); the regenerated shard must
        reproduce the stored CRC bit for bit.  ``self.last_load_report``
        records the outcome either way."""
        gdir = self._graph_dir(name)
        if step is None:
            step = checkpoint.latest_step(gdir)
            if step is None:
                raise FileNotFoundError(f"no graph steps under {gdir}")
        sdir = os.path.join(gdir, f"step_{step:010d}")
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"graph {name!r} step {step} has format_version="
                f"{meta.get('format_version')}; this reader handles "
                f"{FORMAT_VERSION} (re-save the graph)")
        if expect_spec is not None:
            want = checkpoint.config_hash(expect_spec)
            if meta.get("spec_hash") != want:
                raise ValueError(
                    f"graph {name!r} step {step} spec_hash="
                    f"{meta.get('spec_hash')} does not match the "
                    f"expected spec ({want})")
        part = _part_from_meta(meta)
        if isinstance(part, Partition1D):
            axes, sizes = (row_axis,), (part.p,)
        else:
            axes, sizes = (row_axis, col_axis), (part.pr, part.pc)
        if mesh is not None:
            for ax, want in zip(axes, sizes):
                have = dict(mesh.shape).get(ax)
                if have != want:
                    raise ValueError(
                        f"stored graph {name!r} was partitioned for "
                        f"{ax}={want} but the mesh has {ax}={have} "
                        f"(mesh axes {_mesh_axes(mesh)})")
        fields = json.loads(meta["fields"])
        crcs = meta["shard_crc32"]
        shards = []
        repaired = []
        for k in range(meta["shards"]):
            path = os.path.join(sdir, f"shard_{k:05d}.npz")
            arrs, err = None, None
            try:
                arrs = self._read_shard(path)
                got = shard_crc32(arrs)
                if got != crcs[k]:
                    err = (f"CRC mismatch: {got:#010x} != stored "
                           f"{crcs[k]:#010x}")
            except Exception as e:       # unreadable/truncated npz
                err = f"unreadable shard: {e}"
            if err is not None:
                if not repair:
                    raise RuntimeError(
                        f"graph {name!r} step {step} shard {k}: {err} "
                        f"(repair disabled)")
                arrs = self._repair_shard(path, k, meta, part, crcs[k])
                repaired.append({"shard": k, "reason": err})
            shards.append(arrs)
        self.last_load_report = {
            "name": name, "step": step, "shards": meta["shards"],
            "repaired": repaired,
        }
        dev = torch.device("cpu") if mesh is None else mesh.device
        arrays = {}
        for fname, (shape, dt) in fields.items():
            stacked = np.stack([s.pop(fname) for s in shards])
            arrays[fname] = torch.from_numpy(
                stacked.reshape(shape).astype(dt, copy=False)).to(dev)
            del stacked
        cls = _GRAPH_KINDS[meta["graph_kind"]]
        return cls(part=part, m_input=meta["m_input"], m=meta["m"],
                   **json.loads(meta["scalars"]), **arrays)

    # ------------------------------------------------------------------
    # executables
    # ------------------------------------------------------------------

    def save_executable(self, engine, key: str = "default") -> None:
        """The JAX package persists a session's compiled program here.
        The port has no program to persist (its kernels are built once
        a checkout, the rest is Python): None, as the JAX package
        returns where its serializer is absent."""
        return None

    def load_executable(self, plan, key: str = "default") -> None:
        """Always a miss (see ``save_executable``): ``BFSPlan.compile``
        builds the session fresh."""
        return None


def plan_bfs_from_store(store: GraphStore, name: str, cfg, mesh,
                        expect_spec=None, **plan_kw):
    """The disk -> traversal entry point: load a stored graph onto
    ``mesh`` and plan a session over it.  Chain with
    ``.compile(store=store)`` as with the JAX package (the port finds no
    stored program and builds one)."""
    graph = store.load_graph(name, mesh=mesh, expect_spec=expect_spec)
    return plan_bfs(graph, cfg, mesh, **plan_kw)
