"""The port's dry-run cells (``launch/cells.py``, ``launch/optimized.py``)
against the JAX package's, built in a subprocess on 512 forced host
devices (``_torch_cells_main.py cells``: ``jax.eval_shape`` only).

For every cell of ``all_cells() + bfs_cells()``, the eight hill-climb
records' cells and the BFS level cells, on both production meshes, the
port's cell, built on ``meta``, has the JAX cell's label and meta, the
same shapes and dtypes of every argument that is not a parameter or
optimizer state, and the same bytes of those two; a skipped cell is None
in both, with the JAX dry-run's reason.  Also: the production meshes
and ``typing.get_type_hints(SimMesh)``."""
import json
import os
import subprocess
import sys
import typing

import pytest
import torch

from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import (SimMesh, make_mesh,
                                     make_production_mesh)
from repro_torch.optim.adamw import AdamWState
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)

KEYS = [f"{a}/{s}/cell/{m}" for m in ("sp", "mp")
        for a, s in (cells.all_cells() + cells.bfs_cells()
                     + [(a, s) for a, s, _ in cells.HILLCLIMB_CELLS])]
KEYS += [f"{a}/{s}/level/{m}" for m in ("sp", "mp")
         for a, s in cells.bfs_cells()]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells") / "ref.json"
    r = subprocess.run([sys.executable, os.path.join(_HERE,
                                                     "_torch_cells_main.py"),
                        "cells", str(out)], capture_output=True, text=True,
                       timeout=300, env={**os.environ, **ONE_THREAD_ENV})
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(out.read_text())


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for x in tree for t in _leaves(x)]


def port_summary(cell):
    rest = list(cell.args)
    out = {"label": cell.label, "meta": cell.meta, "params": None,
           "opt": None}
    if cell.meta["family"] != "bfs":
        out["params"] = _bytes(rest.pop(0))
    if rest and isinstance(rest[0], AdamWState):
        out["opt"] = _bytes(rest.pop(0))
    out["args"] = [[list(t.shape), str(t.dtype).split(".")[-1]]
                   for t in _leaves(rest)]
    return out


@pytest.mark.parametrize("key", KEYS)
def test_cell_matches_reference(ref, key):
    arch, shape, kind, mesh_tag = key.split("/")
    mesh = make_production_mesh(multi_pod=mesh_tag == "mp", device="meta")
    kw = {"level_only": True} if kind == "level" else {}
    cell = cells.build_cell(arch, shape, mesh, **kw)
    want = ref[key]
    if "skipped" in want:
        assert cell is None
        rec = dryrun.run_cell(arch, shape, mesh_tag == "mp")
        assert rec["skipped"] and rec["reason"] == want["skipped"]
        return
    got = port_summary(cell)
    assert json.loads(json.dumps(got)) == want
    assert all(t.is_meta for t in _leaves(cell.args))


def test_every_key_is_built_by_the_reference(ref):
    assert sorted(ref) == sorted(KEYS)


def test_production_meshes_and_type_hints():
    hints = typing.get_type_hints(SimMesh)
    assert hints["pods"] == typing.Optional[int]
    sp = make_production_mesh(device="meta")
    mp = make_production_mesh(multi_pod=True, device="meta")
    assert sp.shape == {"data": 16, "model": 16} and sp.size == 256
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    assert make_mesh(2, 4, device="cpu").shape == {"data": 2, "model": 4}
    assert make_mesh(2, 4, pods=3, device="meta").size == 24


def test_per_device_bytes_follow_the_specs():
    mesh = make_production_mesh(device="meta")
    cell = cells.build_cell("smollm-135m", "prefill_32k", mesh)
    toks = cell.args[1]
    assert cells.per_device_bytes(toks, ("data", None), mesh) \
        == toks.numel() * 4 // 16
    assert cells.per_device_bytes(toks, (("pod", "data"), None),
                                  make_production_mesh(multi_pod=True,
                                                       device="meta")) \
        == toks.numel() * 4 // 32
    assert cells.per_device_bytes(toks, None, mesh) == toks.numel() * 4
