"""The JAX package's dry-run cells and 2D cells as the port's tests hold
them, in a subprocess with forced host devices.

    python tests/_torch_cells_main.py cells OUT.json
        512 devices: every cell of ``all_cells() + bfs_cells()``, the
        hill-climb records' cells and the BFS level cells on both
        production meshes, built (``jax.eval_shape`` only, nothing
        compiled): each cell's label, meta, the shapes and dtypes of the
        arguments that are not parameters or optimizer state, and the
        bytes of those two; a skipped cell's dry-run reason.
    python tests/_torch_cells_main.py optimized IN.npz OUT.npz
        4 devices: gin-tu-2d and mace-2d at full_graph_sm on 2x2, one
        step each on IN's seeded inputs (jit, run): the loss and the
        updated parameters.
    python tests/_torch_cells_main.py level OUT.json
        16 devices: the bfs-rmat level cell at scale 10 on 4x4, lowered
        and compiled: ``collective_bytes_from_hlo`` of its HLO.
"""
import json
import os
import sys

_DEVICES = {"cells": 512, "optimized": 4, "level": 16}
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                           f"{_DEVICES[sys.argv[1]]}")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import cells  # noqa: E402
from repro.optim.adamw import AdamWState  # noqa: E402

HILLCLIMB = (
    ("bfs-rmat-i1", "scale30"), ("bfs-rmat-i2", "scale30"),
    ("bfs-rmat-opt", "scale30"), ("gin-tu-2d", "ogb_products"),
    ("mace-2d", "ogb_products"), ("bfs-rmat-multiroot", "scale22"),
    ("qwen3-moe-r2", "train_4k"), ("qwen3-moe-r3", "train_4k"))


def _bytes(tree) -> int:
    return int(sum(np.prod(x.shape) * np.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree)))


def summary(cell):
    fam = cell.meta["family"]
    rest = list(cell.args)
    out = {"label": cell.label, "meta": cell.meta, "params": None,
           "opt": None}
    if fam != "bfs":
        out["params"] = _bytes(rest.pop(0))
    if rest and isinstance(rest[0], AdamWState):
        out["opt"] = _bytes(rest.pop(0))
    out["args"] = [[list(x.shape), str(x.dtype)]
                   for x in jax.tree_util.tree_leaves(rest)]
    return out


def main_cells(path):
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh
    todo = [(a, s, {}) for a, s in cells.all_cells() + cells.bfs_cells()]
    todo += [(a, s, {}) for a, s in HILLCLIMB]
    todo += [(a, s, {"level_only": True}) for a, s in cells.bfs_cells()]
    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape, kw in todo:
            key = f"{arch}/{shape}/{'level' if kw else 'cell'}/" \
                  f"{'mp' if mp else 'sp'}"
            cell = cells.build_cell(arch, shape, mesh, **kw)
            out[key] = (summary(cell) if cell is not None else
                        {"skipped": dryrun.run_cell(arch, shape, mp)["reason"]})
    with open(path, "w") as f:
        json.dump(out, f)


def main_optimized(src, dst):
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh
    from repro.launch.optimized import build_gin2d_cell, build_mace2d_cell
    data = dict(np.load(src))
    mesh = make_mesh(2, 2)
    out = {}
    for name, build in (("gin", build_gin2d_cell), ("mace", build_mace2d_cell)):
        cell = build("full_graph_sm", mesh)
        pre = f"{name}/"
        params = {k[len(pre) + 2:]: jnp.asarray(v) for k, v in data.items()
                  if k.startswith(pre + "p/")}
        opt = cell.args[1]
        ost = AdamWState(step=jnp.zeros((), jnp.int32),
                         mu=jax.tree.map(jnp.zeros_like, params),
                         nu=jax.tree.map(jnp.zeros_like, params))
        inputs = [jnp.asarray(data[pre + f"a{i}"])
                  for i in range(len(cell.args) - 2)]
        del opt
        p2, _, loss = jax.jit(cell.fn)(params, ost, *inputs)
        out[pre + "loss"] = np.asarray(loss)
        for k, v in p2.items():
            out[pre + "p/" + k] = np.asarray(v)
    np.savez(dst, **out)


def main_level(path):
    from repro.configs.base import BFSShape, get_config
    from repro.launch.mesh import make_mesh
    from repro.launch.roofline import collective_bytes_from_hlo
    cell = cells.build_bfs_cell(get_config("bfs-rmat"), BFSShape("scale10", 10),
                                make_mesh(4, 4), level_only=True)
    compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(
        *cell.args).compile()
    with open(path, "w") as f:
        json.dump(collective_bytes_from_hlo(compiled.as_text()), f)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "cells":
        main_cells(sys.argv[2])
    elif mode == "optimized":
        main_optimized(sys.argv[2], sys.argv[3])
    else:
        main_level(sys.argv[2])
    print(f"OK torch-cells {mode}")
