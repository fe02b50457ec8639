"""Subprocess entry: every registered ``bfs-rmat*`` arch of the port
against the JAX package's ``local_mode="dense"`` session of the same arch
on 16 forced host devices, the 2D archs on 2x2 and 4x4 grids, the 1D
ones on 4 and 16 strips, each in the port's dense and kernel modes.

Parents, n_levels, level_stats and counters must be equal
(``same_result``).  The capped exchanges that drop by design
(``bitmap_pure`` winners past ``cap_w``, compact-pure finds past
``cap_u``) must be seen to overflow, so the drops are pinned bit for
bit.

Run as:  python tests/_torch_dist_archs_main.py 2d|1d
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist-archs <mode>`` on success.
"""
import os
import sys
from dataclasses import replace

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

from _torch_dist_main import same_result  # noqa: E402
from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.core.engine import plan_bfs as r_plan_bfs  # noqa: E402
from repro.graph.formats import build_blocked as r_build_blocked  # noqa: E402
from repro.graph.formats import build_blocked_1d as r_build_blocked_1d  # noqa: E402,E501
from repro.graph.rmat import rmat_graph as r_rmat_graph  # noqa: E402
from repro.launch.mesh import make_local_mesh as r_mesh  # noqa: E402
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.core import steps  # noqa: E402
from repro_torch.core.engine import plan_bfs  # noqa: E402
from repro_torch.graph.formats import build_blocked, build_blocked_1d  # noqa: E402,E501
from repro_torch.graph.rmat import rmat_graph  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d  # noqa: E402,E501

SCALE, EDGE_FACTOR, SEED = 12, 8, 5


def _archs(decomps):
    return [a for a in list_archs() if a.startswith("bfs-rmat")
            and get_config(a).decomposition in decomps]


class Overflows:
    """Watches the capped exchanges of ``core/steps.py``: the largest
    win count a bitmap fold saw against ``cap_w``, and the largest find
    count a compact sub-step packed against ``cap_u``."""

    def __init__(self):
        self.fold, self.compact = [], []
        self._fold_bitmap = steps._fold_bitmap
        self._pack_ids = steps.pack_ids

    def __enter__(self):
        def fold(cand, pc, chunk, cap_w):
            t, counts = self._fold_bitmap(cand, pc, chunk, cap_w)
            self.fold.append(int(counts.max()) > cap_w)
            return t, counts

        def pack(mask, cap, offset, sentinel):
            self.compact.append(int(mask.sum(dim=-1).max()) > cap)
            return self._pack_ids(mask, cap, offset, sentinel)
        steps._fold_bitmap, steps.pack_ids = fold, pack
        return self

    def __exit__(self, *exc):
        steps._fold_bitmap, steps.pack_ids = self._fold_bitmap, self._pack_ids


def main(mode: str):
    r_edges = r_rmat_graph(SCALE, EDGE_FACTOR, seed=SEED)
    t_edges = rmat_graph(SCALE, EDGE_FACTOR, seed=SEED, device="cpu")
    deg = r_edges.out_degrees()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 90, 700]]]
    seen = {}
    if mode == "2d":
        grids = [((pr, pc), r_build_blocked(r_edges, pr, pc, align=32,
                                            cap_pad=32),
                  build_blocked(t_edges, pr, pc, align=32, cap_pad=32),
                  r_mesh(pr, pc), make_local_mesh(pr, pc, device="cpu"))
                 for pr, pc in ((2, 2), (4, 4))]
        archs = _archs(("2d",))
    else:
        grids = [(p, r_build_blocked_1d(r_edges, p, align=32, cap_pad=32,
                                        with_col_ptr=True),
                  build_blocked_1d(t_edges, p, align=32, cap_pad=32,
                                   with_col_ptr=True),
                  r_mesh_1d(p), make_local_mesh_1d(p, device="cpu"))
                 for p in (4, 16)]
        archs = _archs(("1d", "1ds"))
        # the bottom-up knobs the JAX package honours on the strips too
        # (use_edge_dst in dense mode) or ignores (compact_updates)
        archs += [(a, dict(use_edge_dst=True, compact_updates=True))
                  for a in ("bfs-rmat-1d", "bfs-rmat-1ds-pipe")]
    for arch in archs:
        arch, kw = arch if isinstance(arch, tuple) else (arch, {})
        for grid, g_r, g_t, m_r, m_t in grids:
            ref = r_plan_bfs(g_r, replace(r_get_config(arch), **kw), m_r,
                             local_mode="dense").compile()
            want = [ref.run(r) for r in roots]
            for local_mode in ("dense", "kernel"):
                eng = plan_bfs(g_t, replace(get_config(arch), **kw), m_t,
                               local_mode=local_mode).compile()
                with Overflows() as ov:
                    for r, w in zip(roots, want):
                        same_result(w, eng.run(r), local_mode,
                                    (arch, grid, local_mode, r))
                seen[(arch, grid, local_mode)] = (any(ov.fold),
                                                  any(ov.compact))
            print(f"{arch} {kw or ''} {grid}: dense and kernel == reference",
                  flush=True)
    if mode == "2d":
        for local_mode in ("dense", "kernel"):
            # the drops of bitmap_pure and of compact-pure are pinned
            for arch, i in (("bfs-rmat-i1", 0), ("bfs-rmat-i2", 0),
                            ("bfs-rmat-opt", 0), ("bfs-rmat-opt", 1)):
                assert any(seen[(arch, g[0], local_mode)][i]
                           for g in grids), (arch, i, local_mode)
    print(f"OK torch-dist-archs {mode}")


if __name__ == "__main__":
    main(sys.argv[1])
