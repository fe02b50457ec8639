"""Subprocess entry: the port's 1d/1ds sessions on a 16-strip simulated
mesh against the JAX package's ``local_mode="dense"`` 1d/1ds sessions on
16 forced host devices, at scale 11 (n = 2048, chunk = 128): the
instrumented ones (``CASES``) in everything they return, the
``instrument=False`` ones (``FAST_CASES``) in parents and levels.

Run as:  python tests/_torch_dist_1d_main.py
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist-1d`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from _torch_dist_main import same_result  # noqa: E402
from repro.configs.base import BFSConfig as RConfig  # noqa: E402
from repro.core.engine import plan_bfs as r_plan_bfs  # noqa: E402
from repro.graph.formats import build_blocked_1d as r_build_1d  # noqa: E402
from repro.graph.rmat import rmat_graph as r_rmat_graph  # noqa: E402
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d  # noqa: E402
from repro_torch.configs.base import BFSConfig  # noqa: E402
from repro_torch.core.engine import plan_bfs  # noqa: E402
from repro_torch.graph.formats import build_blocked_1d  # noqa: E402
from repro_torch.graph.rmat import rmat_graph  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh_1d  # noqa: E402

P = 16
# (decomposition, frontier_codec, expand_chunks, direction_optimizing,
#  cap_x): cap_x 0 is the planned capacity (32 at this size); cap_x 4
#  makes the wider top-down levels of the top-down-only runs overflow
CASES = [("1ds", "packed", 1, True, 0), ("1ds", "packed", 2, True, 0),
         ("1ds", "packed", 1, False, 4), ("1ds", "packed", 2, False, 4),
         ("1ds", "none", 1, True, 0), ("1ds", "none", 2, False, 4),
         ("1d", "packed", 1, True, 0), ("1d", "packed", 2, False, 0)]
# the same fields, run with instrument=False: 1ds packed at 1 and 2
# expand steps with overflowing buckets, 1ds raw, and 1d
FAST_CASES = [("1ds", "packed", 1, False, 4), ("1ds", "packed", 2, False, 4),
              ("1ds", "none", 1, True, 0), ("1d", "packed", 1, True, 0)]


def main():
    r_edges = r_rmat_graph(11, 16, seed=1)
    t_edges = rmat_graph(11, 16, seed=1, device="cpu")
    deg = r_edges.out_degrees()
    roots = [int(r) for r in np.flatnonzero(deg > 0)[[0, 300]]]
    g_r = r_build_1d(r_edges, P, align=32, cap_pad=32)
    g_t = build_blocked_1d(t_edges, P, align=32, cap_pad=32)
    mesh = make_local_mesh_1d(P, device="cpu")
    over_levels = 0
    for dec, codec, chunks, diro, cap_x in CASES:
        kw = dict(decomposition=dec, storage="dcsc", frontier_codec=codec,
                  expand_chunks=chunks, direction_optimizing=diro)
        ref = r_plan_bfs(g_r, RConfig(**kw), r_mesh_1d(P), local_mode="dense",
                         cap_x=cap_x).compile()
        for local_mode in ("dense", "kernel"):
            eng = plan_bfs(g_t, BFSConfig(**kw), mesh, local_mode=local_mode,
                           cap_x=cap_x).compile()
            assert eng.plan.statics.cap_x == ref.plan.statics.cap_x
            for root in roots:
                want, got = ref.run(root), eng.run(root)
                same_result(want, got, local_mode,
                            (dec, codec, chunks, diro, cap_x, local_mode,
                             root))
                if dec == "1ds":
                    # a top-down level that overflowed paid the bitmap
                    st = got.level_stats[:got.n_levels]
                    dense = np.float32((P - 1) * (g_t.part.n / 64.0))
                    over_levels += int(np.sum((st[:, 2] == 0)
                                              & (st[:, 4] == dense)))
        print(dec, codec, chunks, diro, cap_x, "ok", flush=True)
    assert over_levels > 0, "no top-down level overflowed its buckets"
    for dec, codec, chunks, diro, cap_x in FAST_CASES:
        kw = dict(decomposition=dec, storage="dcsc", frontier_codec=codec,
                  expand_chunks=chunks, direction_optimizing=diro)
        ref = r_plan_bfs(g_r, RConfig(instrument=False, **kw), r_mesh_1d(P),
                         local_mode="dense", cap_x=cap_x).compile()
        instr = plan_bfs(g_t, BFSConfig(**kw), mesh, local_mode="kernel",
                         cap_x=cap_x).compile()
        for local_mode in ("dense", "kernel"):
            eng = plan_bfs(g_t, BFSConfig(instrument=False, **kw), mesh,
                           local_mode=local_mode, cap_x=cap_x).compile()
            for root in roots:
                want, got = ref.run(root), eng.run(root)
                tag = (dec, codec, chunks, diro, cap_x, local_mode, root)
                assert want.counters == {} and got.counters == {}, tag
                assert not got.level_stats.any(), tag
                for other in (want, instr.run(root)):
                    assert np.array_equal(got.parents, other.parents), tag
                    assert got.n_levels == other.n_levels, tag
        print("fast", dec, codec, chunks, diro, cap_x, "ok", flush=True)
    print("OK torch-dist-1d")


if __name__ == "__main__":
    main()
