"""Subprocess entry: the port's born-sharded build on simulated meshes
against the JAX package's ``dist_build`` on 16 forced host devices, on
``BuildSpec(scale=10, edge_factor=16, seed=3)`` (the ``g500-s10`` pin) at
``align=32``, ``cap_pad=32``: "1d" on 4, 7 (a p that does not divide
m_input, so the last slice is short) and 16 strips, "2d" on 2x2, 2x4 and
4x4.  Every field bit-identical, and ``m``, the capacities,
``cap_route``, the three route-word figures and the (empty) retry log
equal.  Then a squeezed ``route_slack`` on 4 strips and on 2x2, where
both packages must heal with the same ``retry_log``: its overflow counts
(the 2D one past the first hop's dropped records) in each message.

Run as:  python tests/_torch_dist_build_main.py
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist-build (N builds)`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro.graph import dist_build as R  # noqa: E402
from repro.launch.mesh import make_local_mesh as r_mesh  # noqa: E402
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d  # noqa: E402
from repro_torch.graph import dist_build as T  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d  # noqa: E402,E501
from repro_torch.runtime.faultinject import undersize_route_slack  # noqa: E402,E501

KW = dict(align=32, cap_pad=32)
CAPS = ("cap", "cap_nzc", "cap_seg", "maxdeg_col", "m", "m_input")
INFO = ("cap_route", "m", "m_input", "route_words_measured",
        "route_words_expected", "route_words_padded", "retry_log")


def meshes(dec, grid):
    if dec == "2d":
        return r_mesh(*grid), make_local_mesh(*grid, device="cpu")
    return r_mesh_1d(grid), make_local_mesh_1d(grid, device="cpu")


def same_build(dec, grid, **kw):
    r_m, t_m = meshes(dec, grid)
    rg, ri = R.dist_build(R.BuildSpec(10, 16, 3), dec, r_m, grid, **KW,
                          **kw)
    tg, ti = T.dist_build(T.BuildSpec(10, 16, 3), dec, t_m, grid, **KW,
                          **kw)
    tag = f"{dec} {grid} {kw}"
    assert type(rg).__name__ == type(tg).__name__, tag
    for c in CAPS:
        assert getattr(rg, c, None) == getattr(tg, c, None), (tag, c)
    ra, ta = rg.device_arrays(), tg.device_arrays()
    assert set(ra) == set(ta), (tag, sorted(ra), sorted(ta))
    for k, v in ra.items():
        assert np.array_equal(np.asarray(v), ta[k].numpy()), (tag, k)
    for k in INFO:
        want = ri[k]
        want = tuple(want) if isinstance(want, tuple) else want
        assert want == ti[k], (tag, k, want, ti[k])
    return ti


def main():
    n = 0
    for dec, grid in (("1d", 4), ("1d", 7), ("1d", 16), ("2d", (2, 2)),
                      ("2d", (2, 4)), ("2d", (4, 4))):
        same_build(dec, grid)
        n += 1
    slack = undersize_route_slack(0)
    for dec, grid in (("1d", 4), ("2d", (2, 2))):
        info = same_build(dec, grid, route_slack=slack)
        log = info["retry_log"]
        assert len(log) > 1 and log[-1]["outcome"] == "ok", (dec, log)
        n += 1
    print(f"OK torch-dist-build ({n} builds)")


if __name__ == "__main__":
    main()
