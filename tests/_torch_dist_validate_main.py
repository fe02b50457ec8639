"""Subprocess entry: the port's Graph500 validator, parent-fault injectors
and self-healing 1ds session against the JAX package's on 4 forced host
devices, on the reference validator tests' graph (R-MAT scale 8, edge
factor 8, seed 4, ``align=32``, ``cap_pad=32``): "2d" on 2x2, "1d" and
"1ds" on 4 strips.

For each decomposition: the clean run's parents and its ``(6,)``
verdict, then each of the five parent faults (seed 0): the injected
array and ``info``, and the verdict counts of both packages'
``validate_parents``, bit for bit; every fault is flagged.  The port runs
``local_mode="kernel"`` (the plain versions on the CPU) and "dense".
Then ``run_bfs_healed`` on the 4 strips ("1ds", top-down only, as the
reference's seeded fault matrix heals it) from ``cap_x =
undersize_cap(chunk, seed=0)``: the same ``retry_log``, parents
bit-identical to the unsqueezed run, and with ``max_attempts=1`` the
same ``CapacityOverflow`` message and history.

Run as:  python tests/_torch_dist_validate_main.py
(sets XLA_FLAGS before importing jax, so pytest's process keeps 1 device).
Prints ``OK torch-dist-validate`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro.configs.base import BFSConfig as RConfig  # noqa: E402
from repro.core import validate as r_validate  # noqa: E402
from repro.core.engine import plan_bfs as r_plan_bfs  # noqa: E402
from repro.core.engine import run_bfs_healed as r_healed  # noqa: E402
from repro.graph.formats import build_blocked as r_build_2d  # noqa: E402
from repro.graph.formats import build_blocked_1d as r_build_1d  # noqa: E402
from repro.graph.rmat import rmat_graph as r_rmat_graph  # noqa: E402
from repro.launch.mesh import make_local_mesh as r_mesh  # noqa: E402
from repro.launch.mesh import make_local_mesh_1d as r_mesh_1d  # noqa: E402
from repro.runtime.faultinject import inject_parents as r_inject  # noqa: E402
from repro.runtime.retry import CapacityOverflow as RCapOver  # noqa: E402
from repro_torch.configs.base import BFSConfig  # noqa: E402
from repro_torch.core import validate  # noqa: E402
from repro_torch.core.engine import plan_bfs, run_bfs_healed  # noqa: E402
from repro_torch.graph.formats import build_blocked, build_blocked_1d  # noqa: E402,E501
from repro_torch.graph.rmat import rmat_graph  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d  # noqa: E402,E501
from repro_torch.runtime.faultinject import (PARENT_FAULTS,  # noqa: E402
                                             inject_parents, undersize_cap)
from repro_torch.runtime.retry import CapacityOverflow  # noqa: E402

ROOT = 5
SEED = 0


def graphs(dec, r_edges, t_edges):
    if dec == "2d":
        return (r_build_2d(r_edges, 2, 2, align=32, cap_pad=32),
                build_blocked(t_edges, 2, 2, align=32, cap_pad=32),
                r_mesh(2, 2), make_local_mesh(2, 2, device="cpu"))
    return (r_build_1d(r_edges, 4, align=32, cap_pad=32, with_col_ptr=True),
            build_blocked_1d(t_edges, 4, align=32, cap_pad=32,
                             with_col_ptr=True),
            r_mesh_1d(4), make_local_mesh_1d(4, device="cpu"))


def check_kills(dec, r_edges, t_edges) -> int:
    """The clean verdict and the five faults' verdicts of both packages;
    returns the number of flagged faults."""
    g_r, g_t, mesh_r, mesh_t = graphs(dec, r_edges, t_edges)
    storage = "dcsc" if dec == "1ds" else "csr"
    cfg = dict(decomposition=dec, storage=storage)
    ref = r_plan_bfs(g_r, RConfig(**cfg), mesh_r).compile()
    engines = [plan_bfs(g_t, BFSConfig(**cfg), mesh_t,
                        local_mode=m).compile() for m in ("kernel", "dense")]
    want = ref.run(ROOT, validate=True)
    for eng in engines:
        got = eng.run(ROOT, validate=True)
        assert np.array_equal(want.parents, got.parents), dec
        assert got.validation.to_json() == want.validation.to_json(), dec
    flagged = 0
    chunk = ref.plan.part.chunk
    assert engines[0].plan.part.chunk == chunk
    for kind in PARENT_FAULTS:
        bad_r, info_r = r_inject(kind, want.parents, ROOT, SEED,
                                 n=r_edges.n, src=r_edges.src,
                                 dst=r_edges.dst, chunk=chunk)
        bad_t, info_t = inject_parents(kind, want.parents, ROOT, SEED,
                                       n=t_edges.n, src=t_edges.src,
                                       dst=t_edges.dst, chunk=chunk)
        assert info_t == info_r and np.array_equal(bad_t, bad_r), (
            dec, kind, info_r, info_t)
        rep_r = r_validate.validate_parents(ref, ROOT, bad_r)
        for eng in engines:
            rep = validate.validate_parents(eng, ROOT, bad_t)
            assert rep.to_json() == rep_r.to_json(), (dec, kind, rep_r, rep)
        assert not rep_r.ok, (dec, kind)
        flagged += 1
        print(f"{dec} {kind}: {info_t}; {rep.violations}")
    return flagged


def check_heal(r_edges, t_edges) -> list:
    g_r, g_t, mesh_r, mesh_t = graphs("1ds", r_edges, t_edges)
    kw = dict(decomposition="1ds", storage="dcsc", instrument=True,
              direction_optimizing=False)
    squeezed = undersize_cap(g_t.part.chunk, SEED)
    want = r_healed(g_r, RConfig(**kw), mesh_r, ROOT, cap_x=squeezed,
                    validate=True)
    got = run_bfs_healed(g_t, BFSConfig(**kw), mesh_t, ROOT,
                         cap_x=squeezed, validate=True, local_mode="kernel")
    assert got.retry_log == want.retry_log, (got.retry_log, want.retry_log)
    assert got.retry_log and got.retry_log[0]["outcome"] == "overflow"
    assert got.result.validation.ok
    good = plan_bfs(g_t, BFSConfig(**kw), mesh_t,
                    local_mode="kernel").compile().run(ROOT)
    assert np.array_equal(got.result.parents, good.parents)
    assert np.array_equal(got.result.parents, want.result.parents)
    errs = []
    for healed, exc in ((r_healed, RCapOver),
                        (run_bfs_healed, CapacityOverflow)):
        cfg = (RConfig if exc is RCapOver else BFSConfig)(**kw)
        try:
            healed(g_r if exc is RCapOver else g_t, cfg,
                   mesh_r if exc is RCapOver else mesh_t, ROOT,
                   cap_x=squeezed, max_attempts=1)
        except exc as e:
            errs.append((str(e), e.cap_value, e.history_json()))
    assert len(errs) == 2 and errs[0] == errs[1], errs
    print(f"healed from cap_x={squeezed}: {got.retry_log}; exhausted: "
          f"{errs[1][0]}")
    return got.retry_log


def main():
    r_edges = r_rmat_graph(8, 8, seed=4)
    t_edges = rmat_graph(8, 8, seed=4, device="cpu")
    flagged = sum(check_kills(dec, r_edges, t_edges)
                  for dec in ("2d", "1d", "1ds"))
    assert flagged == 15, flagged
    log = check_heal(r_edges, t_edges)
    print(f"OK torch-dist-validate ({flagged} faults flagged, "
          f"{len(log)} heal attempts)")


if __name__ == "__main__":
    main()
