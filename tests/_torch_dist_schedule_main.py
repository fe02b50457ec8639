"""Subprocess entry: the 2D schedule variants whose exchanges the port
now issues as the JAX package does (the exact "bitmap" fold with its
dense fallback, compact runtime updates with theirs, and the R/G split
ring at expand_chunks 2) against the JAX package's dense sessions, on
the schedule sweep's scale-9 2x4 grid of 8 forced host devices
(``analysis/registry.py``'s family, built by each package's own
registry), in the port's dense and kernel modes.

Parents, n_levels, level_stats and counters must be equal
(``same_result``), instrumented and not, and a variant's fallbacks must
be seen to fire (the fold's where it folds by "bitmap", the update's
where it sends compact updates), so their dense branch is what the equal
parents come through.

Run as:  python tests/_torch_dist_schedule_main.py VARIANT
with VARIANT one of ``CASES``' names (sets XLA_FLAGS before importing
jax): each variant is a process of its own, so the four can run side by
side.  Prints ``OK torch-dist-schedule VARIANT (F fold and U update
overflows)`` on success.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

from _torch_dist_main import same_result  # noqa: E402
from repro.analysis.registry import plan_case as r_plan_case  # noqa: E402
from repro_torch.analysis.registry import plan_case  # noqa: E402
from repro_torch.core import steps  # noqa: E402

CASES = {
    "bitmap": {"fold_mode": "bitmap"},
    "compact_updates": {"compact_updates": True},
    "expand_chunks=2": {"expand_chunks": 2},
    "all": {"fold_mode": "bitmap", "compact_updates": True,
            "expand_chunks": 2},
}


def main(variant: str):
    ov = CASES[variant]
    fold_over, upd_over = [], []
    bitmap, pack = steps._fold_bitmap, steps.pack_ids

    def watch_fold(cand, pc, chunk, cap_w):
        t, counts = bitmap(cand, pc, chunk, cap_w)
        fold_over.append(int(counts.max()) > cap_w)
        return t, counts

    def watch_pack(mask, cap, offset, sentinel):
        upd_over.append(int(mask.sum(dim=-1).max()) > cap)
        return pack(mask, cap, offset, sentinel)

    steps._fold_bitmap, steps.pack_ids = watch_fold, watch_pack
    roots = None
    for instrument in (True, False):
        ref = r_plan_case("2d", ov, instrument=instrument).compile()
        if roots is None:
            deg = np.asarray(ref.plan.graph.deg_A).reshape(-1)
            roots = [int(r) for r in np.argsort(-deg, kind="stable")[:20]]
            roots += [int(r) for r in np.flatnonzero(deg > 0)[[0, 77]]]
        want = [ref.run(r) for r in roots]
        for local_mode in ("dense", "kernel"):
            eng = plan_case("2d", ov, instrument=instrument,
                            local_mode=local_mode, device="cpu").compile()
            for r, w in zip(roots, want):
                same_result(w, eng.run(r), local_mode,
                            (ov, instrument, local_mode, r))
        print(f"2d {ov} instrument={instrument}: dense and kernel == "
              f"reference on {len(roots)} roots", flush=True)
    if ov.get("fold_mode") == "bitmap":
        assert any(fold_over), "the bitmap fold's fallback never fired"
    if ov.get("compact_updates"):
        assert any(upd_over), "the compact updates' fallback never fired"
    print(f"OK torch-dist-schedule {variant} ({sum(fold_over)} fold and "
          f"{sum(upd_over)} update overflows)")


if __name__ == "__main__":
    main(sys.argv[1])
