"""The port's recorded collective schedule against the JAX package's
lowered one (``tests/_perf_guard_main.py``, run in a subprocess as
``test_perf_guard.py`` runs it: ``repro.analysis.registry.
collect_counts()`` at pc 4 and p 8, lowering only).

The reference counts program text: both branches of a ``lax.cond``
count and a loop body counts once.  The port counts what executes, level
by level (``repro_torch.analysis.registry.collect_counts(device="cpu")``
on the same scale-9 family).  So each case holds:

  * its level bodies' executed counts, kind by kind, as written in
    ``EXPECTED`` below, next to the reference's lowered count;
  * every executed count at most the reference's;
  * every level of a whole search recording its body's counts, one
    fused reduction in the loop, and the search the startup reduction
    plus the sum of its levels;
  * the reference's pinned assertions, carried over.

A body without a ``cond`` records the reference's count exactly.  The
"1ds" top-down body records the branch it took (C of the 2C gathers in
the text).  The exact bitmap fold and compact updates run both branches
on the device and select, so they record both, as the text does.  The
parents of those variants and of the R/G ring are held against the
reference's dense sessions in a subprocess a variant
(``_torch_dist_schedule_main.py``, run by ``test_torch_schedule_{bitmap,
compact,chunks,all}.py``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.configs.base import BFSConfig
from repro_torch.core import collectives, comm_model
from repro_torch.core.engine import plan_bfs
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)

AR, AG, A2A, CP = ("all-reduce", "all-gather", "all-to-all",
                   "collective-permute")


def k(ag=0, ar=0, a2a=0, cp=0):
    """Per-kind counts with their total, as ``count_kinds`` gives them."""
    out = {kind: n for kind, n in ((AG, ag), (AR, ar), (A2A, a2a), (CP, cp))
           if n}
    out["total"] = ag + ar + a2a + cp
    return out


# Executed counts of one level body at pc 4 / p 8: (fast td, fast bu,
# instrumented td, instrumented bu).  The comment after each case gives
# the reference's lowered totals in the same order.
EXPECTED = {
    # 1d: no cond; the bitmap gather (C at expand_chunks C); the
    # instrumented bodies add the n_f, edges-examined and m_f psums (td)
    # and the edges-used and updates psums (bu)
    "1d[c=1]": (k(ag=1), k(ag=1), k(ag=1, ar=3), k(ag=1, ar=2)),
    # ref 1 / 1 / 4 / 3
    "1d[c=2]": (k(ag=2), k(ag=1), k(ag=2, ar=3), k(ag=1, ar=2)),
    # ref 2 / 1 / 5 / 3
    # 1ds top-down: the sparse or the dense branch of the cond, one
    # gather a sub-chunk either way (the sparse one from the root); the
    # instrumented body adds the overflow pmax and the wire psum
    "1ds[codec=packed,c=1]": (k(ag=1), k(ag=1), k(ag=1, ar=5),
                              k(ag=1, ar=2)),
    # ref 2 / 1 / 7 / 3
    "1ds[codec=packed,c=2]": (k(ag=2), k(ag=1), k(ag=2, ar=5),
                              k(ag=1, ar=2)),
    # ref 4 / 1 / 9 / 3
    "1ds[codec=none,c=1]": (k(ag=1), k(ag=1), k(ag=1, ar=5),
                            k(ag=1, ar=2)),
    # ref 2 / 1 / 7 / 3
    "1ds[codec=none,c=2]": (k(ag=2), k(ag=1), k(ag=2, ar=5),
                            k(ag=1, ar=2)),
    # ref 4 / 1 / 9 / 3
    # 2d: transpose permute + gather; the fold (alltoall 1 a2a, reduce
    # pc-1 permutes, bitmap 4 a2a + the overflow pmax + the fallback
    # a2a); bottom-up pc-1 rotation permutes (2(pc-1) on the R/G ring)
    # and the update a2a (compact: + pmax + the fallback a2a).  The
    # instrumented td adds 4 psums, the bu 2 a sub-step.
    "2d[fold=alltoall,compact=0,c=1]": (
        k(cp=1, ag=1, a2a=1), k(cp=4, ag=1, a2a=1),
        k(cp=1, ag=1, a2a=1, ar=4), k(cp=4, ag=1, a2a=1, ar=8)),
    # ref 3 / 6 / 7 / 14
    "2d[fold=alltoall,compact=0,c=2]": (
        k(cp=1, ag=1, a2a=1), k(cp=7, ag=1, a2a=1),
        k(cp=1, ag=1, a2a=1, ar=4), k(cp=7, ag=1, a2a=1, ar=8)),
    # ref 3 / 9 / 7 / 17
    "2d[fold=alltoall,compact=1,c=1]": (
        k(cp=1, ag=1, a2a=1), k(cp=4, ag=1, a2a=2, ar=1),
        k(cp=1, ag=1, a2a=1, ar=4), k(cp=4, ag=1, a2a=2, ar=9)),
    # ref 3 / 8 / 7 / 16: compact and fallback branches both run
    "2d[fold=alltoall,compact=1,c=2]": (
        k(cp=1, ag=1, a2a=1), k(cp=7, ag=1, a2a=2, ar=1),
        k(cp=1, ag=1, a2a=1, ar=4), k(cp=7, ag=1, a2a=2, ar=9)),
    # ref 3 / 11 / 7 / 19
    "2d[fold=reduce,compact=0,c=1]": (
        k(cp=4, ag=1), k(cp=4, ag=1, a2a=1),
        k(cp=4, ag=1, ar=4), k(cp=4, ag=1, a2a=1, ar=8)),
    # ref 5 / 6 / 9 / 14
    "2d[fold=reduce,compact=0,c=2]": (
        k(cp=4, ag=1), k(cp=7, ag=1, a2a=1),
        k(cp=4, ag=1, ar=4), k(cp=7, ag=1, a2a=1, ar=8)),
    # ref 5 / 9 / 9 / 17
    "2d[fold=reduce,compact=1,c=1]": (
        k(cp=4, ag=1), k(cp=4, ag=1, a2a=2, ar=1),
        k(cp=4, ag=1, ar=4), k(cp=4, ag=1, a2a=2, ar=9)),
    # ref 5 / 8 / 9 / 16
    "2d[fold=reduce,compact=1,c=2]": (
        k(cp=4, ag=1), k(cp=7, ag=1, a2a=2, ar=1),
        k(cp=4, ag=1, ar=4), k(cp=7, ag=1, a2a=2, ar=9)),
    # ref 5 / 11 / 9 / 19
    "2d[fold=bitmap,compact=0,c=1]": (
        k(cp=1, ag=1, a2a=5, ar=1), k(cp=4, ag=1, a2a=1),
        k(cp=1, ag=1, a2a=5, ar=5), k(cp=4, ag=1, a2a=1, ar=8)),
    # ref 8 / 6 / 12 / 14: bitmap and fallback branches both run
    "2d[fold=bitmap,compact=0,c=2]": (
        k(cp=1, ag=1, a2a=5, ar=1), k(cp=7, ag=1, a2a=1),
        k(cp=1, ag=1, a2a=5, ar=5), k(cp=7, ag=1, a2a=1, ar=8)),
    # ref 8 / 9 / 12 / 17
    "2d[fold=bitmap,compact=1,c=1]": (
        k(cp=1, ag=1, a2a=5, ar=1), k(cp=4, ag=1, a2a=2, ar=1),
        k(cp=1, ag=1, a2a=5, ar=5), k(cp=4, ag=1, a2a=2, ar=9)),
    # ref 8 / 8 / 12 / 16
    "2d[fold=bitmap,compact=1,c=2]": (
        k(cp=1, ag=1, a2a=5, ar=1), k(cp=7, ag=1, a2a=2, ar=1),
        k(cp=1, ag=1, a2a=5, ar=5), k(cp=7, ag=1, a2a=2, ar=9)),
    # ref 8 / 11 / 12 / 19
}
SLOTS = (("fast", "td"), ("fast", "bu"), ("instrumented", "td"),
         ("instrumented", "bu"))


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_perf_guard_main.py")],
                       capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, f"reference lowering failed:\n{r.stderr}"
    return json.loads(r.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return registry.collect_counts(device="cpu")


def test_same_case_names(ref, port):
    want = set(ref) - {"pc", "p", "validators"}
    got = set(port) - {"pc", "p", "validators"}
    assert got == want == {c.name for c in registry.budget_cases()}
    assert set(EXPECTED) == want and len(want) == 18
    assert (port["pc"], port["p"]) == (ref["pc"], ref["p"]) == (4, 8)


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_level_bodies_record_the_expected_executed_counts(ref, port, case):
    for (label, mode), want in zip(SLOTS, EXPECTED[case]):
        got = port[case][label][mode]
        assert got == want, (case, label, mode, got)
        lowered = ref[case][label][mode]
        for kind, n in got.items():
            assert n <= lowered.get(kind, 0), (case, label, mode, kind)


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_search_levels_record_their_bodies(port, case):
    """Each level of a whole search records its body's counts (the
    level bodies run alone above) and one fused reduction in the loop;
    the search is the startup reduction plus its levels; both modes
    run."""
    for label in ("fast", "instrumented"):
        s = port[case][label]["search"]
        assert s["startup"] == k(ar=1)
        total = s["startup"]["total"]
        for lv in s["levels"]:
            assert lv["body"] == port[case][label][lv["mode"]], (case, lv)
            assert lv["loop"] == k(ar=1), (case, lv)
            total += lv["body"]["total"] + lv["loop"]["total"]
        assert s["total"] == total
        assert {lv["mode"] for lv in s["levels"]} == {"td", "bu"}
        tags = {t for lv in s["levels"] for t in lv["tags"]}
        assert ("counter" in tags) == (label == "instrumented")
        # the branch tags: the 1ds top-down's sparse exchange, and the
        # fallbacks of the exact bitmap fold and compact updates
        assert ("sparse" in tags) == case.startswith("1ds")
        assert ("fallback" in tags) == ("bitmap" in case
                                        or "compact=1" in case)


@pytest.mark.parametrize("chunks", (1, 2))
def test_1ds_dense_branch_records_one_gather_a_subchunk(chunks):
    """Top-down only, the wide levels overflow the buckets and take the
    dense branch: C gathers, as the sparse branch records (the text
    holds both, 2C)."""
    graph, mesh = registry._inputs("1d", False, "cpu")
    cfg = BFSConfig(decomposition="1ds", instrument=False,
                    direction_optimizing=False, expand_chunks=chunks)
    s = plan_bfs(graph, cfg, mesh).compile().collective_counts()
    branches = [lv["tags"] for lv in s["levels"]]
    assert ["dense"] in branches and ["sparse"] in branches, branches
    for lv in s["levels"]:
        assert lv["body"] == k(ag=chunks), lv


def test_pinned_assertions_carried_over(port):
    pc = port["pc"]
    a2a = "2d[fold=alltoall,compact=0,c=1]"
    assert port[a2a]["fast"]["td"]["total"] <= 4
    assert port[a2a]["fast"]["bu"]["total"] <= pc + 3
    # one fused reduction a level in the fast search, plus the overflow
    # pmax of the bitmap fold (top-down) and compact updates (bottom-up)
    for case in EXPECTED:
        for lv in port[case]["fast"]["search"]["levels"]:
            extra = int(lv["mode"] == "td" and "bitmap" in case) + \
                int(lv["mode"] == "bu" and "compact=1" in case)
            assert lv["loop"].get(AR, 0) == 1, (case, lv)
            assert lv["body"].get(AR, 0) == extra, (case, lv)
    # fast <= half of instrumented on the 2D top-down level, and
    # strictly fewer with the ring fold
    assert 2 * port[a2a]["fast"]["td"]["total"] <= \
        port[a2a]["instrumented"]["td"]["total"]
    for case in (a2a, "2d[fold=reduce,compact=0,c=1]"):
        assert port[case]["fast"]["td"]["total"] < \
            port[case]["instrumented"]["td"]["total"]
    # the instrumented bodies keep their counter reductions
    for case in (a2a, "1d[c=1]", "1ds[codec=packed,c=1]",
                 "1ds[codec=none,c=1]"):
        inst, fast = port[case]["instrumented"]["td"], \
            port[case]["fast"]["td"]
        assert inst.get(AR, 0) >= 3 and inst["total"] > fast["total"]
    # the codec changes bytes, not the schedule
    for c in (1, 2):
        assert port[f"1ds[codec=packed,c={c}]"] == \
            port[f"1ds[codec=none,c={c}]"]


def test_validators_within_budget(ref, port):
    assert set(port["validators"]) == set(ref["validators"]) == \
        {"1d", "1ds", "2d"}
    for name, got in port["validators"].items():
        budget = comm_model.validate_collective_budget(name)
        assert got == ref["validators"][name], name
        for kind in (AG, AR, "total"):
            assert 1 <= got.get(kind, 0) <= budget[kind], (name, got)


def test_recorder_costs_one_global_when_off_and_nests():
    """Unrecorded, a collective leaves no trace; an inner recorder takes
    the records and the outer one resumes after it."""
    assert collectives._ACTIVE is None
    t = torch.arange(8).reshape(2, 4)
    collectives.psum(t)
    with collectives.ScheduleRecorder() as outer:
        collectives.all_gather_tiled(t, collectives.GRID_2D)
        with collectives.ScheduleRecorder() as inner:
            assert collectives.ppermute_col_ring(t[None]).shape == (1, 2, 4)
        collectives.psum(t, collectives.STRIPS, "counter")
    assert collectives._ACTIVE is None
    assert [r.kind for r in inner.records] == [CP]
    assert [(r.op, r.axes) for r in outer.records] == [
        ("all_gather", ("model",)), ("all_gather", ("data",)),
        ("psum", ("data",))]
    assert outer.records[-1].tag == "counter"
    assert outer.records[0].site.startswith("test_torch_schedule.py:")


def test_one_word_subchunks_run_on_the_strip_dcsc_kernel_entry():
    """expand_chunks 2 on 8 strips at scale 9 hands the strip DCSC
    kernel entry one-word sub-chunks; their gather must come out
    contiguous (the entry refused a strided view before the gathers went
    through ``collectives.all_gather_tiled``).  Parents equal the
    unpipelined dense session's."""
    graph, mesh = registry._inputs("1d", False, "cpu")
    want = plan_bfs(graph, BFSConfig(decomposition="1d"), mesh).compile()
    for decomp in ("1d", "1ds"):
        cfg = BFSConfig(decomposition=decomp, storage="dcsc",
                        expand_chunks=2)
        eng = plan_bfs(graph, cfg, mesh, local_mode="kernel").compile()
        for r in registry._roots(eng, 3):
            assert np.array_equal(eng.run(r).parents, want.run(r).parents)
