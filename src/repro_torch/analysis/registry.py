"""Registry-wide sweeps of the collective-schedule checks.

Two enumerations, both driven by the Decomposition registry, so an entry
is covered the day it registers:

  * ``lint_combos()``: every decomposition x (local_mode, storage)
    LocalOps combo x instrument on and off x expand_chunks {1, 2} x the
    codec (for "1ds"), plus the full ``schedule_dims`` cross product at
    dense/csr.  ``lint_registry()`` runs each combo's pod-batched search
    (2 pods, where divergence hazards live) and one single-mesh search an
    entry under a ``ScheduleRecorder`` and applies rules R1-R3.

  * ``budget_cases()``: the cross product of each entry's
    ``schedule_dims`` domains, each case with its
    ``comm_model.level_budgets_for`` budgets.  ``collect_counts()``
    records, for every case and both instrument modes, one top-down and
    one bottom-up level body run alone from the root's state and one
    whole search level by level; ``budget_findings`` (rule R4) holds the
    uninstrumented ones to the budgets.

The JAX package lowers programs against shapes and counts their text,
where a ``lax.cond`` counts both branches.  The port runs the searches
on the scale-9 family below and counts what executes: a body records the
branch it took, or both where it runs both on the device and selects.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import collectives, comm_model

# value domains of the BFSConfig fields entries list in schedule_dims
# (the first value is the sweep's default for that dim)
SCHEDULE_DOMAINS: Dict[str, Tuple] = {
    "fold_mode": ("alltoall", "reduce", "bitmap"),
    "compact_updates": (False, True),
    "frontier_codec": ("packed", "none"),
    "expand_chunks": (1, 2),
}

# the graph and meshes every sweep runs on: the scale-9 R-MAT on p=8
# strips or a 2x4 grid (2 pods for the batched lint searches)
SCALE, EDGE_FACTOR, SEED = 9, 8, 3
GRID_PR, GRID_PC, STRIP_P, PODS = 2, 4, 8, 2


def _short(dim: str, val) -> str:
    if dim == "fold_mode":
        return f"fold={val}"
    if dim == "compact_updates":
        return f"compact={int(val)}"
    if dim == "frontier_codec":
        return f"codec={val}"
    if dim == "expand_chunks":
        return f"c={val}"
    return f"{dim}={val}"


def case_name(decomposition: str, overrides: Dict[str, Any]) -> str:
    """Canonical name of one schedule case, e.g.
    ``2d[fold=alltoall,compact=0,c=1]``: the entry's dims in their
    declared order, each spelled even at its default."""
    from repro_torch.core.decomp import get_decomposition
    entry = get_decomposition(decomposition)
    toks = [_short(dim, overrides.get(dim, SCHEDULE_DOMAINS[dim][0]))
            for dim in entry.schedule_dims]
    return f"{decomposition}[{','.join(toks)}]" if toks else decomposition


@dataclass(frozen=True)
class BudgetCase:
    """One schedule point of one entry, with its comm-model budgets."""
    name: str
    decomposition: str
    overrides: Dict[str, Any] = field(hash=False)

    def budgets(self, pc: int, p: int) -> Dict[str, int]:
        return comm_model.level_budgets_for(
            self.decomposition, pc=pc, p=p, **self.overrides)


def budget_cases() -> Tuple[BudgetCase, ...]:
    """The cross product of every registered entry's schedule_dims: the
    R4 enumeration."""
    from repro_torch.core.decomp import (get_decomposition,
                                         registered_decompositions)
    cases = []
    for name in registered_decompositions():
        dims = get_decomposition(name).schedule_dims
        for vals in itertools.product(*(SCHEDULE_DOMAINS[d] for d in dims)):
            ov = dict(zip(dims, vals))
            cases.append(BudgetCase(case_name(name, ov), name, ov))
    return tuple(cases)


# ---------------------------------------------------------------------------
# Plans on the shared inputs
# ---------------------------------------------------------------------------

_CACHE: Dict = {}


def _inputs(family: str, batched: bool, device):
    """The scale-9 graph and mesh of one decomposition family on
    ``device``, cached."""
    from repro_torch.launch.mesh import (make_local_mesh, make_local_mesh_1d,
                                         resolve_device)
    dev = resolve_device(device)
    gkey = ("graphs", str(dev))
    if gkey not in _CACHE:
        from repro_torch.graph.formats import build_blocked, build_blocked_1d
        from repro_torch.graph.rmat import rmat_graph
        e = rmat_graph(SCALE, edge_factor=EDGE_FACTOR, seed=SEED,
                       device=dev)
        _CACHE[gkey] = {
            "2d": build_blocked(e, GRID_PR, GRID_PC, align=32, cap_pad=32),
            # with_col_ptr: the kernel csr combos ship the strip col_ptr
            "1d": build_blocked_1d(e, STRIP_P, align=32, cap_pad=32,
                                   with_col_ptr=True),
        }
    pods = PODS if batched else None
    mesh = (make_local_mesh(GRID_PR, GRID_PC, device=dev, pods=pods)
            if family == "2d" else
            make_local_mesh_1d(STRIP_P, device=dev, pods=pods))
    return _CACHE[gkey][family], mesh


def _family(decomposition: str) -> str:
    from repro_torch.core.decomp import get_decomposition
    from repro_torch.core.partition import Partition2D
    entry = get_decomposition(decomposition)
    return "2d" if entry.partition_cls is Partition2D else "1d"


def plan_case(decomposition: str, overrides: Dict[str, Any], *,
              instrument: bool, local_mode: str = "dense",
              storage: str = "csr", batched: bool = False,
              device="cuda"):
    """A plan of one enumerated case on the shared inputs."""
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.engine import plan_bfs
    graph, mesh = _inputs(_family(decomposition), batched, device)
    cfg = BFSConfig(decomposition=decomposition, instrument=instrument,
                    storage=storage, **overrides)
    return plan_bfs(graph, cfg, mesh, local_mode=local_mode)


def _roots(engine, k: int) -> List[int]:
    """The ``k`` highest-degree vertices: searches that run top-down and
    then bottom-up, as the engine's warm-up does."""
    deg = engine._gdev["deg_A"].reshape(-1)
    return [int(r) for r in torch.topk(deg, k).indices.tolist()]


def record_search(engine, pod_axis: Optional[str] = None
                  ) -> collectives.ScheduleRecorder:
    """One search (a batch over ``pod_axis``) from the highest-degree
    vertices, under a recorder."""
    pods = engine.plan.mesh.shape[pod_axis] if pod_axis else 1
    roots = _roots(engine, pods)
    with collectives.ScheduleRecorder() as rec:
        if pod_axis:
            engine.search_batch(roots, pod_axis)
        else:
            engine.search(roots[0])
    return rec


def level_counts(engine, which: str) -> Dict[str, int]:
    """The collectives of ONE level body (``which`` "td" or "bu") run
    alone on the root's state, as the search loop calls it; the steps
    and the state come from the entry's ``level_steps`` and ``state``.
    The JAX package lowers the same body without running it."""
    plan = engine.plan
    if plan.entry.level_steps is None or plan.entry.state is None:
        raise ValueError(f"decomposition {plan.entry.name!r} declares no "
                         f"level_steps and state; the budget sweep needs "
                         f"them")
    g = engine._gdev
    args = plan._level_args(g)
    root = _roots(engine, 1)[0]
    start, read = plan.entry.state(g, plan.part, args, plan.cfg)
    pi, front = start(root)
    n_f, m_f, _, over = read(pi, front, [])
    td, bu = plan.entry.level_steps
    with collectives.ScheduleRecorder() as rec:
        collectives.at(0, which)
        (td if which == "td" else bu)(g, pi, front, args,
                                      {"n_f": n_f, "m_f": m_f, "over": over})
    return rec.counts()


def validator_counts(decomposition: str, device="cuda") -> Dict[str, int]:
    """The collectives of the Graph500 parent-tree validator of one
    registered decomposition, on one searched tree; the validator is the
    same program for every schedule case."""
    from repro_torch.core.validate import validate_device
    eng = plan_case(decomposition, {}, instrument=False,
                    device=device).compile()
    root = _roots(eng, 1)[0]
    pi = eng.search(root)[0]
    with collectives.ScheduleRecorder() as rec:
        validate_device(eng, root, pi)
    return rec.counts()


def collect_counts(device="cuda", local_mode: str = "dense"
                   ) -> Dict[str, Any]:
    """The recorded counts of every ``budget_cases()`` case, instrument
    on and off: the level bodies alone (``td``, ``bu``) and the whole
    search (``search``, with its ``startup`` and ``levels``), keyed by
    canonical case name; the validators under ``"validators"``."""
    from repro_torch.core.decomp import registered_decompositions
    out: Dict[str, Any] = {"pc": GRID_PC, "p": STRIP_P}
    for case in budget_cases():
        row = {}
        for label, instr in (("fast", False), ("instrumented", True)):
            eng = plan_case(case.decomposition, case.overrides,
                            instrument=instr, local_mode=local_mode,
                            device=device).compile()
            row[label] = {"search": record_search(eng).summary(),
                          "td": level_counts(eng, "td"),
                          "bu": level_counts(eng, "bu")}
        out[case.name] = row
    out["validators"] = {name: validator_counts(name, device)
                         for name in registered_decompositions()}
    return out


def budget_findings(counts: Optional[Dict[str, Any]] = None,
                    device="cuda") -> List:
    """R4 over the whole enumeration: every case's uninstrumented level
    bodies, alone and at each level of the search, against its budgets."""
    from repro_torch.analysis.rules import check_budget
    counts = counts if counts is not None else collect_counts(device)
    pc, p = counts["pc"], counts["p"]
    findings = []
    for case in budget_cases():
        budgets = case.budgets(pc, p)
        fast = counts[case.name]["fast"]
        for mode in ("td", "bu"):
            findings.extend(check_budget(fast[mode], budgets[mode],
                                         combo=case.name, mode=mode))
        for lv in fast["search"]["levels"]:
            findings.extend(check_budget(
                lv["body"], budgets[lv["mode"]], combo=case.name,
                mode=lv["mode"], level=lv["level"]))
    return findings


def session_budget_findings(engine, rec: collectives.ScheduleRecorder,
                            combo: str) -> Tuple[List, List[Dict]]:
    """R4 over one recorded session's levels: each level's body, less
    the counter reductions an instrumented level adds, against the
    budget of the session's own schedule and grid.  Returns the findings
    and one row a level (level, mode, recorded, budget)."""
    from repro_torch.analysis.rules import check_budget
    plan = engine.plan
    cfg, part = plan.cfg, plan.part
    grid = part.pc if plan.entry.name == "2d" else part.p
    rows, findings = [], []
    by_level: Dict[Tuple[int, str], List] = {}
    for r in rec.records:
        if r.mode in ("td", "bu") and r.tag != "counter":
            by_level.setdefault((r.level, r.mode), []).append(r)
    for (level, mode), recs in sorted(by_level.items()):
        budget = comm_model.level_collective_budget(
            plan.entry.name, mode, grid, fold_mode=cfg.fold_mode,
            compact_updates=cfg.compact_updates, codec=cfg.frontier_codec,
            expand_chunks=cfg.expand_chunks)
        counts = collectives.count_kinds(recs)
        rows.append({"level": level, "mode": mode,
                     "recorded": counts["total"], "budget": budget})
        findings.extend(check_budget(counts, budget, combo=combo,
                                     mode=mode, level=level))
    return findings, rows


# ---------------------------------------------------------------------------
# Rules R1-R3 over plans and the registry
# ---------------------------------------------------------------------------


def lint_plan(plan, *, pod_axis: Optional[str] = None,
              combo: Optional[str] = None, engine=None) -> List:
    """Rules R1-R3 on one plan's recorded search: the pod-batched one
    when ``pod_axis`` names an axis of the plan's mesh (where divergence
    hazards live), else one single-root search.  Needs a graph attached;
    ``engine`` reuses a compiled session of the plan."""
    from repro_torch.analysis.rules import (check_axis_layout,
                                            check_branch_schedules,
                                            check_divergent_collectives)
    from repro_torch.analysis.uniformity import analyze_schedule

    if plan.graph is None:
        raise ValueError("lint needs a plan with a graph attached "
                         "(plan_bfs, not plan_for_part)")
    combo = combo or (f"{plan.entry.name}/{plan.ops.local_mode}/"
                      f"{plan.cfg.storage}")
    engine = engine if engine is not None else plan.compile()
    rec = record_search(engine, pod_axis=pod_axis)
    mesh_axes = tuple(plan.mesh.shape)
    entry = plan.entry
    an = analyze_schedule(rec.records, mesh_axes, entry.axes,
                          sync_axis=pod_axis,
                          fixed_modes=not plan.cfg.direction_optimizing)
    declared = (tuple(entry.rendezvous_axes(entry.axes, mesh_axes))
                if entry.rendezvous_axes is not None else mesh_axes)
    findings = check_divergent_collectives(an, combo)
    findings += check_branch_schedules(an, combo)
    findings += check_axis_layout(
        an, combo, entry_name=entry.name, graph_axes=entry.axes,
        sync_axes=(pod_axis,) if pod_axis else (),
        declared_rendezvous=declared)
    return findings


@dataclass(frozen=True)
class LintCombo:
    decomposition: str
    local_mode: str
    storage: str
    instrument: bool
    overrides: Dict[str, Any] = field(hash=False)

    @property
    def name(self) -> str:
        instr = "instr" if self.instrument else "fast"
        return (f"{case_name(self.decomposition, self.overrides)}/"
                f"{self.local_mode}/{self.storage}/{instr}")


def lint_combos(quick: bool = False,
                local_mode: Optional[str] = None) -> Tuple[LintCombo, ...]:
    """The registry-wide R1-R3 sweep: every (local_mode, storage) combo
    of every entry x instrument on/off x expand_chunks {1, 2} x codec
    (entries that declare it), at the entry's other schedule defaults;
    plus the whole schedule_dims cross product x instrument at the
    default local format (the fold modes and compact updates change the
    2D bodies).  ``quick`` keeps one representative an entry (both
    instrument modes, chunks 1); ``local_mode`` keeps that mode's
    combos, its csr storage standing in for the default format."""
    from repro_torch.core import local_ops
    from repro_torch.core.decomp import (get_decomposition,
                                         registered_decompositions)
    combos: List[LintCombo] = []
    seen = set()
    base = local_mode or "dense"

    def add(decomp, lm, st, instr, ov):
        key = (decomp, lm, st, instr, tuple(sorted(ov.items())))
        if key not in seen:
            seen.add(key)
            combos.append(LintCombo(decomp, lm, st, instr, dict(ov)))

    for decomp in registered_decompositions():
        entry = get_decomposition(decomp)
        if quick:
            for instr in (False, True):
                add(decomp, base, "csr", instr, {})
            continue
        lm_st = [(lm, st) for d, lm, st in local_ops.registered_combos()
                 if d == decomp and local_mode in (None, lm)] \
            or [(base, "csr")]
        codecs = (SCHEDULE_DOMAINS["frontier_codec"]
                  if "frontier_codec" in entry.schedule_dims else (None,))
        for (lm, st), instr, chunks, codec in itertools.product(
                lm_st, (False, True), SCHEDULE_DOMAINS["expand_chunks"],
                codecs):
            ov = {"expand_chunks": chunks}
            if codec is not None:
                ov["frontier_codec"] = codec
            add(decomp, lm, st, instr, ov)
        for vals in itertools.product(
                *(SCHEDULE_DOMAINS[d] for d in entry.schedule_dims)):
            ov = dict(zip(entry.schedule_dims, vals))
            for instr in (False, True):
                add(decomp, base, "csr", instr, ov)
    return tuple(combos)


def lint_registry(quick: bool = False, with_budgets: bool = True,
                  device="cuda", local_mode: Optional[str] = None
                  ) -> Dict[str, Any]:
    """The whole registry lint: R1-R3 on every combo's pod-batched
    search and on one single-mesh search an entry, R4 over the budget
    enumeration (at ``local_mode``, dense by default).  Returns the
    JSON-ready report."""
    from repro_torch.core.decomp import registered_decompositions
    report: Dict[str, Any] = {"combos": [], "findings": []}
    for combo in lint_combos(quick=quick, local_mode=local_mode):
        plan = plan_case(combo.decomposition, combo.overrides,
                         instrument=combo.instrument,
                         local_mode=combo.local_mode,
                         storage=combo.storage, batched=True, device=device)
        fs = lint_plan(plan, pod_axis="pod", combo=combo.name)
        report["combos"].append({"name": combo.name, "findings": len(fs)})
        report["findings"].extend(f.to_json() for f in fs)
    for decomp in registered_decompositions():
        plan = plan_case(decomp, {}, instrument=True,
                         local_mode=local_mode or "dense", device=device)
        fs = lint_plan(plan, combo=f"{decomp}/single")
        report["combos"].append({"name": f"{decomp}/single",
                                 "findings": len(fs)})
        report["findings"].extend(f.to_json() for f in fs)
    if with_budgets:
        counts = collect_counts(device, local_mode or "dense")
        fs = budget_findings(counts)
        report["budget_cases"] = [c.name for c in budget_cases()]
        report["findings"].extend(f.to_json() for f in fs)
    report["n_findings"] = len(report["findings"])
    report["clean"] = not report["findings"]
    return report
