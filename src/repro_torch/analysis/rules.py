"""Lint rules over a recorded schedule's analysis (R1-R3) and its
per-level counts (R4).  Each rule returns ``Finding``s with the JAX
package's JSON fields (``rule``, ``combo``, ``message``, ``detail``),
specific enough to act on: the collective, the predicate and where its
uniformity came from, the axes that can diverge.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.uniformity import Analysis, rendezvous
from repro_torch.core.collectives import REDUCTIONS


@dataclass(frozen=True)
class Finding:
    rule: str                 # "R1" | "R2" | "R3" | "R4"
    combo: str                # which registry combo or run tripped it
    message: str              # one line: the defect
    detail: Dict = field(default_factory=dict)

    def to_json(self) -> Dict:
        return asdict(self)


def _fmt_axes(axes) -> str:
    return "(" + ", ".join(repr(a) for a in sorted(axes)) + ")"


def check_divergent_collectives(an: Analysis, combo: str) -> List[Finding]:
    """R1: a collective must run under predicates uniform over every
    axis it rendezvouses on; otherwise some devices enter the rendezvous
    while others took the other branch (or left the loop), and wait
    forever."""
    findings = []
    for site in an.sites:
        rv = set(site.rendezvous(an.mesh_axes))
        for pred in site.preds:
            missing = rv - pred.unif
            if not missing:
                continue
            findings.append(Finding(
                rule="R1", combo=combo,
                message=(
                    f"{site.kind} over {site.axes!r} rendezvouses on "
                    f"{_fmt_axes(rv)} but is guarded by a {pred.kind} "
                    f"predicate only uniform over {_fmt_axes(pred.unif)} "
                    f"— devices may diverge over {_fmt_axes(missing)} "
                    f"and deadlock"),
                detail={
                    "collective": site.kind,
                    "hlo_kind": site.hlo,
                    "op_axes": list(site.axes),
                    "rendezvous_axes": sorted(rv),
                    "predicate": pred.desc,
                    "predicate_kind": pred.kind,
                    "predicate_uniform_over": sorted(pred.unif),
                    "divergent_axes": sorted(missing),
                    "path": site.path,
                    "levels": list(site.levels),
                }))
    return findings


def _seq_rendezvous(seq, mesh_axes) -> set:
    axes = set()
    for op, op_axes in seq:
        axes |= set(rendezvous(op, op_axes, mesh_axes))
    return axes


def check_branch_schedules(an: Analysis, combo: str) -> List[Finding]:
    """R2: the td and bu bodies may issue different (kind, axes)
    sequences only while the decision is uniform over every axis those
    collectives rendezvous on (all devices take the same body)."""
    findings = []
    for rec in an.conds:
        if len(set(rec.branch_seqs)) <= 1:
            continue
        divergent = set(an.mesh_axes) - rec.pred.unif
        if not divergent:
            continue
        rv = set()
        for seq in rec.branch_seqs:
            rv |= _seq_rendezvous(seq, an.mesh_axes)
        hazard = rv & divergent
        if not hazard:
            continue
        findings.append(Finding(
            rule="R2", combo=combo,
            message=(
                f"the td and bu bodies issue different collective "
                f"sequences under a decision ({rec.pred.desc}) divergent "
                f"over {_fmt_axes(hazard)}"),
            detail={
                "branch_sequences": [[[k, list(a)] for k, a in seq]
                                     for seq in rec.branch_seqs],
                "predicate": rec.pred.desc,
                "predicate_uniform_over": sorted(rec.pred.unif),
                "divergent_axes": sorted(hazard),
                "path": rec.path,
            }))
    return findings


def check_axis_layout(an: Analysis, combo: str, *, entry_name: str,
                      graph_axes: Sequence[str],
                      sync_axes: Sequence[str] = (),
                      declared_rendezvous: Optional[Sequence[str]] = None
                      ) -> List[Finding]:
    """R3, three layout checks: a collective over an axis outside the
    entry's graph axes (plus the sync axis for the loop's scalar
    reductions); a data collective over the pod axis (pods replicate the
    graph and never exchange it); and an entry's ``rendezvous_axes``
    that do not cover what its schedule issued (the declaration is
    checked, not trusted)."""
    findings = []
    graph_axes, sync_axes = set(graph_axes), set(sync_axes)
    actual = set()
    for site in an.sites:
        rv = set(site.rendezvous(an.mesh_axes))
        reduction = site.kind in REDUCTIONS
        if reduction:
            # the loop's lockstep and decision syncs over the pod axis
            # are issued for every entry, not part of its schedule
            rv -= sync_axes
        actual |= rv
        allowed = graph_axes | (sync_axes if reduction else set())
        stray = set(site.axes) - allowed
        if not stray:
            continue
        leak = stray & sync_axes
        where = ("the pod axis " + _fmt_axes(leak) if leak
                 else "undeclared axes " + _fmt_axes(stray))
        findings.append(Finding(
            rule="R3", combo=combo,
            message=(f"{site.kind} over {site.axes!r} reaches {where} "
                     f"outside decomposition {entry_name!r}'s layout "
                     f"{_fmt_axes(graph_axes)}"),
            detail={
                "collective": site.kind,
                "op_axes": list(site.axes),
                "allowed_axes": sorted(allowed),
                "stray_axes": sorted(stray),
                "pod_leak": bool(leak),
                "path": site.path,
            }))
    if declared_rendezvous is not None:
        under = actual - set(declared_rendezvous)
        if under:
            findings.append(Finding(
                rule="R3", combo=combo,
                message=(
                    f"decomposition {entry_name!r} declares "
                    f"rendezvous_axes={_fmt_axes(declared_rendezvous)} but "
                    f"its schedule rendezvouses on {_fmt_axes(actual)} — "
                    f"the declaration under-claims {_fmt_axes(under)}"),
                detail={
                    "declared": sorted(declared_rendezvous),
                    "actual": sorted(actual),
                    "under_declared": sorted(under),
                }))
    return findings


def check_budget(counts: Dict[str, int], budget: int, *, combo: str,
                 mode: str, level: Optional[int] = None) -> List[Finding]:
    """R4: one level's recorded collectives against its budget."""
    total = counts.get("total", 0)
    if total <= budget:
        return []
    at = "level body" if level is None else f"level {level}"
    return [Finding(
        rule="R4", combo=combo,
        message=(f"{mode} {at} records {total} collectives, over the "
                 f"comm_model budget of {budget}"),
        detail={"mode": mode, "level": level, "counts": dict(counts),
                "budget": budget})]
