"""Which mesh axes a recorded schedule's predicates are uniform over.

The JAX package runs a lattice over the jaxpr: each value carries the
mesh axes it is provably uniform over, and each collective the stack of
predicates it runs under.  The port's search loop runs on the host and
its predicates are host values, so the same facts are read off the
recorded schedule (``core/collectives.py``) instead of a program:

  * the loop's fused reduction sums over the graph axes, so every value
    the host reads from it (the frontier size, the masses, the "1ds"
    overflow indicator) is uniform over the graph axes;
  * a pod's direction decision is computed from its own reduction: it
    is uniform over the pod axis only if the level recorded the pods'
    decision sync (``decide_and_sync``'s pmax and pmin, tag
    "decision");
  * the loop predicate of a level is uniform over the pod axis only if
    the level before it recorded the lockstep pmax (tag "lockstep");
  * a decision that never changes (``direction_optimizing`` off) is
    uniform over every axis.

Each recorded collective of a level runs under that level's loop
predicate and, in its td or bu body, under its decision.  Its
rendezvous follows the JAX package's lowering: a collective-permute is
one whole-program rendezvous whatever its pairs, every other collective
stays within its own axes.  Repeated executions of one call site under
the same predicates fold into one ``CollectiveSite``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.collectives import Record

SEARCH_MODES = ("td", "bu", "loop")


def rendezvous(op: str, axes: Sequence[str],
               mesh_axes: Sequence[str]) -> Tuple[str, ...]:
    """Axes whose devices a collective rendezvouses with: the whole mesh
    for a permute, its own axes for every other kind."""
    return tuple(mesh_axes) if op == "ppermute" else tuple(axes)


@dataclass(frozen=True)
class Pred:
    """One predicate a collective runs under."""
    kind: str          # "cond" (the direction decision) | "while" (the loop)
    unif: frozenset    # axes the predicate is uniform over
    desc: str          # where its uniformity comes from


@dataclass(frozen=True)
class CollectiveSite:
    """One call site of a collective under one stack of predicates."""
    kind: str                   # JAX primitive, e.g. "ppermute"
    hlo: str                    # its HLO kind, e.g. "collective-permute"
    axes: Tuple[str, ...]
    tag: str
    preds: Tuple[Pred, ...]     # outermost first
    path: str                   # "<mode> <file:line function>"
    levels: Tuple[int, ...] = ()

    def rendezvous(self, mesh_axes: Sequence[str]) -> Tuple[str, ...]:
        return rendezvous(self.kind, self.axes, mesh_axes)


@dataclass(frozen=True)
class CondRecord:
    """The direction decision: its predicate and the (kind, axes)
    sequence of each body (bottom-up, top-down) as recorded."""
    pred: Pred
    path: str
    branch_seqs: Tuple[Tuple[Tuple[str, Tuple[str, ...]], ...], ...]


@dataclass
class Analysis:
    mesh_axes: Tuple[str, ...]
    sites: List[CollectiveSite] = field(default_factory=list)
    conds: List[CondRecord] = field(default_factory=list)
    decisions: Dict[int, Pred] = field(default_factory=dict)


def _fmt(axes) -> str:
    return "(" + ", ".join(repr(a) for a in axes) + ")"


def analyze_schedule(records: Sequence[Record], mesh_axes: Sequence[str],
                     graph_axes: Sequence[str], *,
                     sync_axis: Optional[str] = None,
                     fixed_modes: bool = False) -> Analysis:
    """The uniformity of each level's predicates and every collective
    site of a recorded search (``mode`` td, bu or loop; the validator's
    records are not part of the search and are skipped)."""
    mesh_axes, graph_axes = tuple(mesh_axes), tuple(graph_axes)
    an = Analysis(mesh_axes=mesh_axes)
    recs = [r for r in records if r.mode in SEARCH_MODES]
    base = frozenset(graph_axes)
    red_desc = f"psum over {_fmt(graph_axes)} (the loop's fused reduction)"
    lockstep = {r.level for r in recs if r.tag == "lockstep"}
    synced = {r.level for r in recs if r.tag == "decision"}
    pod = frozenset((sync_axis,)) if sync_axis else frozenset()

    def loop_pred(level: int) -> Pred:
        if level - 1 in lockstep:
            return Pred("while", base | pod,
                        f"pmax over {_fmt((sync_axis,))} (lockstep)")
        return Pred("while", base, red_desc)

    def decision(level: int) -> Pred:
        if level not in an.decisions:
            if fixed_modes:
                p = Pred("cond", frozenset(mesh_axes),
                         "constant (direction_optimizing off)")
            elif level in synced:
                p = Pred("cond", base | pod,
                         f"pmax/pmin over {_fmt((sync_axis,))} "
                         f"(decide_and_sync)")
            else:
                p = Pred("cond", base, red_desc)
            an.decisions[level] = p
        return an.decisions[level]

    sites: Dict[Tuple, List[int]] = {}
    seqs: Dict[str, Dict[Tuple, List]] = {"td": {}, "bu": {}}
    for r in recs:
        if r.level < 0:
            preds: Tuple[Pred, ...] = ()
        elif r.mode == "loop":
            preds = (loop_pred(r.level),)
        else:
            preds = (loop_pred(r.level), decision(r.level))
            seqs[r.mode].setdefault((r.level, r.pod), []).append(
                (r.op, r.axes))
        key = (r.op, r.kind, r.axes, r.tag, preds, f"{r.mode} {r.site}")
        sites.setdefault(key, []).append(r.level)
    for (op, hlo, axes, tag, preds, path), levels in sites.items():
        an.sites.append(CollectiveSite(op, hlo, axes, tag, preds, path,
                                       tuple(sorted(set(levels)))))
    if seqs["td"] and seqs["bu"]:
        # one record for the loop's decision: the meet of every level's
        # uniformity, and each distinct sequence a body recorded (a body
        # whose levels differ, like the "1ds" top-down's sparse and dense
        # exchanges, gives each)
        unif = frozenset(mesh_axes)
        descs = []
        for lv in sorted(an.decisions):
            unif &= an.decisions[lv].unif
            if an.decisions[lv].desc not in descs:
                descs.append(an.decisions[lv].desc)
        bodies = tuple(s for m in ("bu", "td")
                       for s in dict.fromkeys(tuple(v) for v in
                                              seqs[m].values()))
        an.conds.append(CondRecord(Pred("cond", unif, "; ".join(descs)),
                                   "the level loop's direction decision",
                                   bodies))
    return an
