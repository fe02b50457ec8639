"""Collectives of the simulated mesh as tensor ops, each one recorded.

Every per-processor array has shape ``(pr, pc, ...)`` on the 2D grid and
``(p, ...)`` on the strips: element ``[i, j]`` (or ``[i]``) is what
processor (i, j) (or strip i) holds.  Flat processor ids are k = i*pc +
j, the order the JAX package's ``ppermute`` pairs use over the (row,
col) axes.  Each function returns what every processor holds after the
collective, with the same leading dims.

Every exchange that the JAX package issues as a collective is one
function here, named by the HLO kind it lowers to there (``KINDS``) and
run over named mesh axes: ``ROW`` ("data", the expand axis, and the
strips' one axis), ``COL`` ("model", the fold and rotation axis) and
``POD`` (the batched roots).  While a ``ScheduleRecorder`` is active
each call appends a ``Record``: the kind, the JAX primitive, the axes,
and the level, mode and pod that the level loop set with ``at``.  A
collective whose simulated form is a view or a no-op records all the
same: ``all_gather_rows`` is a broadcast view, and ``noted`` stands for
a reduction the JAX package issues where the port already holds the
value (the level loop's host read).  With no recorder active a call
costs one test of a module global; a recorder reads no tensor and
allocates nothing on the device.  Inside a search that a
``core/trace.py`` Recorder traces, each record's ``nbytes`` also adds
to the search's ``wire_bytes`` counter (the Recorder enters a
``ScheduleRecorder`` when none is active: ``wire_tap``).

Each record carries ``nbytes``, the per-device bytes of the
collective's output, read from shapes only: the output tensor's bytes
over the processors it is stacked over, as the JAX package's roofline
sums the per-device (SPMD) output shapes of a compiled program's
collectives (``launch/roofline.py``).  A reduction to one value a
device (the counters, the level's decision) is one 32-bit word, the
int32 or float32 scalar the JAX package reduces, whatever wider type
the port sums in.

The NN side's shards (``models/``, ``optim/dp_step.py``) are stacked the
same way over any named axes, ``(dp..., tp, ...)`` for a ("data",
"model") mesh: ``all_to_all_axis``, ``psum_axis``, ``pmean_axis`` and
``psum_scatter_axis`` run over one named axis of such a stack and keep
the others, as a JAX collective inside ``shard_map`` does (the 2D SpMM,
``core/spmm.py``, folds with the last).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import trace

ROW, COL, POD = "data", "model", "pod"
GRID_2D = (ROW, COL)
STRIPS = (ROW,)

# HLO kind of each JAX primitive the port records
KINDS = {"psum": "all-reduce", "pmean": "all-reduce", "pmax": "all-reduce",
         "pmin": "all-reduce", "all_gather": "all-gather",
         "all_to_all": "all-to-all", "ppermute": "collective-permute",
         "psum_scatter": "reduce-scatter"}
REDUCTIONS = ("psum", "pmean", "pmax", "pmin")


@dataclass(frozen=True)
class Record:
    """One issued collective and where the level loop stood."""
    kind: str                 # HLO kind: "all-reduce", "all-gather", ...
    op: str                   # JAX primitive: "psum", "ppermute", ...
    axes: Tuple[str, ...]     # the mesh axes it runs over
    level: int                # the level loop's level (-1: before it)
    mode: str                 # "td" | "bu" | "loop" | "validate"
    pod: Optional[int]        # the pod whose search issued it (None: all)
    tag: str                  # "" | "counter" | "decision" | "lockstep" |
    #                           a branch: "sparse" | "dense" | "fallback"
    site: str                 # "file.py:line function" of the caller
    nbytes: int = 0           # per-device bytes of the output


class ScheduleRecorder:
    """Records every collective issued inside its ``with`` block.

    ``records`` is the schedule in issue order; ``counts()`` gives its
    per-kind counts and their ``total``, ``summary()`` the same by level.
    Recorders nest: the inner one records, and the outer one resumes
    when it exits."""

    def __init__(self):
        self.records: List[Record] = []
        self.level = -1
        self.mode = "loop"
        self.pod: Optional[int] = None
        self._outer = None

    def __enter__(self) -> "ScheduleRecorder":
        global _ACTIVE
        self._outer, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._outer

    def counts(self) -> Dict[str, int]:
        return count_kinds(self.records)

    def summary(self) -> Dict:
        """The recorded search by level: per-kind counts of the whole
        search, of the reduction before the first level (``startup``),
        and for each level its mode, the counts of its body (the td or
        bu step) and of the loop's records (the tail reduction, the
        pods' syncs), summed over pods, with the body's branch tags.
        The validator's records are left out."""
        search = [r for r in self.records if r.mode in ("td", "bu", "loop")]
        out: Dict = count_kinds(search)
        out["startup"] = count_kinds([r for r in search if r.level < 0])
        levels: Dict[int, Dict] = {}
        for r in search:
            if r.level >= 0:
                ent = levels.setdefault(r.level, {"mode": None, "body": [],
                                                  "loop": []})
                if r.mode == "loop":
                    ent["loop"].append(r)
                else:
                    ent["mode"] = r.mode
                    ent["body"].append(r)
        out["levels"] = [
            {"level": lv, "mode": e["mode"], "body": count_kinds(e["body"]),
             "loop": count_kinds(e["loop"]),
             "tags": sorted({r.tag for r in e["body"] if r.tag})}
            for lv, e in sorted(levels.items())]
        return out


def count_kinds(records: Sequence[Record]) -> Dict[str, int]:
    """Per-HLO-kind counts of ``records`` plus their ``total``, as the
    JAX package's ``hlo_collective_counts`` reports a program's."""
    out: Dict[str, int] = {}
    for r in records:
        out[r.kind] = out.get(r.kind, 0) + 1
    out["total"] = len(records)
    return out


_ACTIVE: Optional[ScheduleRecorder] = None


def at(level: int, mode: str, pod: Optional[int] = None) -> None:
    """Set the level, mode and pod that the next records carry (the
    level loop and the validator call this; a no-op unrecorded)."""
    rec = _ACTIVE
    if rec is not None:
        rec.level, rec.mode, rec.pod = level, mode, pod


SCALAR_BYTES = 4      # a reduced int32 or float32 scalar


def _record(op: str, axes: Tuple[str, ...], tag: str = "",
            nbytes: int = SCALAR_BYTES) -> None:
    rec = _ACTIVE
    if rec is None:
        return
    f = sys._getframe(2)
    site = (f"{f.f_code.co_filename.rsplit('/', 2)[-1]}:{f.f_lineno} "
            f"{f.f_code.co_name}")
    rec.records.append(Record(KINDS[op], op, tuple(axes), rec.level,
                              rec.mode, rec.pod, tag, site, int(nbytes)))
    cur = trace.current()
    if cur is not None:
        cur.count(trace.WIRE_BYTES, int(nbytes))


def wire_tap() -> Optional[ScheduleRecorder]:
    """For a ``trace.Recorder`` that is entering: a recorder entered here
    while none is active, so that every collective reaches ``_record``
    and its search's ``wire_bytes``, or None where one is active (which
    the collectives reach already).  The caller exits it, and its
    records go with it."""
    return ScheduleRecorder().__enter__() if _ACTIVE is None else None


def _block_bytes(x: torch.Tensor, n_lead: int) -> int:
    """Bytes of one processor's block of ``x``, whose leading ``n_lead``
    dims are the processors."""
    return x[(0,) * n_lead].numel() * x.element_size() if x.dim() > n_lead \
        else x.element_size()


def noted(op: str, axes: Tuple[str, ...], tag: str = "",
          nbytes: int = SCALAR_BYTES) -> None:
    """A reduction the JAX package issues here whose value the port
    already holds (read with the level's masses): recorded only, with
    the per-device bytes of the value the JAX package reduces (one
    scalar unless given)."""
    if _ACTIVE is not None:
        _record(op, axes, tag, nbytes)


def perm_index(perm: Sequence[Tuple[int, int]], device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst) flat-id tensors of a list of permute pairs, made once
    per plan so a permute costs no host-to-device copy."""
    src = torch.tensor([s for s, _ in perm], dtype=torch.int64, device=device)
    dst = torch.tensor([d for _, d in perm], dtype=torch.int64, device=device)
    return src, dst


def ppermute(x: torch.Tensor, perm: Tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    """Whole-mesh permute over (row, col): processor ``src[k]`` sends its
    block to ``dst[k]`` (``perm`` from ``perm_index``); processors that
    receive nothing hold zeros."""
    if _ACTIVE is not None:
        _record("ppermute", GRID_2D, nbytes=_block_bytes(x, 2))
    pr, pc = x.shape[:2]
    src, dst = perm
    flat = x.reshape(pr * pc, *x.shape[2:])
    out = torch.zeros_like(flat)
    out[dst] = flat[src]
    return out.reshape(x.shape)


def ppermute_col_ring(x: torch.Tensor) -> torch.Tensor:
    """The ring permute along the processor row, pairs (q, q+1 mod pc):
    processor (i, j) receives from (i, j-1)."""
    if _ACTIVE is not None:
        _record("ppermute", (COL,), nbytes=_block_bytes(x, 2))
    return torch.roll(x, shifts=1, dims=1)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_gather along the row axis: processor (i, j) receives the
    concatenation over i' of x[i', j].  The result is the same for every
    i, so it is returned as a broadcast view of one contiguous block a
    processor column, as a gather writes it (with one word a block the
    reshape alone would leave a strided view)."""
    pr, pc = x.shape[:2]
    if _ACTIVE is not None:
        _record("all_gather", (ROW,), nbytes=pr * _block_bytes(x, 2))
    g = x.transpose(0, 1).reshape(pc, pr * x.shape[2],
                                  *x.shape[3:]).contiguous()
    return g.unsqueeze(0).expand(pr, *g.shape)


def all_gather_cols(x: torch.Tensor) -> torch.Tensor:
    """Tiled all_gather along the col axis: processor (i, j) receives the
    concatenation over j' of x[i, j'], the same for every j (a broadcast
    view)."""
    pr, pc = x.shape[:2]
    if _ACTIVE is not None:
        _record("all_gather", (COL,), nbytes=pc * _block_bytes(x, 2))
    g = x.reshape(pr, pc * x.shape[2], *x.shape[3:])
    return g.unsqueeze(1).expand(pr, pc, *g.shape[1:])


def all_gather_tiled(x: torch.Tensor, axes: Tuple[str, ...],
                     tag: str = "") -> torch.Tensor:
    """Tiled all_gather over each of ``axes`` in turn, innermost first:
    every processor receives the blocks of ``x`` (its leading
    ``len(axes)`` dims the processors) concatenated in global order.
    Every processor holds the same buffer, so it is returned once, flat
    over the processors and contiguous, as a gather writes it: the
    strips' bitmap and bucket exchanges and the validator's replicated
    parents."""
    if _ACTIVE is not None:
        size = _block_bytes(x, len(axes))
        for d in reversed(range(len(axes))):
            size *= x.shape[d]
            _record("all_gather", (axes[d],), tag, size)
    return x.reshape(-1).contiguous()


def all_to_all_cols(x: torch.Tensor, tag: str = "") -> torch.Tensor:
    """all_to_all along the col axis (split and concat axis 2): x is
    ``(pr, pc, pc, ...)`` and processor (i, j) sends x[i, j, q] to (i, q),
    which stores it at position j."""
    if _ACTIVE is not None:
        _record("all_to_all", (COL,), tag, _block_bytes(x, 2))
    return x.transpose(1, 2).contiguous()


def psum(x: torch.Tensor, axes: Tuple[str, ...] = GRID_2D,
         tag: str = "") -> torch.Tensor:
    """Sum over ``axes`` of per-processor values stacked on the leading
    dim(s); every processor holds the same result."""
    _record("psum", axes, tag)
    return x.sum()


def psum_stacked(vals: Sequence[torch.Tensor], axes: Tuple[str, ...]
                 ) -> torch.Tensor:
    """One fused psum over ``axes`` of several per-processor sums, each
    already taken over the processors: the level loop's vector
    reduction, stacked into one tensor for one host read."""
    _record("psum", axes, nbytes=SCALAR_BYTES * len(vals))
    return torch.stack(list(vals))


def pmax(x: torch.Tensor, axes: Tuple[str, ...] = GRID_2D) -> torch.Tensor:
    """Max over ``axes`` of per-processor values; every processor holds
    the same result."""
    _record("pmax", axes)
    return x.amax()


def _axis_dim(x: torch.Tensor, axes: Sequence[str], axis: str) -> int:
    if axis not in axes or x.dim() < len(axes):
        raise ValueError(f"axis {axis!r} is not one of the stacked axes "
                         f"{tuple(axes)} of a {x.dim()}-d tensor")
    return list(axes).index(axis)


def all_to_all_axis(x: torch.Tensor, axes: Sequence[str], axis: str,
                    tag: str = "") -> torch.Tensor:
    """all_to_all over the named ``axis`` of ``x``, stacked over ``axes``
    (its leading ``len(axes)`` dims, one a processor coordinate), split
    and concat on the first per-processor dim: processor i along
    ``axis`` sends block j to processor j, which stores it at position
    i; the other axes are kept (the JAX package's ``lax.all_to_all(x,
    axis, split_axis=0, concat_axis=0)`` inside ``shard_map``)."""
    a, s = _axis_dim(x, axes, axis), len(axes)
    if x.dim() <= s or x.shape[s] != x.shape[a]:
        raise ValueError(f"all_to_all over {axis!r} of size {x.shape[a]} "
                         f"needs as many blocks, got shape {tuple(x.shape)}")
    if _ACTIVE is not None:
        _record("all_to_all", (axis,), tag, _block_bytes(x, len(axes)))
    return x.transpose(a, s).contiguous()


def psum_axis(x: torch.Tensor, axes: Sequence[str], axis: str,
              tag: str = "") -> torch.Tensor:
    """Sum over the named ``axis`` of ``x`` stacked over ``axes``: every
    processor along it holds the sum (a broadcast view), the other axes
    kept (``lax.psum(x, axis)`` inside ``shard_map``)."""
    a = _axis_dim(x, axes, axis)
    if _ACTIVE is not None:
        _record("psum", (axis,), tag, _block_bytes(x, len(axes)))
    return x.sum(dim=a, keepdim=True).expand_as(x)


def pmean_axis(x: torch.Tensor, axes: Sequence[str], axis: str,
               tag: str = "") -> torch.Tensor:
    """``psum_axis`` over the axis's size (``lax.pmean``)."""
    a = _axis_dim(x, axes, axis)
    if _ACTIVE is not None:
        _record("pmean", (axis,), tag, _block_bytes(x, len(axes)))
    return x.mean(dim=a, keepdim=True).expand_as(x)


def psum_scatter_axis(x: torch.Tensor, axes: Sequence[str], axis: str,
                      tag: str = "") -> torch.Tensor:
    """Combining reduce-scatter over the named ``axis`` of ``x`` stacked
    over ``axes``: the sum over the axis, of which processor q along it
    keeps the q-th of as many tiles of the first per-processor dim, the
    other axes kept (``lax.psum_scatter(x, axis, scatter_dimension=0,
    tiled=True)`` inside ``shard_map``)."""
    a, s = _axis_dim(x, axes, axis), len(axes)
    size = x.shape[a]
    if x.dim() <= s or x.shape[s] % size:
        raise ValueError(f"psum_scatter over {axis!r} of size {size} needs "
                         f"a first per-processor dim it divides, got shape "
                         f"{tuple(x.shape)}")
    if _ACTIVE is not None:
        _record("psum_scatter", (axis,), tag,
                _block_bytes(x, len(axes)) // size)
    summed = x.sum(dim=a)              # the axis gone; the rows at s - 1
    tiles = summed.reshape(*summed.shape[:s - 1], size,
                           x.shape[s] // size, *x.shape[s + 1:])
    return tiles.movedim(s - 1, a)
