"""Roofline terms on the H100's figures, from a step counted as it is
issued.

The JAX package prices each compiled cell with TPU v5e constants from
XLA's cost analysis and the collectives parsed from the HLO text.  The
port compiles nothing: ``StepCounter`` counts a step while it runs (on
PyTorch's ``meta`` device in the dry-run, which allocates nothing, or on
the card or the CPU), and the simulated mesh's ``ScheduleRecorder``
gives its collectives (``core/collectives.py``).  The card's figures:

  PEAK_FLOPS  989e12  dense bf16/fp16 tensor-core FLOP/s (H100 SXM data
                      sheet, without sparsity)
  FP32_FLOPS  67e12   float32 FLOP/s on the CUDA cores (the same sheet):
                      the port leaves TF32 off, so float32 GEMMs run here
  HBM_BW      3.35e12 HBM3 bytes/s (the same sheet, at the 700 W limit)
  LINK_BW     450e9   NVLink 4 bytes/s each way (900 GB/s both ways)

  compute term    = sum over dtype classes of FLOPs / that class's peak
  memory term     = bytes read and written / HBM_BW
  collective term = collective bytes / LINK_BW

all per device.  ``model_flops`` is the JAX package's, copied."""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 / fp16 dense, tensor cores
FP32_FLOPS = 67e12           # float32, CUDA cores (TF32 off)
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s each way, one NVLink 4 port group

# the peak of each dtype class a FLOP is counted under
CLASS_PEAKS = {"bf16": PEAK_FLOPS, "fp32": FP32_FLOPS}


def dtype_class(dtype: torch.dtype) -> str:
    """"bf16" for the tensor cores' half types, else "fp32"."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def collective_bytes_from_records(records: Iterable) -> Dict[str, float]:
    """Per-device bytes of each collective kind in ``records`` (a
    ``ScheduleRecorder``'s), with ``count_<kind>``, ``total_bytes`` and
    ``inloop_bytes``: the keys of the JAX package's
    ``collective_bytes_from_hlo``.  The port executes its loops, so a
    record exists for every trip and the sums already hold the trip
    counts; ``inloop_bytes`` is 0 and nothing is to be multiplied by a
    trip count again."""
    out: Dict[str, float] = {}
    for r in records:
        out[r.kind] = out.get(r.kind, 0.0) + r.nbytes
        out[f"count_{r.kind}"] = out.get(f"count_{r.kind}", 0.0) + 1
    out["total_bytes"] = sum(v for k, v in out.items()
                             if not k.startswith("count"))
    out["inloop_bytes"] = 0.0
    return out


def model_flops(meta: Dict) -> float:
    """Useful-FLOPs accounting per family (documented in EXPERIMENTS.md):
    LM: 6*N*D (dense) / 6*N_active*D (MoE), D = tokens processed;
        decode adds 12*L*kv_len*d_model*B attention-read FLOPs.
    GNN: per layer ~ 2*mlp_cost(V) + 2*E*d (aggregation) * 3 (fwd+bwd).
    Recsys: 6 * (lookup+attn+mlp params touched) * batch."""
    fam = meta.get("family")
    if fam == "lm":
        n = meta.get("n_active_params") or meta["n_params"]
        toks = meta["tokens"]
        mult = 6.0 if meta.get("kind") == "train" else 2.0
        return mult * n * toks
    if fam == "gnn":
        V, E = meta["n_nodes"], meta["n_edges"]
        d, L = meta["d_hidden"], meta["n_layers"]
        per_layer = 2 * V * (2 * d * d) + 2 * E * d
        mult = 3.0   # fwd + bwd
        return mult * (L * per_layer + 2 * V * meta.get("d_feat", d) * d)
    if fam == "recsys":
        B, F, d = meta["batch"], meta["n_fields"], meta["embed_dim"]
        attn = 3 * 2 * F * F * 64 * B + 3 * 2 * F * d * 64 * B
        mlp = 2 * B * (F * 64 * 256 + 256 * 128)
        mult = 3.0 if meta.get("kind") == "train" else 1.0
        base = mult * (attn + mlp)
        if meta.get("n_candidates"):
            base += 2.0 * meta["n_candidates"] * 64
        return base
    if fam == "bfs":
        # BFS has no FLOP workload: useful work = edge examinations.
        return float(meta.get("m", 0))
    return 0.0


def compute_seconds(rec: Dict) -> float:
    """Per-device FLOPs over their class's peak (``flops_by_class``); a
    record without the split counts every FLOP at the bf16 peak."""
    by = rec.get("flops_by_class")
    if not by:
        return (rec.get("flops", 0.0) or 0.0) / PEAK_FLOPS
    return sum(f / CLASS_PEAKS[c] for c, f in by.items())


def roofline_report(rec: Dict) -> Dict:
    """The roofline terms of a dry-run record (per-device ``flops``,
    ``flops_by_class``, ``bytes_accessed`` and collective bytes), under
    the JAX package's keys; ``hlo_flops_total`` is the counted FLOPs of
    the whole mesh."""
    n_dev = rec.get("n_devices", 256)
    flops = rec.get("flops", 0.0) or 0.0
    bytes_acc = rec.get("bytes_accessed", 0.0) or 0.0
    coll = rec.get("collectives", {}).get("total_bytes", 0.0)
    terms = {"compute_s": compute_seconds(rec), "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec.get("meta", {}))
    total = flops * n_dev
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_ratio": (mf / total) if total else None,
        "bound_time_s": max(terms.values()),
    }


# ---------------------------------------------------------------------------
# The step counter
# ---------------------------------------------------------------------------

_ACTIVE = []          # the counters entered, innermost last
# ops that move no data although their schema aliases nothing
_NO_BYTES = ("_unsafe_view", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided", "lift_fresh")


def _unique_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor names, a broadcast (stride-0) dim
    counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs, through nested
    sequences and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


_FRESH: Dict = {}     # op -> per return, whether it owns a new storage


def _fresh_outputs(func, out) -> list:
    """The outputs of ``func`` that own a new storage: those whose return
    aliases no input (in-place ops and views return their input's)."""
    fresh = _FRESH.get(func)
    if fresh is None:
        fresh = _FRESH[func] = tuple(r.alias_info is None
                                     for r in func._schema.returns)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if len(fresh) == 1:
        return _tensors(outs) if fresh[0] else []
    return [t for f, o in zip(fresh, outs) if f for t in _tensors((o,))]


def _meta_cumsum(a, dim, dtype=None, **_):
    """PyTorch's meta cumsum builds an (n, n) mask, which overflows at a
    BFS level's sizes; its output is ``a``'s shape in the sum's dtype."""
    if dtype is None:
        dtype = torch.int64 if not (a.is_floating_point()
                                    or a.is_complex()) else a.dtype
    return torch.empty(a.shape, dtype=dtype, device=a.device)


# meta-device shape functions the counter uses in place of PyTorch's
_META_OPS = {torch.ops.aten.cumsum.default: _meta_cumsum}
# scratch that an op's backends size differently (CUDA's log_sigmoid keeps
# an empty buffer, the CPU's and meta's a full one): which of its outputs
# and arguments are that scratch, counted as no bytes
_SCRATCH = {torch.ops.aten.log_sigmoid_forward.default: ("out", 1),
            torch.ops.aten.log_sigmoid_backward.default: ("arg", 2)}


class StepCounter(TorchDispatchMode):
    """Counts every aten op issued inside its ``with`` block:

      flops       FLOPs by dtype class ("bf16", "fp32"): the matrix
                  products, convolutions and attentions of
                  ``torch.utils.flop_counter``'s table, classed by their
                  first operand's dtype
      bytes_read, bytes_written
                  each op's tensor inputs read once and outputs written
                  once (a broadcast dim once); views, and the
                  allocations of ``empty``, move nothing
      peak_bytes  the peak of live bytes in the storages allocated inside
                  the block (each tracked by a finalizer, so it drops
                  when a storage dies: autograd's saved tensors, the
                  remat policy's and the kernels' scratch all count)
      ops, kernels
                  per aten op and per hand-written kernel: calls, FLOPs
                  and bytes

    A hand-written kernel's entry reports its own FLOPs and bytes through
    ``kernel(name, cost)``; the aten ops inside that scope (its
    output allocations, its plain version on the CPU) are not counted,
    so the count is the same on the card, on the CPU and on ``meta``.
    Their storages still count toward the peak."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {"bf16": 0.0, "fp32": 0.0}
        self.bytes_read = 0
        self.bytes_written = 0
        self.live = 0
        self.peak_bytes = 0
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
        self.kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
        self._mute = 0
        self._seen: Dict[int, int] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def bytes_accessed(self) -> int:
        return self.bytes_read + self.bytes_written

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live)

    def add_kernel(self, name: str, flops: float, nbytes: int,
                   dtype: torch.dtype) -> None:
        k = self.kernels[name]
        k[0] += 1
        k[1] += flops
        k[2] += nbytes
        self.flops[dtype_class(dtype)] += flops
        self.bytes_read += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        shape_fn = _META_OPS.get(func)
        if shape_fn is not None and args[0].is_meta:
            out = shape_fn(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self._track(_fresh_outputs(func, out))
        name = func.overloadpacket.__name__
        if self._mute or func.is_view or name == "_unsafe_view":
            return out
        rec = self.ops[str(func.overloadpacket)]
        rec[0] += 1
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            f = float(fn(*args, **kwargs, out_val=out))
            first = _tensors(args)[0]
            self.flops[dtype_class(first.dtype)] += f
            rec[1] += f
        if name in _NO_BYTES:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        scratch = _SCRATCH.get(func)
        if scratch is not None:
            where, i = scratch
            drop = (out if where == "out" else args)[i]
            ins = [t for t in ins if t is not drop]
            outs = [t for t in outs if t is not drop]
        read = sum(_unique_bytes(t) for t in ins)
        wrote = sum(_unique_bytes(t) for t in outs)
        self.bytes_read += read
        self.bytes_written += wrote
        rec[2] += read + wrote
        return out

    def summary(self) -> Dict:
        return {"flops": self.total_flops, "flops_by_class": dict(self.flops),
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "bytes_accessed": self.bytes_accessed,
                "peak_bytes": self.peak_bytes,
                "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                            for k, v in self.kernels.items()}}


def active() -> Optional[StepCounter]:
    return _ACTIVE[-1] if _ACTIVE else None


class _KernelScope:
    """The active counter's scope of one hand-written kernel call."""
    __slots__ = ("counter", "name", "cost", "dtype")

    def __init__(self, counter, name, cost, dtype):
        self.counter, self.name, self.cost, self.dtype = (counter, name,
                                                          cost, dtype)

    def __enter__(self):
        flops, nbytes = self.cost() if callable(self.cost) else self.cost
        self.counter.add_kernel(self.name, flops, nbytes, self.dtype)
        self.counter._mute += 1

    def __exit__(self, *exc):
        self.counter._mute -= 1


_NO_SCOPE = contextlib.nullcontext()


def kernel(name: str, cost, dtype: torch.dtype = torch.float32):
    """A hand-written kernel's scope: its ``cost``, (flops, bytes) or a
    function giving them (called only while a counter is active), goes
    to the active counter, the FLOPs classed by ``dtype``, and the aten
    ops inside are not counted.  With no counter active it is a shared
    null context (one list test: the serving path is host-bound)."""
    if not _ACTIVE:
        return _NO_SCOPE
    return _KernelScope(_ACTIVE[-1], name, cost, dtype)
