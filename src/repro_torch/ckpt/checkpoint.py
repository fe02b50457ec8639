"""Fault-tolerant checkpointing, the JAX package's ``ckpt/checkpoint.py``:
atomic write (tmp + rename), step-indexed directories, metadata
validation, retention, and the process-stable config hash the graph
store rides on.

The on-disk format is the JAX package's: ``step_%010d/host0.npz`` with
one member ``leaf_i`` a leaf, in ``jax.tree.flatten``'s order (dict keys
sorted, NamedTuple fields and sequences in order), beside a
``meta.json``; so a training state written by either package restores
in the other.  A bfloat16 leaf is written as the JAX package writes it,
raw 2-byte records (numpy dtype ``|V2``; numpy has no bfloat16), and
read back bit for bit.  The hash is the JAX package's byte for byte (the
same canonical JSON under the same SHA-256).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_RAW_BF16 = np.dtype("V2")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys
    sorted, NamedTuple fields and tuple/list items in order, None a node
    without leaves; anything else (a tensor, an array, a scalar) is a
    leaf.  The treedef is a nested tuple that ``_unflatten`` reads."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for ls, _ in parts for x in ls],
                ("dict", tuple(keys), tuple(d for _, d in parts)))
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        kind = type(tree) if _is_namedtuple(tree) else type(tree).__name__
        return ([x for ls, _ in parts for x in ls],
                (kind, None, tuple(d for _, d in parts)))
    if tree is None:
        return [], ("none", None, ())
    return [tree], ("leaf", None, ())


def _unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        kind, keys, kids = d
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        if kind == "list":
            return vals
        if kind == "tuple":
            return tuple(vals)
        return kind(*vals)                      # a NamedTuple class
    return build(treedef)


def treedef_str(treedef: Any) -> str:
    """The string ``str(jax.tree.flatten(tree)[1])`` gives for the same
    structure (the ``treedef`` field of meta.json)."""
    def show(d):
        kind, keys, kids = d
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        inner = [show(k) for k in kids]
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}"
                                   for k, v in zip(keys, inner)) + "}"
        if kind == "list":
            return "[" + ", ".join(inner) + "]"
        if kind == "tuple":
            return "(" + ", ".join(inner) + ("," if len(inner) == 1
                                            else "") + ")"
        return (f"CustomNode(namedtuple[{kind.__name__}], "
                f"[{', '.join(inner)}])")
    return f"PyTreeDef({show(treedef)})"


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the array the JAX package writes: a bfloat16 tensor as
    raw 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(_RAW_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, like: Any) -> Any:
    """``arr`` read back as ``like``'s kind and dtype: a tensor on
    ``like``'s device for a tensor, else a numpy array.  Raw 2-byte
    records are bfloat16 bits."""
    if arr.dtype == _RAW_BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(dtype=like.dtype, device=like.device)
    if arr.dtype == _RAW_BF16:
        arr = t.to(torch.float32).numpy()
    return arr.astype(np.asarray(like).dtype)


def _canonical(obj: Any) -> Any:
    """JSON-serializable canonical form of a config object: dataclasses
    become {field: value} dicts tagged with the class name, dicts are
    key-sorted, numpy scalars unboxed.  Anything else is refused: a
    repr() fallback would embed ``object.__repr__`` memory addresses and
    make the hash differ across processes."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                **{f.name: _canonical(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {str(k): _canonical(v)
                for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(
        f"config_hash cannot canonicalize {type(obj).__name__!r} "
        f"({obj!r:.80}): pass a dataclass, dict, list/tuple, or JSON "
        f"scalar — arbitrary objects hash their repr(), which embeds "
        f"the memory address and breaks cross-process stability")


def config_hash(obj: Any) -> str:
    """Process-stable 16-hex-digit digest of a config: canonical JSON of
    dataclass/dict fields (sorted keys, no whitespace), never repr()."""
    payload = json.dumps(_canonical(obj), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``tree``'s leaves (tensors or arrays) to
    ``ckpt_dir/step_%010d`` through a temporary directory renamed into
    place, then keep the newest ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, treedef = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "host0.npz"),
                 **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(leaves),
                       "treedef": treedef_str(treedef), **(meta or {})}, f)
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep)
    return final


def restore(ckpt_dir: str, step: int, like: Any,
            expect_meta: Optional[Dict] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (values replaced): each
    leaf in the dtype of ``like``'s, a tensor on its device where
    ``like``'s is a tensor.  Raises on a meta value that differs from
    ``expect_meta``'s or on another leaf count."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    if expect_meta:
        for k, v in expect_meta.items():
            if meta.get(k) != v:
                raise ValueError(f"checkpoint meta mismatch on {k!r}: "
                                 f"{meta.get(k)!r} != {v!r}")
    leaves, treedef = _flatten(like)
    if len(leaves) != meta["n_leaves"]:
        raise ValueError("checkpoint structure mismatch")
    with np.load(os.path.join(d, "host0.npz")) as data:
        new = [_like(data[f"leaf_{i}"], x) for i, x in enumerate(leaves)]
    return _unflatten(treedef, new), meta


def _retain(ckpt_dir: str, keep: int):
    """Delete all but the newest ``keep`` step directories."""
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step under ``ckpt_dir``, or None without one."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None
