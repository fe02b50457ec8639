"""Checkpoint primitives the graph store rides on: the process-stable
config hash, step directories and their retention.

The JAX package's ``ckpt/checkpoint.py`` also saves and restores a
training state (``save``/``restore``); those wait for the port's trainer.
The hash is the JAX package's byte for byte (the same canonical JSON
under the same SHA-256), so a store written by either package validates
in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np


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
