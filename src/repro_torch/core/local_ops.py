"""LocalOps: the local-discovery layer behind the 2D decomposition.

An entry, registered under ``(decomposition, local_mode, storage)``,
declares which graph arrays a session ships (``keys``), the top-down
SpMSV closure and the bottom-up sub-step closure.  Registered here:

  ("2d", "dense",  "csr" | "dcsc")  edge-parallel plain oracles
  ("2d", "kernel", "csr")           the hand-written CUDA kernels

Closure signatures (arrays are one processor's block):

  topdown(g, f_words, f_mask, nr, col_offset, args)
      -> (cand (nr,) int32 candidate parents,
          edges examined, a 0-d int64 tensor)
  bottomup(rp_seg, ue_win, f_words, cvec, col_offset, n_edges, ve_win)
      -> (chunk,) int32 newly discovered parents (INT_INF = none)

``f_words`` is the packed frontier over the block's column range, and
``f_mask`` its unpacked bool form.  ``args`` is the ``LevelArgs``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.bottomup.ref import bottomup_substep as bu_ref
from repro_torch.kernels.spmsv import ops as spmsv_ops
from repro_torch.kernels.spmsv.ref import spmsv_dense


@dataclass(frozen=True)
class LocalOps:
    decomposition: str            # "2d"
    local_mode: str               # "dense" | "kernel"
    storage: str                  # "csr" | "dcsc"
    keys: Tuple[str, ...]         # graph arrays a session ships
    topdown: Callable             # SpMSV closure (see module docstring)
    bottomup: Callable            # bottom-up sub-step closure


_REGISTRY: Dict[Tuple[str, str, str], LocalOps] = {}


def register_local_ops(ops: LocalOps) -> LocalOps:
    key = (ops.decomposition, ops.local_mode, ops.storage)
    if key in _REGISTRY:
        raise ValueError(f"duplicate LocalOps {key}")
    _REGISTRY[key] = ops
    return ops


def get_local_ops(decomposition: str, local_mode: str,
                  storage: str) -> LocalOps:
    key = (decomposition, local_mode, storage)
    if key not in _REGISTRY:
        raise ValueError(
            f"no LocalOps registered for {key}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def registered_combos() -> Tuple[Tuple[str, str, str], ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Top-down SpMSV closures
# ---------------------------------------------------------------------------


def _td_dense(g, f_words, f_mask, nr, col_offset, args):
    """Edge-parallel scan over the whole block (oracle path): work
    O(nnz) whatever the frontier, so it examines every stored edge."""
    cand = spmsv_dense(g["edge_src"], g["row_idx"], g["nnz"], f_mask, nr,
                       col_offset)
    return cand, g["nnz"].to(torch.int64)


def _td_kernel_csr(g, f_words, f_mask, nr, col_offset, args):
    """The fused CUDA SpMSV through the uncompressed col_ptr.  The grid
    follows the live frontier, so ``args.cap_f`` is only a bound: 0 means
    the whole column range, and a larger frontier raises (the JAX
    package's kernel truncated it silently)."""
    cand = spmsv_ops.spmsv_csr_min(f_mask, g["col_ptr"], g["row_idx"], nr,
                                   col_offset, args.cap_f)
    lens = g["col_ptr"][1:] - g["col_ptr"][:-1]
    ex = torch.where(f_mask, lens, 0).sum(dtype=torch.int64)
    return cand, ex


# ---------------------------------------------------------------------------
# Bottom-up sub-step closures
# ---------------------------------------------------------------------------


def _bu_kernel(rp_seg, ue_win, f_words, cvec, col_offset, n_edges, ve_win):
    """The warp-per-row CUDA scan; rows come from the CSR pointers, so
    ``ve_win`` is unused."""
    return bu_ops.bottomup_substep(rp_seg, ue_win, f_words, cvec, col_offset,
                                   n_edges)


_DENSE_KEYS_2D = ("edge_src", "row_idx", "nnz", "deg_A", "col_idx",
                  "row_ptr", "seg_ptr", "edge_dst")
_KERNEL_CSR_KEYS_2D = ("col_ptr", "row_idx", "nnz", "deg_A", "col_idx",
                       "row_ptr", "seg_ptr")

for _storage in ("csr", "dcsc"):
    # dense discovery reads per-edge arrays only, whatever the storage
    register_local_ops(LocalOps(
        decomposition="2d", local_mode="dense", storage=_storage,
        keys=_DENSE_KEYS_2D, topdown=_td_dense, bottomup=bu_ref))

register_local_ops(LocalOps(
    decomposition="2d", local_mode="kernel", storage="csr",
    keys=_KERNEL_CSR_KEYS_2D, topdown=_td_kernel_csr, bottomup=_bu_kernel))
