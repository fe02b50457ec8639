"""LocalOps: the local-discovery layer behind the decompositions.

An entry, registered under ``(decomposition, local_mode, storage)``,
declares which graph arrays a session ships (``keys``), the top-down
SpMSV closure, the bottom-up sub-step closure, for the 1D strips the
per-sub-chunk SpMSV of the pipelined expand (``topdown_chunk``), for
"1ds" the packed codec's ``encode`` and ``decode``, for "2d" the level
``epilogue``, and the CUDA kernels a session loads at compile
(``kernels``), and the §5.1 storage
accounting of its format (``storage_words(graph) -> words``, the
graph's ``storage_words(storage)``).  Registered here, the paper's Fig. 6
grid:

  ("2d", "dense",  "csr" | "dcsc")  edge-parallel plain oracles, and
                                    the epilogue's plain twin
  ("2d", "kernel", "csr")           kernel 1 through the block col_ptr
                                    + the bottom-up kernel + the
                                    epilogue kernel
  ("2d", "kernel", "dcsc")          kernel 1 through the block DCSC (a
                                    binary search a frontier id)
                                    + the bottom-up kernel + the
                                    epilogue kernel
  ("1d", "dense",  "csr" | "dcsc")  edge-parallel plain oracles
  ("1d", "kernel", "csr")           kernel 1 over all strips through the
                                    (p, n+1) strip col_ptr + the
                                    bottom-up kernel
  ("1d", "kernel", "dcsc")          the strip SpMSV kernels over the
                                    strip DCSC + the bottom-up kernel
  ("1ds", ...)                      mirrors of the "1d" entries: the
                                    sparse exchange changes the expand,
                                    not local discovery

2D closure signatures (arrays are one processor's block):

  topdown(g, f_words, nr, col_offset, args)
      -> (cand (nr,) int32 candidate parents,
          edges examined, a 0-d int64 tensor, or None where a plain
          closure would compute it for the counters alone and
          ``args.instrument`` is False)

  epilogue(pi, deg, cand=None, recv=None, root=-1) -> Front
      the end of a level over the whole grid (``kernels/epilogue/
      ops.py``): the kernel entries' ``level_epilogue``, the dense
      oracle's ``level_epilogue_plain``, so that the oracle stays plain
      PyTorch on the card

The 1D top-down closures take ALL p strips at once (the stacked ``(p,
...)`` arrays; col_offset is 0 since strip ids are global), so a kernel
launch covers the whole simulated mesh:

  topdown(g, f_words, args)                 -> (cand (p, chunk), ex)
  topdown_chunk(g, g_sub, k, n_chunks, args) -> (cand (p, chunk), ex)

``f_words`` is the packed (n/32,) frontier every strip received and
``g_sub`` the owner-major (p * w_sub,) words of pipelined step k (an
entry with no ``topdown_chunk`` gets each step scattered into a
full-size partial bitmap, ``core/steps_1d.py``).  The bottom-up closure is per block or per strip in both decompositions:

  bottomup(rp_seg, ue_win, f_words, cvec, col_offset, n_edges, ve_win)
      -> (chunk,) int32 newly discovered parents (INT_INF = none)

``f_words`` is the packed frontier over the block's column range (an
entry that reads a bool mask unpacks it).  ``args`` is the LevelArgs.  A 1D
kernel entry also scans all p strips of a bottom-up level in one launch
(a dense entry leaves it None and runs ``bottomup`` strip by strip):

  bottomup_strips(g, f_words, cvec (p, chunk), args) -> (p, chunk) int32

The "1ds" codec closures take all p buckets at once:

  encode(off (p, cap), count (p,), chunk)      -> (p, 1 + W) int32 words
  decode(recv (p * (1 + W),), chunk, cap, n, p) -> (p * cap,) int32 ids
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.frontier import unpack_bits
from repro_torch.kernels.bottomup import ops as bu_ops
from repro_torch.kernels.bottomup.ref import bottomup_substep as bu_ref
from repro_torch.kernels.epilogue import ops as epilogue_ops
from repro_torch.kernels.frontier_codec import ops as codec_ops
from repro_torch.kernels.frontier_codec import ref as codec_ref
from repro_torch.kernels.spmsv import ops as spmsv_ops
from repro_torch.kernels.spmsv import strip
from repro_torch.kernels.spmsv.ref import spmsv_dense


@dataclass(frozen=True)
class LocalOps:
    decomposition: str            # "2d" | "1d" | "1ds"
    local_mode: str               # "dense" | "kernel"
    storage: str                  # "csr" | "dcsc"
    keys: Tuple[str, ...]         # graph arrays a session ships
    topdown: Callable             # SpMSV closure (see module docstring)
    bottomup: Callable            # bottom-up sub-step closure
    storage_words: Callable       # (graph) -> Dict[str, int], §5.1 words
    topdown_chunk: Callable = None  # 1D: SpMSV of one pipelined sub-chunk
    bottomup_strips: Callable = None  # 1D: the sub-step of all p strips
    encode: Callable = None       # 1ds: packed codec, p buckets at once
    decode: Callable = None       # 1ds: the gathered buckets -> global ids
    epilogue: Callable = None     # 2d: the level epilogue
    kernels: Tuple = ()           # CudaKernels a session loads at compile


_REGISTRY: Dict[Tuple[str, str, str], LocalOps] = {}


def register_local_ops(ops: LocalOps) -> LocalOps:
    key = (ops.decomposition, ops.local_mode, ops.storage)
    if key in _REGISTRY:
        raise ValueError(f"duplicate LocalOps {key}")
    _REGISTRY[key] = ops
    return ops


def unregister_local_ops(decomposition: str, local_mode: str,
                         storage: str) -> None:
    """Remove an entry: for scoped registrations only (the linter's
    fixture)."""
    key = (decomposition, local_mode, storage)
    if key not in _REGISTRY:
        raise ValueError(f"no LocalOps registered for {key}")
    del _REGISTRY[key]


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


def _td_dense(g, f_words, nr, col_offset, args):
    """Edge-parallel scan over the whole block (oracle path) against the
    block's frontier words unpacked: work O(nnz) whatever the frontier,
    so it examines every stored edge."""
    cand = spmsv_dense(g["edge_src"], g["row_idx"], g["nnz"],
                       unpack_bits(f_words), nr, col_offset)
    return cand, g["nnz"].to(torch.int64) if args.instrument else None


def _td_kernel_csr(g, f_words, nr, col_offset, args):
    """The fused CUDA SpMSV through the uncompressed col_ptr, on the
    block's frontier words.  ``args.cap_f`` is only a bound: 0 means the
    whole column range, and a larger frontier raises (the JAX package's
    kernel truncated it silently).  The edges examined are the kernel's
    own count."""
    cand, ex = spmsv_ops.spmsv_min(
        spmsv_ops.csr(g["col_ptr"], g["row_idx"]), f_words, nr, col_offset,
        args.cap_f)
    return cand, ex if args.instrument else None


def _td_kernel_dcsc(g, f_words, nr, col_offset, args):
    """The fused CUDA SpMSV through the block's DCSC: each frontier id is
    binary-searched in ``jc`` and its segment starts at ``cp[slot]`` (the
    paper's hypersparse indirection, Fig. 6); ``cap_f`` as for csr.  The
    edges examined, the kernel's count, are the found columns' segment
    lengths, the JAX package's ``_dcsc_edges_examined``."""
    cand, ex = spmsv_ops.spmsv_min(
        spmsv_ops.dcsc(g["jc"], g["cp"], g["nzc"], g["row_idx"]), f_words,
        nr, col_offset, args.cap_f)
    return cand, ex if args.instrument else None


def _td_dense_1d(g, f_words, args):
    """Edge-parallel scan of every strip (oracle path): work O(nnz)
    whatever the frontier, so it examines every stored edge."""
    f_mask = unpack_bits(f_words)
    nr = args.part.chunk
    cand = torch.stack([spmsv_dense(g["edge_src"][i], g["row_idx"][i],
                                    g["nnz"][i], f_mask, nr, 0)
                        for i in range(args.part.p)])
    return cand, g["nnz"].sum(dtype=torch.int64) if args.instrument \
        else None


def _td_strips_csr(g, f_words, args):
    """Kernel 1 over all p strips through the ``(p, n+1)`` strip
    ``col_ptr``, one launch against the allgathered bitmap; the edges
    examined are the frontier's segments in every strip (its edge
    total).  ``args.cap_f`` bounds the frontier as on the 2D entries: a
    larger one raises (the JAX package's kernel truncated it
    silently)."""
    return spmsv_ops.spmsv_min(spmsv_ops.strips(g["col_ptr"], g["row_idx"]),
                               f_words, args.part.chunk, 0, args.cap_f)


def _td_strip_dcsc(g, f_words, args):
    """The strip SpMSV kernel against the allgathered bitmap, one launch
    for all p: it walks the frontier's ids or the strips' columns,
    whichever is cheaper."""
    return strip.spmsv_strip_dcsc(g["jc"], g["cp"], g["nzc"], g["row_idx"],
                                  f_words, args.part.chunk)


def _td_strip_dcsc_chunk(g, g_sub, k, n_chunks, args):
    """The per-sub-chunk strip SpMSV kernel of the pipelined expand: it
    reads the raw owner-major sub-chunk words, so no full-size bitmap is
    built; the caller min-combines the steps."""
    part = args.part
    return strip.spmsv_strip_dcsc_chunk(g["jc"], g["cp"], g["nzc"],
                                        g["row_idx"], g_sub, part.chunk,
                                        n=part.n, k=k, n_chunks=n_chunks)


def _encode_kernel(off, count, chunk):
    """The codec's encode kernel: all p buckets in one launch."""
    return codec_ops.encode_offsets(off, count, chunk)


def _decode_kernel(recv, chunk, cap, n, p):
    """The codec's decode kernel: the gathered buckets, decoded once."""
    return codec_ops.decode_buckets(recv, chunk, cap, n, p)


def _decode_plain(recv, chunk, cap, n, p):
    """The plain decode under the kernel wrapper's signature."""
    return codec_ref.decode_buckets(recv, chunk, cap, n)


# ---------------------------------------------------------------------------
# Bottom-up sub-step closures
# ---------------------------------------------------------------------------


def _bu_kernel(rp_seg, ue_win, f_words, cvec, col_offset, n_edges, ve_win):
    """The warp-per-row CUDA scan; rows come from the CSR pointers, so
    ``ve_win`` is unused."""
    return bu_ops.bottomup_substep(rp_seg, ue_win, f_words, cvec, col_offset,
                                   n_edges)


def _bu_kernel_strips(g, f_words, cvec, args):
    """The CUDA scan over all p strips in one launch, with the strips'
    edge counts from the shipped (p,) ``nnz``."""
    return bu_ops.bottomup_substep_strips(g["row_ptr"], g["col_idx"],
                                          f_words, cvec, g["nnz"])


def _words(mode):
    return lambda graph: graph.storage_words(mode)


_DENSE_KEYS_2D = ("edge_src", "row_idx", "nnz", "deg_A", "col_idx",
                  "row_ptr", "seg_ptr", "edge_dst")
_KERNEL_CSR_KEYS_2D = ("col_ptr", "row_idx", "nnz", "deg_A", "col_idx",
                       "row_ptr", "seg_ptr")
_KERNEL_DCSC_KEYS_2D = ("jc", "cp", "nzc", "row_idx", "nnz", "deg_A",
                        "col_idx", "row_ptr", "seg_ptr")

for _storage in ("csr", "dcsc"):
    # dense discovery reads per-edge arrays only, whatever the storage;
    # the accounting still reports the mode a deployment would pay for
    register_local_ops(LocalOps(
        decomposition="2d", local_mode="dense", storage=_storage,
        keys=_DENSE_KEYS_2D, topdown=_td_dense, bottomup=bu_ref,
        epilogue=epilogue_ops.level_epilogue_plain,
        storage_words=_words(_storage)))

register_local_ops(LocalOps(
    decomposition="2d", local_mode="kernel", storage="csr",
    keys=_KERNEL_CSR_KEYS_2D, topdown=_td_kernel_csr, bottomup=_bu_kernel,
    epilogue=epilogue_ops.level_epilogue, storage_words=_words("csr"),
    kernels=(spmsv_ops.KERNEL, bu_ops.KERNEL, epilogue_ops.KERNEL)))
register_local_ops(LocalOps(
    decomposition="2d", local_mode="kernel", storage="dcsc",
    keys=_KERNEL_DCSC_KEYS_2D, topdown=_td_kernel_dcsc, bottomup=_bu_kernel,
    epilogue=epilogue_ops.level_epilogue, storage_words=_words("dcsc"),
    kernels=(spmsv_ops.KERNEL_DCSC, bu_ops.KERNEL, epilogue_ops.KERNEL)))

_DENSE_KEYS_1D = ("edge_src", "row_idx", "nnz", "deg_A", "col_idx",
                  "row_ptr", "edge_dst")
_KERNEL_CSR_KEYS_1D = ("col_ptr", "row_idx", "nnz", "deg_A", "col_idx",
                       "row_ptr")
_KERNEL_DCSC_KEYS_1D = ("jc", "cp", "nzc", "row_idx", "nnz", "deg_A",
                        "col_idx", "row_ptr")

for _storage in ("csr", "dcsc"):
    register_local_ops(LocalOps(
        decomposition="1d", local_mode="dense", storage=_storage,
        keys=_DENSE_KEYS_1D, topdown=_td_dense_1d, bottomup=bu_ref,
        storage_words=_words(_storage)))

# no topdown_chunk: the pipelined expand scatters each sub-chunk into a
# partial bitmap for it, as the JAX package's csr strips do
register_local_ops(LocalOps(
    decomposition="1d", local_mode="kernel", storage="csr",
    keys=_KERNEL_CSR_KEYS_1D, topdown=_td_strips_csr, bottomup=_bu_kernel,
    bottomup_strips=_bu_kernel_strips, storage_words=_words("csr"),
    kernels=(spmsv_ops.KERNEL_STRIPS, bu_ops.KERNEL)))
register_local_ops(LocalOps(
    decomposition="1d", local_mode="kernel", storage="dcsc",
    keys=_KERNEL_DCSC_KEYS_1D, topdown=_td_strip_dcsc, bottomup=_bu_kernel,
    topdown_chunk=_td_strip_dcsc_chunk, bottomup_strips=_bu_kernel_strips,
    storage_words=_words("dcsc"),
    kernels=(strip.KERNEL, strip.KERNEL_CHUNK, bu_ops.KERNEL)))

# "1ds" traverses the same strips with the same local discovery; only
# the expand collective differs (core/steps_1d_sparse.py).  A kernel
# session encodes and decodes the packed buckets with the codec kernels,
# a dense one with their plain versions (as the JAX package's dense
# sessions run its jnp codec)
for _combo in [k for k in sorted(_REGISTRY) if k[0] == "1d"]:
    _ops = _REGISTRY[_combo]
    if _ops.local_mode == "kernel":
        _codec = dict(encode=_encode_kernel, decode=_decode_kernel,
                      kernels=_ops.kernels + (codec_ops.ENCODE,
                                              codec_ops.DECODE))
    else:
        _codec = dict(encode=codec_ref.encode_offsets, decode=_decode_plain)
    register_local_ops(dataclasses.replace(_ops, decomposition="1ds",
                                           **_codec))
