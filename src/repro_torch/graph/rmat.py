"""Graph500 R-MAT generator (Chakrabarti et al.) + preprocessing.

Parameters follow the paper (§7.2): a,b,c,d = 0.57,0.19,0.19,0.05 and
edge factor 16 unless stated; ``scale`` means 2**scale vertices.
Preprocessing prunes self loops and duplicate edges and symmetrizes.

Two generators, the same streams as the JAX package's:

  * ``rmat_edges`` -- the sequential ``np.random.default_rng`` level-draw
    generator, on the host (every small pinned graph uses it).
  * ``rmat_edges_counter`` -- the stateless counter stream: edge e's
    quadrant path is a pure function of (seed, e, level) through a
    uint32 hash.  On a CUDA device it runs the hand-written kernel
    ``csrc/rmat_counter.cu``; on the CPU its plain PyTorch version.

``rmat_graph(..., generator="counter", device="cuda")`` generates and
preprocesses on the card; the host never holds the edge list.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel, require_cuda, stream_handle
from repro_torch.launch.mesh import resolve_device

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9          # counter -> hash stream spreading constant


def _mix_int(x: int) -> int:
    """fmix32-style avalanche on a Python int (mod 2**32)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def level_salt(seed: int, level: int) -> int:
    """Per-(seed, level) salt for the counter hash."""
    return _mix_int((int(seed) * 0x85EBCA6B + level * 0xC2B2AE35
                     + 0x27D4EB2F) & _M32)


def rmat_thresholds(a: float, b: float, c: float) -> Tuple[int, int, int]:
    """Cumulative quadrant thresholds as exact uint32 comparands: a draw
    u ~ U[0, 2**32) picks quadrant a/b/c/d by u < t1 / t2 / t3 / else."""
    t1 = min(int(round(a * 2.0 ** 32)), _M32)
    t2 = min(int(round((a + b) * 2.0 ** 32)), _M32)
    t3 = min(int(round((a + b + c) * 2.0 ** 32)), _M32)
    return t1, t2, t3


RMAT_COUNTER = CudaKernel("rmat_counter", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_uint, ctypes.c_void_p])


def _slice_bounds(scale: int, edge_factor: int, start: int, count):
    if scale > 30:
        raise ValueError(f"scale={scale} > 30 overflows int32 vertex ids")
    m_input = edge_factor << scale
    if count is None:
        count = m_input - start
    if not 0 <= start <= start + count <= m_input:
        raise ValueError(f"slice [{start}, {start + count}) outside the "
                         f"{m_input}-edge stream")
    return count


def rmat_edges_counter_plain(scale: int, edge_factor: int = 16,
                             a: float = 0.57, b: float = 0.19,
                             c: float = 0.19, seed: int = 1, start: int = 0,
                             count: int | None = None, device="cpu"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the counter kernel: uint32 arithmetic done
    in int64 and masked to 32 bits after every multiply."""
    count = _slice_bounds(scale, edge_factor, start, count)
    t1, t2, t3 = rmat_thresholds(a, b, c)
    idx = (torch.arange(count, dtype=torch.int64, device=device)
           + (start & _M32)) & _M32
    base = (idx * _GOLDEN) & _M32
    src = torch.zeros(count, dtype=torch.int32, device=device)
    dst = torch.zeros(count, dtype=torch.int32, device=device)
    for level in range(scale):
        x = base ^ level_salt(seed, level)
        x ^= x >> 16
        x = (x * 0x7FEB352D) & _M32
        x ^= x >> 15
        x = (x * 0x846CA68B) & _M32
        x ^= x >> 16
        src |= (x >= t2).to(torch.int32) << level
        dst |= (((x >= t1) & (x < t2)) | (x >= t3)).to(torch.int32) << level
    return src, dst


KERNEL_SCALES = range(1, 31)   # the kernel's instantiations (kMaxScale)


def kernel_salts(seed: int, scale: int) -> list:
    """The kernel's launch salts: ``level_salt`` folded with its first
    xor-shift, S_l = s ^ (s >> 16), for levels 0..scale-1.  The kernel
    is built for the scales of ``KERNEL_SCALES`` and no others."""
    if scale not in KERNEL_SCALES:
        raise ValueError(f"scale={scale}: the counter kernel is built for "
                         f"scales {KERNEL_SCALES.start}..."
                         f"{KERNEL_SCALES.stop - 1}")
    return [s ^ (s >> 16) for s in (level_salt(seed, lv)
                                    for lv in range(scale))]


def rmat_edges_counter(scale: int, edge_factor: int = 16, a: float = 0.57,
                       b: float = 0.19, c: float = 0.19, seed: int = 1,
                       start: int = 0, count: int | None = None,
                       device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Edges [start, start+count) of the counter R-MAT stream of
    m_input = edge_factor * 2**scale edges, as int32 (src, dst) tensors
    on ``device``.  Bit-identical to the JAX package's numpy
    ``rmat_edges_counter`` for any slice.  On a CUDA device the kernel
    takes scales 1..30 and a, b, c >= 0 (monotone thresholds)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return rmat_edges_counter_plain(scale, edge_factor, a, b, c, seed,
                                        start, count, device=dev)
    count = _slice_bounds(scale, edge_factor, start, count)
    t1, t2, t3 = rmat_thresholds(a, b, c)
    if not t1 <= t2 <= t3:
        raise ValueError(f"a, b, c = {a}, {b}, {c}: the counter kernel "
                         f"needs a, b, c >= 0")
    folded = (ctypes.c_uint * len(KERNEL_SCALES))(
        *kernel_salts(seed, scale))
    RMAT_COUNTER.load()
    src = torch.empty(count, dtype=torch.int32, device=dev)
    dst = torch.empty(count, dtype=torch.int32, device=dev)
    require_cuda(src, dst)
    if count:
        RMAT_COUNTER.launch(src.data_ptr(), dst.data_ptr(), count,
                            start & _M32, folded, scale, t1, t2, t3,
                            stream_handle(dev))
    return src, dst


@dataclass(frozen=True)
class EdgeList:
    """A deduplicated edge list on one device, sorted by (src, dst).
    ``src``/``dst`` are int32 (the JAX package keeps int64 on the host;
    vertex ids fit int32 up to scale 30 and int32 halves the card's
    footprint)."""
    n: int
    src: torch.Tensor  # int32[m]
    dst: torch.Tensor  # int32[m]
    m_input: int       # edge count before dedup/symmetrize (TEPS numerator)

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n).to(torch.int64)


def rmat_edges(scale: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 1,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The sequential-RNG R-MAT stream on the host: (src, dst) int64
    numpy arrays of 2**scale*ef edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    d = 1.0 - a - b - c
    # P(dst_bit=1 | src_bit=0) = b/(a+b);  P(dst_bit=1 | src_bit=1) = d/(c+d)
    p_dst_given0 = b / ab
    p_dst_given1 = d / (c + d)
    for level in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 >= ab
        dst_bit = np.where(src_bit, r2 < p_dst_given1, r2 < p_dst_given0)
        src |= src_bit.astype(np.int64) << level
        dst |= dst_bit.astype(np.int64) << level
    return src, dst


def preprocess(src: torch.Tensor, dst: torch.Tensor, n: int,
               symmetrize: bool = True) -> EdgeList:
    """Prune self-loops and duplicates; optionally symmetrize.  Runs on
    the device of ``src``; the result is sorted by (src, dst), the order
    the JAX package's ``np.unique`` leaves.  Temporaries are freed as it
    goes: at scale 24 the 64-bit keys alone are 4 GiB."""
    m_input = int(src.shape[0])
    keep = src != dst
    s, d = src[keep], dst[keep]
    del keep
    k1 = s.to(torch.int64).mul_(n).add_(d)
    if symmetrize:
        k2 = d.to(torch.int64).mul_(n).add_(s)
        del s, d
        key = torch.cat([k1, k2])
        del k1, k2
    else:
        del s, d
        key = k1
    key = torch.sort(key).values
    key = torch.unique_consecutive(key)
    out_src = torch.div(key, n, rounding_mode="floor").to(torch.int32)
    out_dst = key.remainder_(n).to(torch.int32)
    return EdgeList(n=n, src=out_src, dst=out_dst, m_input=m_input)


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 1,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               generator: str = "numpy", device="cuda") -> EdgeList:
    """Generate + preprocess.  ``generator="numpy"`` draws the sequential
    stream on the host; ``generator="counter"`` the counter stream, on
    ``device`` (the kernel on a card)."""
    dev = resolve_device(device)
    if generator == "numpy":
        s, d = rmat_edges(scale, edge_factor, a, b, c, seed)
        src = torch.from_numpy(s.astype(np.int32)).to(dev)
        dst = torch.from_numpy(d.astype(np.int32)).to(dev)
    elif generator == "counter":
        src, dst = rmat_edges_counter(scale, edge_factor, a, b, c, seed,
                                      device=dev)
    else:
        raise ValueError(f"unknown generator {generator!r} "
                         f"(have 'numpy', 'counter')")
    return preprocess(src, dst, 1 << scale)


def scale_free_standin(n: int, m_target: int, seed: int = 7,
                       device="cuda") -> EdgeList:
    """The JAX package's stand-in for the Twitter graph (Fig. 9, which
    needs a download): R-MAT with a heavier hub parameter, from the host
    stream ``rmat_edges``, preprocessed on ``device``."""
    scale = int(np.ceil(np.log2(max(n, 2))))
    ef = max(1, m_target // (1 << scale))
    return rmat_graph(scale, ef, seed=seed, a=0.65, b=0.15, c=0.15,
                      device=device)


def random_source(edges: EdgeList, rng: np.random.Generator) -> int:
    """A random root with at least one edge (Graph500 requirement)."""
    deg = edges.out_degrees().cpu().numpy()
    candidates = np.flatnonzero(deg > 0)
    return int(rng.choice(candidates))
