"""The traversal configuration of the PyTorch port.

``BFSConfig`` carries the same fields and defaults as the JAX package's,
so one config object describes a session in either package.  The port
runs ``instrument=True`` with ``compact_updates`` and ``use_edge_dst``
off, and

  * ``decomposition="2d"`` with ``fold_mode`` "reduce" or "alltoall"
    and ``expand_chunks=1``;
  * ``decomposition`` "1d" and "1ds" with either ``frontier_codec``
    ("none", "packed") and any ``expand_chunks >= 1`` that divides the
    strip's packed words (and, for "1ds", the bucket capacity).

``core.engine.plan_bfs`` rejects the rest by name until a later slice
ports it, as it rejects the local format ``("1d"|"1ds", "kernel",
"csr")``, which needs the ``(p, n+1)`` strip ``col_ptr``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class BFSShape:
    name: str
    scale: int           # 2**scale vertices (Graph500 convention)
    degree: int = 16
    n_roots: int = 1     # batched roots (pod axis)
    kind: str = "bfs"


BFS_SHAPES: Tuple[BFSShape, ...] = (
    BFSShape("scale22", 22),
    BFSShape("scale26", 26),
    BFSShape("scale30", 30),
)


@dataclass(frozen=True)
class BFSConfig:
    arch: str = "bfs-rmat"
    # "2d" checkerboard | "1d" row strips | "1ds" sparse-exchange strips
    decomposition: str = "2d"
    storage: str = "csr"          # "csr" | "dcsc"
    # fold: "alltoall" (paper-faithful) | "reduce" (ring reduce-scatter)
    # | "bitmap"/"bitmap_pure" (compact fold)
    fold_mode: str = "reduce"
    alpha: float = 14.0           # top-down -> bottom-up switch (Beamer)
    beta: float = 24.0            # bottom-up -> top-down switch
    direction_optimizing: bool = True
    # True: counters and level_stats are computed every level
    instrument: bool = True
    use_edge_dst: bool = False    # bottom-up O(E) row read (no searchsorted)
    compact_updates: bool = False  # bottom-up compact (child,parent) sends
    frontier_codec: str = "packed"  # "1ds" bucket encoding
    expand_chunks: int = 1        # software-pipelined expand
    rmat_a: float = 0.57
    rmat_b: float = 0.19
    rmat_c: float = 0.19
    shapes: Tuple[BFSShape, ...] = BFS_SHAPES

    @property
    def kind(self) -> str:
        return "bfs"
