"""The paper's own workload: direction-optimizing BFS on Graph500 R-MAT,
every arch of the JAX package's ``configs/bfs_rmat.py`` field for field.

Run an arch with ``plan_bfs(graph, get_config(arch), mesh,
local_mode="kernel")`` on a ``build_blocked`` graph ("2d") or a
``build_blocked_1d`` one ("1d", "1ds"; ``with_col_ptr=True`` for a
"csr" arch in kernel mode); ``bfs-rmat-multiroot`` with
``BFSEngine.run_batch`` on a mesh with pods (``make_local_mesh(...,
pods=k)``)."""
import dataclasses

from repro_torch.configs.base import BFSConfig, register

CONFIG = register(BFSConfig(arch="bfs-rmat", storage="dcsc"))
CONFIG_CSR = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-csr", storage="csr", fold_mode="alltoall"))
CONFIG_TOPDOWN = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-topdown", direction_optimizing=False))

# beyond the paper: i1 the bitmap fold, i2 + rows read from edge_dst, opt
# + compact parent updates.  The *_pure folds drop what passes their
# capacities (their trees need not validate); bfs-rmat-opt-rt keeps the
# dense fallbacks and stays exact
CONFIG_I1 = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-i1", fold_mode="bitmap_pure"))
CONFIG_I2 = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-i2", fold_mode="bitmap_pure", use_edge_dst=True))
CONFIG_OPT = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-opt", fold_mode="bitmap_pure", use_edge_dst=True,
    compact_updates=True))
CONFIG_OPT_RT = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-opt-rt", fold_mode="bitmap", use_edge_dst=True,
    compact_updates=True))
# batched roots spread over the pod axis (the multi-pod Graph500 pattern)
CONFIG_MULTIROOT = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-multiroot"))

# the 1D row strips, the paper's comparison axis: dense bitmap expand
# ("1d"), strip DCSC, and the sparse owner-directed exchange ("1ds")
CONFIG_1D = register(BFSConfig(arch="bfs-rmat-1d", decomposition="1d"))
CONFIG_1D_TOPDOWN = register(dataclasses.replace(
    CONFIG_1D, arch="bfs-rmat-1d-topdown", direction_optimizing=False))
CONFIG_1D_DCSC = register(dataclasses.replace(
    CONFIG_1D, arch="bfs-rmat-1d-dcsc", storage="dcsc"))
CONFIG_1DS = register(dataclasses.replace(
    CONFIG_1D, arch="bfs-rmat-1ds", decomposition="1ds"))
CONFIG_1DS_RAW = register(dataclasses.replace(
    CONFIG_1DS, arch="bfs-rmat-1ds-raw", frontier_codec="none"))

# instrument=False: no counters or level stats, one host read a level
CONFIG_FAST = register(dataclasses.replace(
    CONFIG, arch="bfs-rmat-fast", instrument=False))
CONFIG_1DS_FAST = register(dataclasses.replace(
    CONFIG_1DS, arch="bfs-rmat-1ds-fast", instrument=False))

# expand_chunks > 1: the 1d/1ds top-down expand in sub-chunks, the 2d
# bottom-up R/G split ring; parents equal expand_chunks=1's
CONFIG_PIPE = register(dataclasses.replace(
    CONFIG_FAST, arch="bfs-rmat-pipe", expand_chunks=2))
CONFIG_1D_PIPE = register(dataclasses.replace(
    CONFIG_1D, arch="bfs-rmat-1d-pipe", instrument=False, expand_chunks=2))
CONFIG_1DS_PIPE = register(dataclasses.replace(
    CONFIG_1DS_FAST, arch="bfs-rmat-1ds-pipe", expand_chunks=4))
