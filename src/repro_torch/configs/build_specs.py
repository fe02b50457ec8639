"""Named distributed-build points (Graph500 R-MAT parameter pins), the
JAX package's ``configs/build_specs.py``.

The traversal configs in ``bfs_rmat.py`` say HOW to search; these say
WHICH graph to born-shard with ``graph/dist_build.py``.  Pinning (scale,
edge_factor, seed, a/b/c) under a name keeps runs and store entries
talking about byte-identical graphs: a ``GraphStore`` load validated with
``expect_spec=get_build_spec(name)`` can never traverse a different
workload.
"""
from repro_torch.graph.dist_build import BuildSpec

BUILD_SPECS = {
    # tiny parity/smoke point (matches the host-parity test pin)
    "g500-s10": BuildSpec(scale=10, edge_factor=16, seed=3),
    # bench trajectory pin: disk->first-traversal vs rebuild+recompile
    "g500-s14": BuildSpec(scale=14, edge_factor=16, seed=1),
    # the build-then-load lane (16 simulated devices)
    "g500-s16": BuildSpec(scale=16, edge_factor=16, seed=1),
    # the "no host-side edge materialization" acceptance point
    "g500-s18": BuildSpec(scale=18, edge_factor=16, seed=1),
    # headroom pins for larger meshes
    "g500-s20": BuildSpec(scale=20, edge_factor=16, seed=1),
    "g500-s22": BuildSpec(scale=22, edge_factor=16, seed=1),
}


def get_build_spec(name: str) -> BuildSpec:
    try:
        return BUILD_SPECS[name]
    except KeyError:
        raise KeyError(f"unknown build spec {name!r}; registered: "
                       f"{sorted(BUILD_SPECS)}") from None


def store_name(name: str, decomposition: str) -> str:
    """Canonical GraphStore graph name for a (spec, decomposition) pair
    ("1d" and "1ds" share the strip format and therefore the entry)."""
    fmt = "1d" if decomposition in ("1d", "1ds") else "2d"
    return f"{name}-{fmt}"
