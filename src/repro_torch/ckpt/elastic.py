"""Elastic re-scaling of a graph: re-partition it onto another (pr, pc)
grid, the JAX package's ``ckpt/elastic.py::repartition_graph``.

Graphs must be structurally re-blocked: the paper's data layout depends
on the grid.  (The JAX package's ``reshard_state``, which places a
training state on a new mesh, waits for the port's ``torch.distributed``
backend.)
"""
from __future__ import annotations

from repro_torch.graph.dist_build import dist_build
from repro_torch.graph.formats import BlockedGraph, build_blocked
from repro_torch.graph.rmat import EdgeList


def repartition_graph(edges: "EdgeList | None" = None, pr: int = 1,
                      pc: int = 1, align: int = 128, cap_pad: int = 128,
                      *, spec=None, mesh=None, decomposition: str = "2d",
                      **build_kw) -> BlockedGraph:
    """Re-block a graph for a new (pr, pc) grid, when a pod joins or
    leaves mid-campaign (BFS state is cheap to rebuild: one search).

    Two sources:

    * an ``EdgeList``: ``build_blocked`` on its edges, on their device;
    * a ``dist_build.BuildSpec`` (``spec=``) with ``mesh=`` sized for the
      new grid: ``dist_build`` rebuilds the graph from the counter stream
      straight onto the new blocking on the mesh's device; no edge list
      exists.  ``decomposition`` picks the target format ("2d"
      checkerboard, "1d"/"1ds" strips on pr*pc shards) and ``build_kw``
      (route_slack, max_attempts, ...) goes to ``dist_build``.  The
      result equals a host re-block of the same stream at the same
      align/cap_pad.
    """
    if spec is not None:
        if mesh is None:
            raise ValueError(
                "repartition_graph(spec=...) needs mesh= sized for the "
                "new grid (BuildSpec repartitioning is device-side)")
        graph, _ = dist_build(spec, decomposition, mesh, (pr, pc),
                              align=align, cap_pad=cap_pad, **build_kw)
        return graph
    if edges is None:
        raise ValueError("repartition_graph needs an EdgeList or a "
                         "BuildSpec (spec=...)")
    return build_blocked(edges, pr, pc, align=align, cap_pad=cap_pad)
