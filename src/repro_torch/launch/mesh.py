"""The simulated mesh: a (pr, pc) processor grid on one device.

The JAX package runs its 2D checkerboard on a real (pr, pc) device mesh
and its 1D strips on a single axis of p devices.  The port runs both on
one card: every per-processor array carries the grid as its leading
dims, exactly as ``BlockedGraph`` ((pr, pc, ...)) and ``Blocked1DGraph``
((p, ...)) store their blocks, and each collective is a tensor op over
those dims (``core/collectives.py``, ``core/steps_1d.py``).  A
``SimMesh`` only says how large the grid is and which device holds it;
a p-strip mesh is the grid (p, 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

PRODUCTION_GRID = (16, 16)   # the JAX package's single-pod mesh
PRODUCTION_PODS = 2          # and its multi-pod one, 2 x 16 x 16


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card raises
    (nothing carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions")
    return dev


@dataclass(frozen=True)
class SimMesh:
    pr: int              # processor rows (the expand/gather axis)
    pc: int              # processor cols (the fold and rotation axis)
    device: torch.device
    pods: Optional[int] = None   # the "pod" axis of batched roots, if any
    names: Tuple[str, ...] = ("data", "model")   # the grid's axis names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the JAX package's ``Mesh.shape``: "pod"
        (only with ``pods``), then "data" and, on a 2D grid, "model"."""
        pod = {} if self.pods is None else {"pod": self.pods}
        return {**pod, **dict(zip(self.names, (self.pr, self.pc)))}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """The processors of the whole mesh (pods included)."""
        return (self.pods or 1) * self.pr * self.pc


def _check_pods(pods: Optional[int]) -> None:
    if pods is not None and pods < 1:
        raise ValueError(f"pods={pods} must be >= 1 (or None for no pod "
                         f"axis)")


def make_local_mesh(pr: int = 1, pc: int = 1, device="cuda",
                    pods: Optional[int] = None) -> SimMesh:
    if pr < 1 or pc < 1:
        raise ValueError(f"grid {pr}x{pc} must have positive sides")
    _check_pods(pods)
    return SimMesh(pr=pr, pc=pc, device=resolve_device(device), pods=pods)


def make_local_mesh_1d(p: int, device="cuda",
                       pods: Optional[int] = None) -> SimMesh:
    """The p-strip mesh of the 1D decompositions: grid (p, 1), the
    counterpart of the JAX package's single "data" axis of size p."""
    if p < 1:
        raise ValueError(f"{p} strips must be positive")
    _check_pods(pods)
    return SimMesh(pr=p, pc=1, device=resolve_device(device), pods=pods,
                   names=("data",))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> SimMesh:
    """The JAX package's production meshes as simulated ones: 16 x 16 on
    ("data", "model"), and with ``multi_pod`` 2 x 16 x 16 with "pod" in
    front, on any device (the dry-run's is ``meta``)."""
    return make_mesh(*PRODUCTION_GRID,
                     pods=PRODUCTION_PODS if multi_pod else 1, device=device)


def make_mesh(pr: int, pc: int, pods: int = 1, device="cuda") -> SimMesh:
    """An arbitrary rectangular grid (the paper's generalization); a
    "pod" axis in front where ``pods > 1``."""
    return make_local_mesh(pr, pc, device=device,
                           pods=pods if pods > 1 else None)


def make_generator(device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for draws on ``device``.  The meta
    device has none of its own, so its draws take a CPU generator (they
    produce shapes only)."""
    dev = torch.device(device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)
