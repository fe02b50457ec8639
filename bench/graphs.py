"""The benchmark's inputs, made on the device from seeds.

A configuration file names its generator under ``"graph"``:

  kron   the Graph500 Kronecker (R-MAT) edge list: each edge's quadrant
         path is a pure function of (seed, edge, level) through a uint32
         hash (a frozen copy of the port's counter stream,
         ``graph/rmat.py::rmat_edges_counter_plain``), and the vertices
         are then relabelled by a seeded random permutation, as the
         Graph500 specification's kernel 0 requires.
  urand  the GAP suite's uniform random graph: both endpoints of every
         edge uniform over the vertices.

Both return the raw directed pairs ``(src, dst)`` as int32 tensors on the
device, self loops and duplicates included: what the system receives.
The graph and its search keys are one instance a configuration, drawn
from its ``"instance_seed"``: every run does the same work.  A run's
``--seed`` orders the calls' groups of keys and draws the calls that are
checked (``order``).  This module imports nothing of the system under test.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
CHUNK = 1 << 26          # edges generated at once (bounds the temporaries)


def sub_seeds(seed: int, k: int = 4) -> List[int]:
    """``k`` independent 32-bit seeds from one seed: the edge stream,
    the relabelling and the search keys from the instance's, the key
    order and the checked sample from the run's."""
    ss = np.random.SeedSequence(int(seed) & ((1 << 64) - 1))
    return [int(x) for x in ss.generate_state(k, dtype=np.uint32)]


def _mix(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x


def level_salt(seed: int, level: int) -> int:
    return _mix((int(seed) * 0x85EBCA6B + level * 0xC2B2AE35
                 + 0x27D4EB2F) & M32)


def thresholds(a: float, b: float, c: float) -> Tuple[int, int, int]:
    """Quadrant thresholds as uint32 comparands: u < t1 / t2 / t3 picks
    a / b / c, else d."""
    return tuple(min(int(round(p * 2.0 ** 32)), M32)
                 for p in (a, a + b, a + b + c))


def rmat_counter(scale: int, edge_factor: int, a: float, b: float,
                 c: float, seed: int, device, start: int = 0,
                 count: int | None = None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Edges [start, start + count) of the counter R-MAT stream of
    ``edge_factor << scale`` edges, unrelabelled, int32 on ``device``."""
    m = edge_factor << scale
    count = m - start if count is None else count
    t1, t2, t3 = thresholds(a, b, c)
    salts = [level_salt(seed, lv) for lv in range(scale)]
    src = torch.empty(count, dtype=torch.int32, device=device)
    dst = torch.empty(count, dtype=torch.int32, device=device)
    for lo in range(0, count, CHUNK):
        k = min(CHUNK, count - lo)
        idx = torch.arange(start + lo, start + lo + k, dtype=torch.int64,
                           device=device).bitwise_and_(M32)
        base = idx.mul_(GOLDEN).bitwise_and_(M32)
        s = torch.zeros(k, dtype=torch.int32, device=device)
        d = torch.zeros(k, dtype=torch.int32, device=device)
        for level, salt in enumerate(salts):
            x = base ^ salt
            x ^= x >> 16
            x.mul_(0x7FEB352D).bitwise_and_(M32)
            x ^= x >> 15
            x.mul_(0x846CA68B).bitwise_and_(M32)
            x ^= x >> 16
            s |= (x >= t2).to(torch.int32) << level
            d |= (((x >= t1) & (x < t2)) | (x >= t3)).to(torch.int32) \
                << level
            del x
        src[lo:lo + k] = s
        dst[lo:lo + k] = d
    return src, dst


def kron(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Graph500 kernel 0: the R-MAT stream, then every vertex relabelled
    by a random permutation of the ``2**scale`` ids (when
    ``cfg["relabel"]``)."""
    s_edges, s_perm = sub_seeds(seed)[:2]
    src, dst = rmat_counter(cfg["scale"], cfg["edge_factor"], cfg["a"],
                            cfg["b"], cfg["c"], s_edges, device)
    if cfg.get("relabel", True):
        g = torch.Generator(device=device).manual_seed(s_perm)
        perm = torch.randperm(1 << cfg["scale"], generator=g,
                              device=device).to(torch.int32)
        src = perm.index_select(0, src)
        dst = perm.index_select(0, dst)
    return src, dst


def urand(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAP's uniform random graph: ``edge_factor << scale`` pairs, each
    endpoint uniform over the ``2**scale`` vertices."""
    s_edges = sub_seeds(seed)[0]
    n, m = 1 << cfg["scale"], cfg["edge_factor"] << cfg["scale"]
    g = torch.Generator(device=device).manual_seed(s_edges)
    src = torch.randint(0, n, (m,), generator=g, device=device,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=g, device=device,
                        dtype=torch.int32)
    return src, dst


GENERATORS = {"kron": kron, "urand": urand}


def edges(cfg: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's raw edge list."""
    return GENERATORS[cfg["graph"]](cfg, cfg["instance_seed"], device)


def search_keys(src: torch.Tensor, dst: torch.Tensor, n: int, count: int,
                seed: int) -> List[int]:
    """``count`` distinct search keys drawn from ``seed`` (the instance's)
    among the vertices of degree >= 1 (an endpoint of an edge that is not
    a self loop), as Graph500 and GAP draw their 64 roots."""
    keep = src != dst
    touched = torch.zeros(n, dtype=torch.bool, device=src.device)
    touched[src[keep]] = True
    touched[dst[keep]] = True
    del keep
    cands = torch.nonzero(touched).reshape(-1).cpu()
    g = torch.Generator().manual_seed(sub_seeds(seed)[2])
    pick = torch.randperm(cands.shape[0], generator=g)[:count]
    return [int(v) for v in cands[pick]]


def order(items: list, seed: int) -> list:
    """``items`` (the keys, or the calls' groups of keys) in the order of
    the run's ``seed``."""
    g = torch.Generator().manual_seed(sub_seeds(seed)[2])
    return [items[i] for i in torch.randperm(len(items), generator=g)]
