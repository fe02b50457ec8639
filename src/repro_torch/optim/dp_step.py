"""Data-parallel training step with a compressed gradient all-reduce, the
JAX package's ``optim/dp_step.py`` on a simulated mesh.

Each replica along ``dp_axis`` takes the gradient of ``loss_fn`` on its
rows of the batch (the batch split evenly, replica-major), compresses
it ("topk": error-feedback top-k, its residual kept by the replica;
"int8": quantized and dequantized; "none": as is), a pmean over the axis
averages the replicas' payloads and the losses (``core/collectives.py::
pmean_axis``, recorded), and one optimizer update, the same on every
replica, is applied once.  The replicas run one after another on one
device.

The error-feedback residuals are the replicas' own: the JAX step
declares them replicated (``out_specs=P()`` with ``check_vma=False``)
while each device keeps its own, so a host read there gives replica
0's.  Here they are stacked, (replicas, ...) a leaf; ``[0]`` is what the
JAX package's host read shows.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.collectives import pmean_axis
from repro_torch.optim.grad_compress import (EFState, ef_init,
                                             int8_dequantize, int8_quantize,
                                             topk_compress, topk_decompress)

Tree = Dict[str, torch.Tensor]
MODES = ("none", "topk", "int8")


def _replicas(mesh, dp_axis: str) -> int:
    if dp_axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} lack {dp_axis!r}")
    return mesh.shape[dp_axis]


def make_dp_compressed_step(loss_fn: Callable, opt, mesh, dp_axis: str,
                            mode: str = "topk", ratio: float = 0.05):
    """loss_fn(params, batch) -> scalar.  Returns step((params, opt_state,
    ef_state), batch) -> (state, {"loss": mean loss}), each batch leaf
    split over the ``dp_axis`` replicas along its first dim."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = _replicas(mesh, dp_axis)
    axes = (dp_axis,)

    def pmean(xs):
        return pmean_axis(torch.stack(xs), axes, dp_axis)[0]

    def step(state, batch):
        params, opt_state, ef = state
        for name, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {name!r} of {v.shape[0]} rows does "
                                 f"not split over {n} replicas")
        losses, payloads, residuals = [], [], {k: [] for k in ef.residual}
        for i in range(n):
            part = {k: v.chunk(n)[i] for k, v in batch.items()}
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            loss = loss_fn(leaves, part)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(loss.detach())
            if mode == "topk":
                mine = EFState({k: r[i] for k, r in ef.residual.items()})
                vals, idxs, mine = topk_compress(grads, mine, ratio)
                grads = topk_decompress(vals, idxs, grads)
                for k in residuals:
                    residuals[k].append(mine.residual[k])
            elif mode == "int8":
                qs, ss = int8_quantize(grads)
                grads = int8_dequantize(qs, ss, grads)
            payloads.append(grads)
        synced = {k: pmean([g[k] for g in payloads]) for k in params}
        new_p, new_o = opt.update(synced, opt_state, params)
        if mode == "topk":
            ef = EFState({k: torch.stack(v) for k, v in residuals.items()})
        return (new_p, new_o, ef), {"loss": pmean(losses)}

    return step


def init_dp_state(params: Tree, opt, mesh, dp_axis: str = "data"
                  ) -> Tuple[Tree, object, EFState]:
    """(params, opt.init(params), residuals): zero float32 residuals,
    one a replica, stacked (replicas, ...)."""
    n = _replicas(mesh, dp_axis)
    ef = ef_init(params)
    return params, opt.init(params), EFState(
        {k: r.expand(n, *r.shape).clone() for k, r in ef.residual.items()})
