"""Fault-tolerant training loop, the JAX package's ``runtime/trainer.py``:
checkpoint and restart with step-indexed deterministic data, and
straggler monitoring.

``Trainer.run`` resumes at the latest published checkpoint (the data of
a step is a function of the step, ``data/pipeline.py``), saves every
``ckpt_every`` steps and at the end, and feeds each step's wall time to
the straggler monitor.  A step's time ends in
``torch.cuda.synchronize`` on the state's card, where the JAX loop
blocks on the state.  ``value_and_grad_step`` builds the step function
the launchers train with: the loss and its gradients by autograd, then
the optimizer's update.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.runtime.straggler import StragglerMonitor


def value_and_grad_step(loss_fn: Callable, opt) -> Callable:
    """``step_fn((params, opt_state), batch) -> ((params, opt_state),
    {"loss": loss})``: ``loss_fn(params, batch)`` and its gradient with
    respect to every tensor of the params dict, then
    ``opt.update(grads, opt_state, params)``."""
    def step_fn(state, batch):
        params, ost = state
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        params, ost = opt.update(dict(zip(p, grads)), ost, params)
        return (params, ost), {"loss": loss.detach()}
    return step_fn


def _sync(state: Any) -> None:
    leaves, _ = ckpt._flatten(state)
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


@dataclasses.dataclass
class Trainer:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    make_batch: Callable       # step -> batch
    ckpt_dir: str
    ckpt_every: int = 50
    meta: Optional[Dict] = None
    straggler: Optional[StragglerMonitor] = None

    def run(self, state: Any, n_steps: int, resume: bool = True):
        start = 0
        last = ckpt.latest_step(self.ckpt_dir) if resume else None
        if last is not None:
            state, _ = ckpt.restore(self.ckpt_dir, last, state,
                                    expect_meta=self.meta)
            start = last
        metrics_log = []
        for step in range(start, n_steps):
            batch = self.make_batch(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            _sync(state)
            dt = time.perf_counter() - t0
            if self.straggler is not None:
                self.straggler.observe(step, dt)
            metrics_log.append({k: float(v) for k, v in metrics.items()})
            nxt = step + 1
            if nxt % self.ckpt_every == 0 or nxt == n_steps:
                ckpt.save(self.ckpt_dir, nxt, state, meta=self.meta)
        return state, metrics_log
