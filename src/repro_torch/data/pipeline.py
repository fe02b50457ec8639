"""Host data: deterministic, step-indexed synthetic batches, numpy only,
bit-identical to the JAX package's ``data/pipeline.py`` (each batch
draws from ``numpy.random.default_rng((seed, step))``, so a restart at
a step yields the same batch).  The device prefetcher comes with the
training slice."""
from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterator

import numpy as np

from repro_torch.configs.base import LMConfig, RecsysConfig


def lm_batch(cfg: LMConfig, batch: int, seq: int, step: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Zipf-ish synthetic token stream (deterministic per step)."""
    rng = np.random.default_rng((seed, step))
    z = rng.zipf(1.3, size=(batch, seq + 1))
    toks = (z % cfg.vocab).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(cfg: RecsysConfig, batch: int, step: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """(batch, n_sparse) int32 per-field ids and (batch,) click labels."""
    rng = np.random.default_rng((seed, step))
    cols = [rng.integers(0, v, batch) for v in cfg.vocab_sizes]
    idx = np.stack(cols, 1).astype(np.int32)
    w = rng.normal(size=(cfg.n_sparse,))
    logit = (idx % 7 - 3) @ w / cfg.n_sparse
    labels = (logit + rng.normal(size=batch) * 0.5 > 0).astype(np.float32)
    return {"idx": idx, "labels": labels}


def step_stream(make: Callable[[int], Dict[str, np.ndarray]],
                start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    for step in itertools.count(start_step):
        yield make(step)
