"""Host data: deterministic, step-indexed synthetic batches, numpy only,
bit-identical to the JAX package's ``data/pipeline.py`` (each batch
draws from ``numpy.random.default_rng((seed, step))``, so a restart at
a step yields the same batch), and the background prefetcher that moves
them to the card."""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np
import torch

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


class DevicePrefetcher:
    """Background prefetch through a bounded queue of ``depth`` batches:
    overlaps host batch synthesis and the host-to-device copy with the
    previous step's compute (the JAX package's ``device_put`` thread).

    On a CUDA ``device`` each array of a batch is pinned and copied with
    ``non_blocking`` on a side stream; the consumer's stream waits on
    that copy's event before it gets the batch.  With ``device`` None or
    "cpu" the batches are only queued, as they come."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self._it = it
        self._dev = None if device is None else torch.device(device)
        if self._dev is not None and self._dev.type == "cuda":
            self._stream = torch.cuda.Stream(self._dev)
        else:
            self._stream = None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _to_device(self, batch: Dict[str, np.ndarray]):
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self._dev, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        # the end of the stream, or its error, reaches the consumer as
        # the last item, so a consumer never waits on a dead thread
        try:
            for batch in self._it:
                item = (self._to_device(batch) if self._stream is not None
                        else (batch, None))
                if not self._put(item):
                    return
            self._put((None, StopIteration()))
        except Exception as e:       # re-raised in the consumer
            self._put((None, e))

    def __iter__(self):
        return self

    def __next__(self):
        batch, done = self._q.get()
        if batch is None:
            raise done
        if done is not None:
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(done)
            for t in batch.values():
                t.record_stream(cur)    # freed only after the consumer's use
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)
