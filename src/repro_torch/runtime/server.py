"""Batched serving runtime: dynamic request batching over a prefill and
decode step pair, the same batching, left padding, bucket rounding and
greedy decoding as the JAX package's ``runtime/server.py``.

Requests are served ``max_batch`` at a time: their prompts are
left-padded (token 0) to a shared length rounded up to ``bucket`` in a
(max_batch, S) batch, prefilled once, then decoded greedily until every
request has its token budget.  Synchronous, one process."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int = 8
    out: Optional[np.ndarray] = None


@dataclasses.dataclass
class Server:
    prefill_fn: Callable          # (tokens (B, S)) -> (cache, logits)
    decode_fn: Callable           # (cache, tok (B, 1), pos) -> (cache, logits)
    max_batch: int = 8
    bucket: int = 64
    device: str = "cuda"

    def serve(self, requests: Sequence[Request]) -> List[Request]:
        reqs = list(requests)
        for i in range(0, len(reqs), self.max_batch):
            self._serve_batch(reqs[i:i + self.max_batch])
        return reqs

    def _serve_batch(self, batch: List[Request]) -> None:
        lens = [len(r.prompt) for r in batch]
        s = self.bucket * ((max(lens) + self.bucket - 1) // self.bucket)
        toks = np.zeros((self.max_batch, s), np.int32)
        for i, r in enumerate(batch):
            toks[i, s - lens[i]:] = r.prompt       # left-pad to align ends
        cache, logits = self.prefill_fn(torch.from_numpy(toks).to(
            self.device))
        n_new = max(r.max_new_tokens for r in batch)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        outs = []
        pos = s
        for _ in range(n_new):
            outs.append(tok[:len(batch), 0].cpu())
            cache, logits = self.decode_fn(cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos += 1
        gen = torch.stack(outs, 1).numpy() if outs else np.zeros(
            (len(batch), 0), np.int32)
        for i, r in enumerate(batch):
            r.out = gen[i, : r.max_new_tokens].astype(np.int32)
