"""Batched LM serving: dynamic batching with prefill and decode over a
KV cache, the JAX package's ``examples/serve_lm.py`` on one card (the
same reduced smollm-135m dims, six requests; the weights come from a
seed, so the tokens differ from the JAX run's).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.serve import make_lm_server
from repro_torch.models import transformer as tf
from repro_torch.runtime.server import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config("smollm-135m"), n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, d_head=16)
    params = tf.init_params(cfg, seed=0, device=dev)
    server = make_lm_server(cfg, params, dev, max_batch=4, max_len=128,
                            bucket=32)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 20))
                    .astype(np.int32), max_new_tokens=6) for _ in range(6)]
    with torch.inference_mode():
        done = server.serve(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: prompt_len={len(r.prompt)} -> out={r.out.tolist()}")
    if not all(r.out is not None and len(r.out) == 6 for r in done):
        raise SystemExit("a request did not get its 6 tokens")
    print("served", len(done), "requests (batched prefill+decode)")


if __name__ == "__main__":
    main()
