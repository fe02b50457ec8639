"""Serving launcher: batched LM serving or recsys scoring on one card.
The JAX package's launcher, ``launch/serve.py``, with its defaults
(reduced dims; an MoE arch cut to 4 experts, top-2, ``d_ff_expert`` 32,
its ``swa_window`` kept) and its printed lines; ``--full`` serves the
registered width, and is refused before anything is allocated where the
config's parameters exceed the device's memory (mixtral-8x22b).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch autoint --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch autoint --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import resolve_device

# the JAX launcher's reduced dims
RECSYS_SMALL = dict(n_sparse=8, embed_dim=8, n_attn_layers=2, n_heads=2,
                    d_attn=8, vocab_sizes=tuple([100] * 8), mlp_hidden=(32,))
LM_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=512, d_head=16)
MOE_SMALL = dict(n_experts=4, top_k=2, d_ff_expert=32)
_BYTES = {"bfloat16": 2, "float32": 4}


def reduced_lm(cfg):
    """The launchers' reduced LM dims (``LM_SMALL``, and ``MOE_SMALL`` for
    an MoE arch)."""
    kw = dict(LM_SMALL)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, **MOE_SMALL)
    return reduced(cfg, **kw)


def device_bytes(dev: torch.device) -> int:
    """The memory of ``dev``: the card's, or the host's for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg, dev: torch.device) -> None:
    """Refuse an LM whose parameters alone exceed ``dev``'s memory,
    naming both sizes, before anything is allocated."""
    need = cfg.n_params() * _BYTES[cfg.dtype]
    have = device_bytes(dev)
    if need > have:
        raise SystemExit(
            f"{cfg.arch}: its {cfg.dtype} parameters take {need / 1e9:.1f} GB "
            f"and {dev} has {have / 1e9:.1f} GB; run it at the reduced dims "
            f"(without --full)")


def serve_recsys(cfg, device, batch: int = 32) -> float:
    """Score one batch of ``recsys_batch(cfg, batch, 0)``; returns the
    mean p(click)."""
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.models.autoint import AutoInt
    model = AutoInt(cfg, seed=0, device=device)
    idx = torch.from_numpy(recsys_batch(cfg, batch, 0)["idx"]).to(device)
    with torch.inference_mode():
        return float(torch.sigmoid(model(idx)).mean())


def make_lm_server(cfg, params, device, max_batch: int, max_len: int,
                   bucket: int):
    """A ``Server`` over ``prefill``/``decode_step`` with one KV cache of
    (max_batch, max_len), reset by each prefill's writes."""
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.server import Server
    cache = tf.init_kv_cache(cfg, max_batch, max_len, device=device)

    def prefill_fn(tokens):
        if tokens.shape[1] > max_len:
            raise ValueError(f"prompt bucket {tokens.shape[1]} > max_len "
                             f"{max_len}")
        return tf.prefill(params, tokens, cache, cfg)

    def decode_fn(c, tok, pos):
        if pos >= max_len:
            raise ValueError(f"position {pos} past max_len {max_len}")
        return tf.decode_step(params, c, tok, pos, cfg)
    return Server(prefill_fn, decode_fn, max_batch=max_batch, bucket=bucket,
                  device=str(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--full", action="store_true",
                    help="serve the registered width, not the reduced dims")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    dev = resolve_device(args.device)

    if cfg.kind == "recsys":
        if not args.full:
            cfg = reduced(cfg, **RECSYS_SMALL)
        p = serve_recsys(cfg, dev)
        print(f"scored batch of 32: mean p(click)={p:.3f}")
        return

    from repro_torch.models import transformer as tf
    from repro_torch.runtime.server import Request
    if args.full:
        check_fits(cfg, dev)
    else:
        cfg = reduced_lm(cfg)
    params = tf.init_params(cfg, seed=0, device=dev)
    server = make_lm_server(cfg, params, dev, max_batch=4, max_len=128,
                            bucket=32)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, rng.integers(4, 24))
                    .astype(np.int32), max_new_tokens=5)
            for _ in range(args.requests)]
    with torch.inference_mode():
        done = server.serve(reqs)
    for i, r in enumerate(done):
        print(f"req{i}: {len(r.prompt)} prompt toks -> {r.out.tolist()}")


if __name__ == "__main__":
    main()
