"""End-to-end LM training driver: any registered LM ``--arch``, the
fault-tolerant loop with checkpoint and resume, a synthetic token
stream; the JAX package's ``examples/train_lm.py`` on one card, with its
reduced dims by default (``--full`` for the registered width) and its
printed line.  The loss must fall.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        --d-model 128 --layers 4
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train import lm_setup
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model,
                      d_ff=args.d_model * 4, vocab=2048, d_head=32,
                      n_heads=4, n_kv_heads=2)
    opt = AdamW(lr=1e-3, total_steps=max(args.steps, 100),
                warmup_steps=min(5, args.steps), schedule="constant")
    state, step_fn, make_batch = lm_setup(cfg, dev, args.batch, args.seq,
                                          opt,
                                          seq_chunk=min(args.seq, 512))
    mon = StragglerMonitor()
    trainer = Trainer(step_fn=step_fn, make_batch=make_batch,
                      ckpt_dir=args.ckpt_dir, ckpt_every=10,
                      meta={"arch": cfg.arch}, straggler=mon)
    state, log = trainer.run(state, args.steps)
    losses = [m["loss"] for m in log]
    print(f"trained {len(log)} steps; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; stragglers detected: {len(mon.events)}")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss must decrease")


if __name__ == "__main__":
    main()
