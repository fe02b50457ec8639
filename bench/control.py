"""The control of ``correct``: the plain reference put in the port's
place with the stated guarantee broken (the greatest-id parent one level
up, not the least: still a valid Graph500 tree), run through the
harness's window and check at a cell's own size.  Every seed has to come
out not correct.

    python3 bench/control.py --workload kron-s24-do --seconds 3 --seeds 11 12 13

prints one line a seed: the seed, ``correct`` and the compared numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import reference  # noqa: E402
from bench.run import run_cell  # noqa: E402


class ControlProgram:
    """The reference in the program's place, under ``rule``."""

    rule = "max"

    def __init__(self, cfg: dict, traffic: dict, device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device

    def build(self, raw: list, n: int) -> int:
        src, dst = raw
        raw.clear()
        self.n, m_input = n, int(src.shape[0])
        self.src, self.dst = reference.build(src, dst)
        return m_input

    def compile(self) -> None:
        pass

    def warm_up(self, groups) -> None:
        pass

    def call(self, roots: List[int]) -> torch.Tensor:
        return torch.stack([reference.parents(self.n, self.src, self.dst, r,
                                              rule=self.rule)
                            for r in roots])

    def parents(self, out, n_roots: int) -> torch.Tensor:
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_times(self) -> Dict[str, float]:
        return {}

    def close(self) -> None:
        self.src = self.dst = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       args.device, program=ControlProgram)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
