"""A tiny copy of the benchmark for the CPU tests: ``bench/`` and
``BENCHMARK.json`` copied into a directory, every configuration cut to
``scale`` (data only: the harness's code is the checkout's), and
``src`` linked in so that the copy runs the checkout's port."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
SCALE = 9
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


def make_root(where: Path, scale: int = SCALE, traffic: Optional[Dict] = None,
              link_src: bool = True) -> Path:
    """The copy under ``where``; ``traffic`` overrides fields of every
    traffic mix (say fewer keys)."""
    root = where / "bench-root"
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        _edit(root / conf["file"], {"scale": scale})
    for path in (root / "bench" / "traffic").glob("*.json"):
        _edit(path, traffic or {})
    if link_src:
        os.symlink(REPO / "src", root / "src")
    return root


def _edit(path: Path, fields: Dict) -> None:
    data = json.loads(path.read_text())
    data.update(fields)
    path.write_text(json.dumps(data, indent=2))


def run_command(root: Path, args: List[str], timeout: float = 240,
                extra_env: Optional[Dict] = None,
                pre: str = "") -> subprocess.CompletedProcess:
    """``python bench/run.py ARGS`` from ``root``, on one thread, with no
    PYTHONPATH (the script finds its own packages); ``pre`` is Python to
    run first, in the same process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ONE_THREAD_ENV, **(extra_env or {}))
    if pre:
        code = (f"import runpy, sys; {pre}; sys.argv = ['bench/run.py'] + "
                f"{args!r}; runpy.run_path('bench/run.py', "
                f"run_name='__main__')")
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable, "bench/run.py", *args]
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def result_of(proc: subprocess.CompletedProcess) -> dict:
    """The last line of standard output, as JSON."""
    return json.loads(proc.stdout.strip().splitlines()[-1])
