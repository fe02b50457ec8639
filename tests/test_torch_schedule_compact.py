"""The 2D schedule variant "compact_updates" (compact runtime updates with
their dense fallback) against the JAX package's dense sessions in a
subprocess of its own (``_torch_dist_schedule_main.py
compact_updates``): parents, levels, stats and counters equal,
instrumented and not, dense and kernel. The four variants sit in four
files so that ``--dist loadfile`` spreads them over workers (see
``test_torch_schedule.py`` for the recorded schedule)."""
import os
import subprocess
import sys

import pytest
from _torch_threads import ONE_THREAD_ENV

_HERE = os.path.dirname(__file__)


@pytest.mark.parametrize("variant", ["compact_updates"])
def test_variants_match_reference_parents_in_subprocess(variant):
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable,
                          os.path.join(_HERE, "_torch_dist_schedule_main.py"),
                          variant],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert f"OK torch-dist-schedule {variant} " in out.stdout
