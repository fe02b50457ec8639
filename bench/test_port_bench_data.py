"""A cell, a configuration, a traffic mix and a metric are added as files
and entries, with no edit to a file that is there: the harness finds
each by its name."""
from __future__ import annotations

import json

from bench.tiny import make_root, result_of, run_command

READER = '''"""calls_done: the calls the window completed."""


def read(run):
    return len(run.times)
'''


def test_added_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    kron = json.loads((root / "bench/configs/g500-kron-s24.json").read_text())
    kron.update(name="g500-kron-skew", a=0.65, b=0.15, c=0.15)
    (root / "bench/configs/g500-kron-skew.json").write_text(json.dumps(kron))
    mix = json.loads((root / "bench/traffic/do-single.json").read_text())
    mix.update(name="do-single-k8", keys=8, checked_calls=2)
    (root / "bench/traffic/do-single-k8.json").write_text(json.dumps(mix))
    (root / "bench/metrics/calls_done.py").write_text(READER)

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "g500-kron-skew", "source": "test",
                             "file": "bench/configs/g500-kron-skew.json",
                             "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "kron-skew-k8",
                               "config": "g500-kron-skew",
                               "traffic": "do-single-k8", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["kron-skew-k8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = run_command(root, ["--workload", "kron-skew-k8", "--seed", "8",
                              "--seconds", "0", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result_of(proc)
    assert res["correct"] is True
    assert res["attempted"] == 8           # one cycle of the 8 keys
    assert res["metrics"]["calls_done"] == {"value": 8, "unit": "calls"}
    # the files that were there are as they were
    assert all(p.read_bytes() == b for p, b in before.items())

    proc = run_command(root, ["--workload", "kron-s24-do", "--seed", "8",
                              "--seconds", "0", "--device", "cpu"])
    assert "calls_done" not in result_of(proc)["metrics"]
