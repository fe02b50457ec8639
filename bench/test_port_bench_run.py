"""The whole command at a tiny scale on the CPU, through the port's plain
versions: every cell, a traced run, the exits without a card, without
the checkout's code and with JAX's name loaded, and what the reference
and the harness load."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench.tiny import REPO, make_root, result_of, run_command

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("port-bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(root, cell):
    proc = run_command(root, ["--workload", cell, "--seed", "4294967311",
                              "--seconds", "0.5", "--trace", "0",
                              "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result_of(proc)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["wrong_parents"] == {"value": 0, "limit": 0}
    assert {"teps", "setup_s"} <= set(res["metrics"])
    assert res["metrics"]["teps"]["unit"] == "edges/s"
    # the compared numbers close standard error
    tail = proc.stderr.strip().splitlines()[-3:]
    assert all(line.startswith("check ") for line in tail)


def test_traced_run_reports_per_layer_metrics(root):
    proc = run_command(root, ["--workload", "kron-s24-do", "--seed", "3",
                              "--seconds", "0.5", "--trace", "1",
                              "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = result_of(proc)
    assert res["correct"] is True
    # the set-up readers read on any device; the device readers find no
    # device operation on the CPU and read nothing
    assert set(res["metrics"]) == {"build_s", "compile_s"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(root):
    outs = [result_of(run_command(root, ["--workload", "kron-s24-batch16",
                                         "--seed", "77", "--seconds", "0",
                                         "--device", "cpu"]))
            for _ in range(2)]
    assert outs[0]["checks"] == outs[1]["checks"]
    assert outs[0]["attempted"] == outs[1]["attempted"] == 64


def test_no_card_no_result(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one passes")
    proc = run_command(root, ["--workload", "kron-s24-do", "--seed", "1",
                              "--seconds", "1"])
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    bare = make_root(tmp_path, link_src=False)
    proc = run_command(bare, ["--workload", "kron-s24-do", "--seed", "1",
                              "--seconds", "1", "--device", "cpu"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "repro"])
def test_jax_loaded_gives_no_result(root, name):
    pre = (f"import types; sys.modules[{name + '.sub'!r}] = "
           f"types.ModuleType({name + '.sub'!r})")
    proc = run_command(root, ["--workload", "kron-s24-do", "--seed", "1",
                              "--seconds", "0", "--device", "cpu"], pre=pre)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert f"['{name}']" in proc.stderr


def _top_level_modules(code: str) -> set:
    probe = (f"import sys; sys.path[0:0] = [{str(REPO)!r}, "
             f"{str(REPO / 'src')!r}]; {code}; "
             f"print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port():
    names = _top_level_modules("import bench.reference, bench.graphs, "
                               "bench.costs, bench.devtrace")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_harness_and_port_load_no_jax():
    names = _top_level_modules(
        "import bench.run, bench.control; "
        "import repro_torch.core.engine, repro_torch.graph.formats, "
        "repro_torch.graph.rmat, repro_torch.launch.mesh")
    assert "repro_torch" in names
    assert not names & {"repro", "jax", "jaxlib", "flax"}
