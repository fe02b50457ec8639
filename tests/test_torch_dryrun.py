"""The port's dry-run CLI (``launch/dryrun.py``) and report
(``launch/report.py``) on one cell of each family, single-pod, into a
temporary results directory (the JAX package's ``results/dryrun/``,
which ``tests/test_dryrun_artifacts.py`` reads, stays absent).

Pinned deviations from the JAX package's records:
  * the LM, GNN and recsys cells issue no collective on the simulated
    mesh (GSPMD's exchanges have no counterpart), so their collective
    term is 0;
  * the whole-search BFS record's counts are one top-down plus one
    bottom-up body, its level step's (the search's level loop reads the
    host and cannot be traced on ``meta``);
  * the counts cover every layer: the report corrects no scan."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import report
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = ("smollm-135m/prefill_32k", "autoint/serve_p99",
         "gin-tu/full_graph_sm", "bfs-rmat/scale22")
TAGS = [c.replace("/", "__") + "__sp" for c in CELLS]


def _cli(results):
    env = {**os.environ, **ONE_THREAD_ENV, "PYTHONPATH": _SRC}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--cells", ",".join(CELLS), "--mesh", "single",
                        "--results", str(results), "--jobs", "2"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_torch")
    first = _cli(d)
    second = _cli(d)
    recs = {t: json.loads((d / f"{t}.json").read_text()) for t in TAGS}
    return d, first, second, recs


def test_cli_writes_a_record_a_cell_and_resumes(records):
    _, first, second, recs = records
    assert "DRY-RUN COMPLETE" in first
    for tag in TAGS:
        assert f"[ok] {tag}" in first
        assert f"[cached] {tag}" in second
    assert "[ok]" not in second


@pytest.mark.parametrize("tag", TAGS)
def test_records_carry_the_reference_keys(records, tag):
    rec = records[3][tag]
    for key in ("cell", "mesh", "n_devices", "memory", "flops",
                "bytes_accessed", "collectives", "meta", "roofline",
                "trace_s"):
        assert key in rec, key
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["flops"] > 0 or rec["meta"]["family"] == "bfs"
    assert rec["bytes_accessed"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] >= 0
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    assert set(rec["flops_by_class"]) == {"bf16", "fp32"}


@pytest.mark.parametrize("tag", TAGS[:3])
def test_nn_cells_issue_no_collective(records, tag):
    rec = records[3][tag]
    assert rec["collectives"] == {"total_bytes": 0.0, "inloop_bytes": 0.0}
    assert rec["roofline"]["collective_s"] == 0.0


def test_kernels_are_counted_by_their_formulas(records):
    recs = records[3]
    assert recs["smollm-135m__prefill_32k__sp"]["kernels"][
        "flash_attention"]["calls"] == 30
    assert recs["autoint__serve_p99__sp"]["kernels"]["embedding_bag"][
        "calls"] == 1


def test_bfs_whole_search_counts_its_level_body(records):
    rec = records[3]["bfs-rmat__scale22__sp"]
    lvl = rec["level_step"]
    assert lvl["cell"] == "bfs-rmat/scale22/level"
    assert lvl["collectives"]["total_bytes"] > 0
    for key in ("flops", "bytes_accessed", "collectives", "flops_by_class"):
        assert rec[key] == lvl[key], key
    # the graph specs and a root, against the graph, pi and the frontier
    assert rec["memory"]["argument_size_in_bytes"] < \
        lvl["memory"]["argument_size_in_bytes"]
    kinds = {k for k in lvl["collectives"] if k.startswith("count_")}
    assert kinds == {"count_collective-permute", "count_all-gather",
                     "count_all-to-all"}


def test_report_renders_both_tables_without_scan_correction(records,
                                                            capsys):
    d, _, _, recs = records
    assert report.main(["--results", str(d)]) == 0
    out = capsys.readouterr().out
    assert "## Dry-run (4 traced cells, 0 documented skips)" in out
    assert "## Roofline" in out
    for tag in TAGS:
        assert f"| {recs[tag]['cell']} | 16x16 |" in out
        assert f"| {recs[tag]['cell']} | " in out.split("## Roofline")[1]
    lm = recs["smollm-135m__prefill_32k__sp"]
    t = report.corrected_terms(lm)
    for key in ("compute_s", "memory_s", "collective_s"):
        assert t[key] == pytest.approx(lm["roofline"][key])
    assert report.corrected_terms({"skipped": True}) is None
