"""The port's collective-schedule linter (``repro_torch.analysis``): the
broken 2D fixture is flagged by R1 naming the permute and the unsynced
decision, in both instrument modes, and lints clean without a pod axis;
the registry stays as it was around the fixture; ``BFSPlan.lint()``
returns findings with the JAX package's JSON fields; synthetic entries
that gather over the pod axis or under-declare their rendezvous trip
R3; the CLI as a user runs it, on the CPU.

The reference's own R1-R3 do not run on the JAX installed here
(``repro/analysis/uniformity.py`` raises ``KeyError: 'in_names'``), so
these hold the port to what the reference's ``test_analysis_lint.py``
asserts."""
import dataclasses
import json
import os
import subprocess
import sys
from contextlib import contextmanager

import pytest
import torch

from repro_torch.analysis import registry
from repro_torch.analysis.fixtures import (FIXTURE_NAME, divergent_2d_fixture,
                                           lint_fixture)
from repro_torch.configs.base import BFSConfig
from repro_torch.core import collectives, decomp, local_ops
from repro_torch.core.engine import plan_bfs, plan_for_part
from repro_torch.core.frontier import pack_bits
from repro_torch.core.partition import make_partition
from repro_torch.core.steps_1d import bottomup_level_1d, topdown_level_1d
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import rmat_graph
from repro_torch.launch.mesh import make_local_mesh
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _graph_1x1():
    e = rmat_graph(8, edge_factor=8, seed=4, device="cpu")
    return e, build_blocked(e, 1, 1, align=32, cap_pad=32)


@contextmanager
def _scoped_entry(base: str, name: str, **changes):
    """Register a copy of entry ``base`` (and its dense LocalOps) under
    ``name`` for the with-block."""
    entry = dataclasses.replace(decomp.get_decomposition(base), name=name,
                                **changes)
    decomp.register_decomposition(entry)
    keys = [(d, lm, st) for d, lm, st in local_ops.registered_combos()
            if d == base and lm == "dense"]
    for d, lm, st in keys:
        local_ops.register_local_ops(dataclasses.replace(
            local_ops.get_local_ops(d, lm, st), decomposition=name))
    try:
        yield entry
    finally:
        for _, lm, st in keys:
            local_ops.unregister_local_ops(name, lm, st)
        decomp.unregister_decomposition(name)


def test_fixture_registration_is_scoped():
    assert decomp.registered_decompositions() == ("1d", "1ds", "2d")
    with divergent_2d_fixture() as entry:
        assert FIXTURE_NAME in decomp.registered_decompositions()
        assert decomp.get_decomposition(FIXTURE_NAME) is entry
        assert any(d == FIXTURE_NAME
                   for d, _, _ in local_ops.registered_combos())
    assert decomp.registered_decompositions() == ("1d", "1ds", "2d")
    assert not any(d == FIXTURE_NAME
                   for d, _, _ in local_ops.registered_combos())


@pytest.mark.parametrize("instrument", (False, True))
def test_r1_flags_the_fixture_permute_on_a_pod_mesh(instrument):
    findings = lint_fixture(instrument, device="cpu")
    r1 = [f for f in findings if f.rule == "R1"
          and f.detail["collective"] == "ppermute"]
    assert r1, findings
    d = r1[0].detail
    assert d["divergent_axes"] == ["pod"]
    assert "pod" in d["rendezvous_axes"]
    assert "psum" in d["predicate"]          # the per-pod decision
    assert d["predicate_uniform_over"] == ["data", "model"]
    assert d["hlo_kind"] == "collective-permute"
    assert "ppermute" in r1[0].message and "deadlock" in r1[0].message
    # the transpose and the rotation (or ring fold) permutes, both bodies
    assert {f.detail["path"].split()[0] for f in r1} == {"td", "bu"}
    assert any(f.rule == "R2" for f in findings)
    assert decomp.registered_decompositions() == ("1d", "1ds", "2d")


def test_fixture_clean_without_pod_axis():
    """R1 keys on the mesh: without a pod axis the per-pod decision is
    uniform over the whole mesh."""
    _, g = _graph_1x1()
    with divergent_2d_fixture():
        plan = plan_bfs(g, BFSConfig(decomposition=FIXTURE_NAME),
                        make_local_mesh(1, 1, device="cpu"))
        assert plan.lint() == []


def test_plan_lint_returns_structured_findings():
    from repro.analysis.rules import Finding as RFinding
    e, g = _graph_1x1()
    plan = plan_bfs(g, BFSConfig(decomposition="2d"),
                    make_local_mesh(1, 1, device="cpu"))
    assert plan.lint() == []
    with divergent_2d_fixture():
        pods = plan_bfs(g, BFSConfig(decomposition=FIXTURE_NAME),
                        make_local_mesh(1, 1, device="cpu", pods=2))
        findings = pods.lint()          # the mesh's "pod" axis by default
    assert findings
    want = [f.name for f in dataclasses.fields(RFinding)]
    for f in findings:
        assert list(f.to_json()) == want == ["rule", "combo", "message",
                                             "detail"]
        json.dumps(f.to_json())
    bare = plan_for_part(make_partition(e.n, 1, 1, align=32),
                         BFSConfig(decomposition="2d"),
                         make_local_mesh(1, 1, device="cpu"), cap_seg=32)
    with pytest.raises(ValueError, match="graph"):
        bare.lint()


@pytest.mark.parametrize("decomposition", ("2d", "1d", "1ds"))
def test_registered_entries_lint_clean_on_pods(decomposition):
    """The 2D decision is synced over the pods (recorded); the strips
    switch per pod over strip-local collectives."""
    plan = registry.plan_case(decomposition, {}, instrument=False,
                              batched=True, device="cpu")
    assert plan.lint() == []
    eng = plan.compile()
    rec = registry.record_search(eng, pod_axis="pod")
    tags = {r.tag for r in rec.records if r.axes == ("pod",)}
    assert tags == ({"decision", "lockstep"} if decomposition == "2d"
                    else {"lockstep"})
    assert {r.pod for r in rec.records if r.mode in ("td", "bu")} == {0, 1}


def _leaky_td(g, pi, front, args, lv):
    """A top-down body that gathers its frontier over the pod axis."""
    collectives.all_gather_tiled(pack_bits(front), (collectives.POD,))
    return topdown_level_1d(g, pi, front, args, lv)


def test_r3_flags_a_pod_leak_and_an_under_declared_rendezvous():
    body = decomp._make_strip_body(_leaky_td, bottomup_level_1d,
                                   decomp._make_strip_state(sparse=False))
    graph, mesh = registry._inputs("1d", True, "cpu")
    with _scoped_entry("1d", "1d-pod-leak", body=body):
        fs = plan_bfs(graph, BFSConfig(decomposition="1d-pod-leak"),
                      mesh).lint()
    leak = [f for f in fs if f.rule == "R3" and f.detail.get("pod_leak")]
    assert leak and leak[0].detail["collective"] == "all_gather"
    assert leak[0].detail["stray_axes"] == ["pod"]
    graph, mesh = registry._inputs("2d", True, "cpu")
    with _scoped_entry("2d", "2d-under",
                       rendezvous_axes=lambda axes, mesh_axes: tuple(axes)):
        fs = plan_bfs(graph, BFSConfig(decomposition="2d-under"),
                      mesh).lint()
    assert [f.rule for f in fs] == ["R3"], fs
    assert fs[0].detail["under_declared"] == ["pod"]
    assert decomp.registered_decompositions() == ("1d", "1ds", "2d")


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=_SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               **ONE_THREAD_ENV)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, timeout=600, env=env)


def test_cli_quick_flags_fixture_and_clean_registry(tmp_path):
    path = tmp_path / "lint-report.json"
    r = _run_cli("--quick", "--expect-fixture", "--device", "cpu",
                 "--json", str(path))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "registry combos clean, 18 budget cases" in r.stdout
    assert f"R1 correctly flags {FIXTURE_NAME}" in r.stdout
    report = json.loads(path.read_text())
    assert report["clean"] and report["findings"] == []
    assert len(report["combos"]) >= 3
    assert len(report["budget_cases"]) == 18
    r1 = [f for f in report["fixture"]["findings"] if f["rule"] == "R1"
          and f["detail"]["collective"] == "ppermute"]
    assert r1 and r1[0]["detail"]["divergent_axes"] == ["pod"]


def test_cli_full_registry_clean(tmp_path):
    """The whole sweep: every LocalOps x schedule combo, the 18 budget
    cases and the fixture self-check."""
    path = tmp_path / "lint-report.json"
    r = _run_cli("--expect-fixture", "--device", "cpu", "--json", str(path))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    report = json.loads(path.read_text())
    assert report["clean"] and len(report["combos"]) >= 50
    assert len(report["budget_cases"]) == 18


def test_cli_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    r = _run_cli("--quick", "--no-budgets")
    assert r.returncode != 0 and "cuda" in r.stderr.lower()
