"""``correct`` comes out false where it should: the control (the
reference in the port's place with the stated guarantee broken) in every
cell, and the port with its timed path broken underneath: a level step
that returns its state unchanged, a kernel's answer altered where it is
produced, half of a batch left out.  The cells run on one simulated
1x1 grid, so no exchange between chips can be left out.  At a tiny
scale on the CPU; ``test_control_at_cell_size`` runs the control at the
cells' own size on a card."""
from __future__ import annotations

import json

import pytest
import torch

from bench.control import ControlProgram
from bench.run import run_cell
from bench.tiny import REPO, make_root

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # 16 keys and 4 checked calls keep a broken search's 64 levels short
    return make_root(tmp_path_factory.mktemp("port-bench-faults"),
                     traffic={"keys": 16, "checked_calls": 4})


def _run(root, cell, program=None, seed=5):
    kw = {} if program is None else {"program": program}
    return run_cell(root, cell, seed, 0.0, False, "cpu", **kw)


def test_sound_port_is_correct(root):
    res = _run(root, "kron-s24-do")
    assert res["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    for seed in (1, 2, 3):
        res = _run(root, cell, ControlProgram, seed)
        assert res["correct"] is False
        assert res["checks"]["wrong_parents"]["value"] > 0


def test_step_returning_its_state_unchanged_is_caught(root, monkeypatch):
    from repro_torch.core import decomp

    def unchanged(g, pi, f, args, lv):
        return pi, f, {}
    monkeypatch.setattr(decomp, "topdown_level", unchanged)
    monkeypatch.setattr(decomp, "bottomup_level", unchanged)
    res = _run(root, "kron-s24-do")
    assert res["correct"] is False
    assert res["checks"]["wrong_parents"]["value"] > 0


@pytest.mark.parametrize("cell, module, entry", [
    ("kron-s24-td", "repro_torch.kernels.spmsv.ops", "spmsv_min"),
    ("kron-s24-do", "repro_torch.kernels.bottomup.ops", "bottomup_substep")])
def test_answer_altered_where_produced_is_caught(root, monkeypatch, cell,
                                                 module, entry):
    import importlib

    from repro_torch.core.frontier import INT_INF
    mod = importlib.import_module(module)
    fn = getattr(mod, entry)

    def altered(*a, **kw):
        out = fn(*a, **kw)
        cand = out[0] if isinstance(out, tuple) else out
        cand = torch.where(cand != INT_INF, cand + 1, cand)
        return (cand,) + tuple(out[1:]) if isinstance(out, tuple) else cand
    monkeypatch.setattr(mod, entry, altered)
    res = _run(root, cell)
    assert res["correct"] is False


def test_half_the_batch_left_out_is_caught(root, monkeypatch):
    from repro_torch.core.engine import BFSEngine
    search_batch = BFSEngine.search_batch

    def half(self, roots, pod_axis="pod"):
        roots = list(roots)
        h = len(roots) // 2
        return search_batch(self, roots[:h] * 2, pod_axis)
    monkeypatch.setattr(BFSEngine, "search_batch", half)
    res = _run(root, "kron-s24-batch16")
    assert res["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    for seed in (11, 12, 13):
        res = run_cell(REPO, cell, seed, 5.0, False, "cuda",
                       program=ControlProgram)
        assert res["correct"] is False
