"""The port's drivers (``repro_torch.examples``) on the CPU at scale 11,
the reference driver's lines against the port's, and the closed forms
and the stand-in graph the drivers and Fig. 9 read."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import comm_model as r_comm
from repro.graph.rmat import scale_free_standin as r_standin
from repro_torch.core import comm_model
from repro_torch.examples import graph500_bfs, quickstart, serve_lm, train_lm
from repro_torch.launch import train
from repro_torch.graph.rmat import scale_free_standin
from _torch_threads import one_thread  # noqa: F401

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_BASE = ["--scale", "11", "--roots", "4", "--device", "cpu"]
_TIMES = re.compile(r"\s+[\d.]+ ms, [\d.e+-]+ TEPS")


def _lines(text, prefix):
    return [_TIMES.sub("", x) for x in text.splitlines()
            if x.startswith(prefix)]


@pytest.mark.parametrize("extra", [
    ["--grid", "1x1"], ["--decomposition", "1ds", "--grid", "4x1"],
    ["--local-mode", "kernel", "--storage", "dcsc"], ["--fast"]],
    ids=["2d", "1ds", "kernel-dcsc", "fast"])
def test_graph500_driver_runs_on_the_cpu(capsys, extra):
    graph500_bfs.main(_BASE + extra)
    out = capsys.readouterr().out
    roots = _lines(out, "root ")
    assert len(roots) == 4 and all(x.endswith("valid") for x in roots)
    assert "harmonic-mean TEPS over 4 roots" in out
    assert ("useful words" in out) == ("--fast" not in extra)


def test_graph500_driver_lines_equal_reference(capsys):
    """Roots, level counts and validity of each root, and the
    useful-words line, as the JAX driver prints them (times aside)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_ROOT, "examples", "graph500_bfs.py"),
                        "--scale", "11", "--roots", "4", "--grid", "1x1"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    graph500_bfs.main(_BASE)
    out = capsys.readouterr().out
    for prefix in ("root ", "useful words"):
        assert _lines(out, prefix) == _lines(r.stdout, prefix), prefix
    assert len(_lines(out, "root ")) == 4


@pytest.mark.parametrize("extra,devices", [
    ([], 1),
    (["--decomposition", "1ds", "--grid", "4x1", "--storage", "dcsc"], 4)],
    ids=["2d", "1ds-4x1-dcsc"])
def test_graph500_driver_born_store_equals_reference(capsys, tmp_path, extra,
                                                     devices):
    """``--born --store DIR`` at scale 10, run twice: the first run builds
    on the device and saves, the second loads; both print the reference
    driver's ``--born`` root lines (roots from the degree vector, levels,
    validation skipped).  The port runs the kernel entry, the reference
    the dense one: the same trees."""
    born = ["--scale", "10", "--roots", "4", "--born"]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable,
                        os.path.join(_ROOT, "examples", "graph500_bfs.py"),
                        *born, *extra],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    want = _lines(r.stdout, "root ")
    assert len(want) == 4 and all(x.endswith(
        "validation skipped (born-sharded: no host edges)") for x in want)
    store = ["--store", str(tmp_path / "gstore"), "--device", "cpu",
             "--local-mode", "kernel"]
    for first in (True, False):
        graph500_bfs.main(born + extra + store)
        out = capsys.readouterr().out
        assert ("born-sharded build" in out) == first
        assert ("store save" in out) == first
        assert ("store load" in out) == (not first)
        assert _lines(out, "root ") == want


def test_quickstart_and_serve_lm_run_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "valid tree: True" in out
    assert "served 6 requests" in out


def test_drivers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (graph500_bfs.main, quickstart.main, serve_lm.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])


@pytest.mark.parametrize("driver", ["train_lm", "launch-train-autoint"])
def test_training_drivers_run_on_the_cpu(capsys, tmp_path, driver):
    """The JAX package's tests/test_examples.py::test_train_lm_example
    and ::test_train_launcher_recsys, with their arguments, on the CPU."""
    if driver == "train_lm":
        train_lm.main(["--steps", "12", "--batch", "2", "--seq", "64",
                       "--d-model", "64", "--layers", "2", "--ckpt-dir",
                       str(tmp_path / "lm_ck"), "--device", "cpu"])
        assert "trained 12 steps" in capsys.readouterr().out
    else:
        train.main(["--arch", "autoint", "--steps", "8", "--ckpt-dir",
                    str(tmp_path / "ai_ck"), "--device", "cpu"])
        assert "autoint: 8 steps" in capsys.readouterr().out


def test_training_drivers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main(["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "autoint", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "gin-tu", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("pr,pc", [(1, 1), (2, 2), (4, 4), (16, 16),
                                   (2, 8)])
def test_closed_forms_equal_reference(pr, pc):
    for n, m in ((1 << 10, 16 << 10), (1 << 24, 268_435_456)):
        assert comm_model.topdown_words(n, m, pr, pc) == \
            r_comm.topdown_words(n, m, pr, pc)
        for s_b in (1.0, 4.0):
            assert comm_model.bottomup_words(n, pr, pc, s_b) == \
                r_comm.bottomup_words(n, pr, pc, s_b)
    for k in (0.0, 1.5, 16.0):
        assert comm_model.ratio_eq2(k, pc) == r_comm.ratio_eq2(k, pc)
        assert comm_model.ratio_eq2(k, pc, 2.0) == \
            r_comm.ratio_eq2(k, pc, 2.0)


@pytest.mark.parametrize("n,m_target,seed", [(300, 2000, 7), (1000, 500, 3)])
def test_scale_free_standin_is_the_reference_graph(n, m_target, seed):
    want = r_standin(n, m_target, seed=seed)
    got = scale_free_standin(n, m_target, seed=seed, device="cpu")
    assert (got.n, got.m_input) == (want.n, want.m_input)
    assert np.array_equal(got.src.numpy(), want.src)
    assert np.array_equal(got.dst.numpy(), want.dst)
