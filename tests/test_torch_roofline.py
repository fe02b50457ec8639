"""The port's roofline tooling (``launch/roofline.py``) and its H100 link
terms (``core/comm_model.py::AlphaBeta``) against the JAX package's.

  * ``model_flops`` equals the JAX package's on every cell's meta;
  * ``roofline_report`` on a hand-made record, each dtype class over its
    peak;
  * the recorded per-kind collective bytes of the 2D BFS level cell at
    scale 10 on 4x4 equal ``collective_bytes_from_hlo`` of the JAX
    package's compiled level cell on 16 forced host devices (its bottom
    up is unrolled: no loop body to multiply by a trip count);
  * the step counter: a tiny LM forward's FLOPs are its GEMMs' 2mnk plus
    kernel 9's formula, AutoInt's lookup is kernel 8's formula, and a
    small LM cell's and a small recsys cell's counts are equal on
    ``meta`` and on the CPU;
  * ``AlphaBeta``'s costs equal the JAX package's formulas with the same
    terms."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import LMShape, RecsysShape, get_config, reduced
from repro_torch.core import collectives, comm_model
from repro_torch.core.spmm import make_spmm_fn
from repro_torch.graph.formats import build_blocked
from repro_torch.graph.rmat import rmat_graph
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import cells, roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import autoint as ai
from repro_torch.models import transformer as tf
from _torch_threads import ONE_THREAD_ENV, one_thread  # noqa: F401

_HERE = os.path.dirname(__file__)
ALL = [c for c in cells.all_cells() + cells.bfs_cells() + [
    (a, s) for a, s, _ in cells.HILLCLIMB_CELLS]
       if c not in cells.SKIPPED_CELLS]


@pytest.mark.parametrize("arch,shape", ALL, ids=lambda x: str(x))
def test_model_flops_equals_reference(arch, shape):
    from repro.launch.roofline import model_flops as ref_model_flops
    cell = cells.build_cell(arch, shape, make_production_mesh(device="meta"))
    assert roofline.model_flops(cell.meta) == ref_model_flops(cell.meta)


def test_roofline_report_on_a_hand_made_record():
    rec = {"n_devices": 256, "flops": 1.0e12,
           "flops_by_class": {"bf16": 0.9e12, "fp32": 0.1e12},
           "bytes_accessed": 3.35e9, "collectives": {"total_bytes": 1.8e9},
           "meta": {"family": "lm", "n_params": 10, "n_active_params": 10,
                    "tokens": 1000, "kind": "train"}}
    r = roofline.roofline_report(rec)
    assert r["compute_s"] == pytest.approx(0.9e12 / 989e12 + 0.1e12 / 67e12)
    assert r["memory_s"] == pytest.approx(1e-3)
    assert r["collective_s"] == pytest.approx(4e-3)
    assert r["dominant"] == "collective" and r["bound_time_s"] == \
        pytest.approx(4e-3)
    assert r["model_flops"] == 6.0 * 10 * 1000
    assert r["hlo_flops_total"] == 256e12
    assert r["useful_ratio"] == pytest.approx(6e4 / 256e12)
    # without the split every FLOP counts at the bf16 peak
    rec.pop("flops_by_class")
    assert roofline.roofline_report(rec)["compute_s"] == \
        pytest.approx(1e12 / 989e12)


def test_level_step_collective_bytes_equal_reference_hlo(tmp_path):
    from repro_torch.configs.base import BFSShape
    from repro_torch.launch import dryrun
    out = tmp_path / "level.json"
    r = subprocess.run([sys.executable, os.path.join(_HERE,
                                                     "_torch_cells_main.py"),
                        "level", str(out)], capture_output=True, text=True,
                       timeout=300, env={**os.environ, **ONE_THREAD_ENV})
    assert r.returncode == 0, r.stdout + r.stderr
    want = json.loads(out.read_text())
    mesh = make_mesh(4, 4, device="meta")
    cell = cells.build_bfs_cell(get_config("bfs-rmat"), BFSShape("scale10", 10),
                                mesh, level_only=True)
    got = dryrun.count_cell(cell, mesh)["collectives"]
    kinds = {k for k in want if not k.startswith("count")} - {
        "total_bytes", "inloop_bytes"}
    assert kinds == {"collective-permute", "all-gather", "all-to-all"}
    assert {k: got.get(k, 0.0) for k in kinds} == {k: want[k] for k in kinds}
    assert got["total_bytes"] == want["total_bytes"] > 0
    assert want["inloop_bytes"] == got["inloop_bytes"] == 0.0


def test_spmm_records_per_device_bytes():
    e = rmat_graph(8, edge_factor=4, seed=3, device="cpu")
    g = build_blocked(e, 2, 2, align=32, cap_pad=32)
    part, d = g.part, 8
    with collectives.ScheduleRecorder() as rec:
        make_spmm_fn(part, "cpu")(g, torch.zeros(2, 2, part.chunk, d))
    got = {r.kind: r.nbytes for r in rec.records}
    assert got == {"collective-permute": part.chunk * d * 4,
                   "all-gather": part.nc * d * 4,
                   "reduce-scatter": part.chunk * d * 4}
    b = roofline.collective_bytes_from_records(rec.records)
    assert b["total_bytes"] == sum(got.values()) and b["inloop_bytes"] == 0
    assert b["count_all-gather"] == 1


def _tiny_lm():
    return reduced(get_config("smollm-135m"), n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=96, vocab=128)


def test_counter_lm_forward_is_gemms_plus_kernel9():
    cfg = _tiny_lm()
    b, s = 2, 16
    p = tf.init_params(cfg, device="cpu")
    toks = torch.zeros(b, s, dtype=torch.int32)
    with torch.no_grad(), roofline.StepCounter() as c:
        tf.forward(p, toks, cfg, remat=False)
    t, d, f = b * s, cfg.d_model, cfg.d_ff
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gemms = 2 * t * d * (hq * dh + 2 * hkv * dh) + 2 * t * hq * dh * d \
        + 3 * 2 * t * d * f
    q = torch.empty(b, s, hq, dh, dtype=torch.bfloat16)
    k = torch.empty(b, s, hkv, dh, dtype=torch.bfloat16)
    k9_flops, k9_bytes = fa_ops.forward_cost(q, k, True, None, 0)
    assert c.kernels["flash_attention"] == [cfg.n_layers,
                                            cfg.n_layers * k9_flops,
                                            cfg.n_layers * k9_bytes]
    assert c.total_flops == cfg.n_layers * (gemms + k9_flops)
    assert c.flops["bf16"] == c.total_flops


def test_counter_autoint_lookup_is_kernel8():
    cfg = reduced(get_config("autoint"), vocab_sizes=(50,) * 39)
    model = ai.AutoInt(cfg, device="cpu")
    idx = torch.zeros(8, cfg.n_sparse, dtype=torch.int32)
    with torch.no_grad(), roofline.StepCounter() as c:
        model(idx)
    rows = model.table.shape[0]
    want = eb_ops.forward_cost(8 * 39, 8 * 39, rows, cfg.embed_dim, 4)
    assert c.kernels["embedding_bag"] == [1, *want]


def _fill(tree, gen):
    """Seeded values in the non-parameter arguments (ids 0)."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                x.copy_(torch.rand(x.shape, generator=gen))
            else:
                x.zero_()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def _counts(build, device):
    cell = build(make_mesh(1, 1, device=device))
    _fill(cell.args[2:] if cell.meta["kind"] == "train" else cell.args[1:],
          torch.Generator().manual_seed(0))
    with roofline.StepCounter() as c:
        cell.fn(*cell.args)
    return c.summary()


@pytest.mark.parametrize("family", ["lm", "recsys"])
def test_counts_equal_on_meta_and_cpu(family):
    if family == "lm":
        cfg = _tiny_lm()

        def build(mesh):
            return cells.build_lm_cell(cfg, LMShape("t", 32, 2, "train"), mesh)
    else:
        cfg = reduced(get_config("autoint"), vocab_sizes=(40,) * 39)

        def build(mesh):
            return cells.build_recsys_cell(
                cfg, RecsysShape("t", 16, kind="train"), mesh)
    meta, cpu = _counts(build, "meta"), _counts(build, "cpu")
    for key in ("flops", "flops_by_class", "bytes_read", "bytes_written",
                "kernels"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 and meta["kernels"]


def test_alphabeta_equals_reference_formulas():
    from repro.core.comm_model import AlphaBeta as RefAlphaBeta
    ab = comm_model.AlphaBeta()
    assert ab.beta_n == 1.0 / roofline.LINK_BW == 1.0 / 450e9
    assert ab.alpha_n == 1e-6
    ref = RefAlphaBeta(alpha_n=ab.alpha_n, beta_n=ab.beta_n)
    for n, m, pr, pc in ((1 << 20, 16 << 20, 4, 4), (1 << 26, 1 << 30, 16,
                                                     16)):
        assert ab.expand_cost(n, pr, pc) == ref.expand_cost(n, pr, pc)
        assert ab.fold_cost(m, pr, pc) == ref.fold_cost(m, pr, pc)
        assert ab.bottomup_level_cost(n, pr, pc) == \
            ref.bottomup_level_cost(n, pr, pc)
