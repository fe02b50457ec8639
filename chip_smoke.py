#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold
every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py            # the full run: Graph500 scale 24

Phases, in the order they run:
  1 device       name, count, versions, nvidia-smi name and power limit
  2 build        nvcc of the three kernels (in parallel), ptxas report
  3 main path    one Graph500 session at full width: counter R-MAT (kernel)
                 -> preprocess -> build_blocked -> plan_bfs(local_mode=
                 "kernel") -> compile -> 16 roots, launch counts read
                 around exactly this; every tree validated on the card;
                 two roots again through local_mode="dense", parents
                 bit-identical
  4 kernels      each kernel against its plain version at the main
                 path's shapes, tolerance 0 (the outputs are integers)
  5 meshes       simulated 2x2 and 4x4 grids at scale 16: kernel and
                 dense sessions agree in parents, levels, stats, counters
  6 kernel times level by level on one main-path search: kernel, plain,
                 library yardstick and bound, each in ms
  7 profile      device busy and idle share of one search (torch.profiler)
Then the card's name and power limit, the ``kernels`` JSON line and the
result line.  Any failed check exits non-zero; nothing is caught.  It
exits non-zero without a CUDA card, and where the repository's ``src``
is missing.  The full record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SCALE = 24
EDGE_FACTOR = 16
SEED = 1
N_ROOTS = 16
MESH_SCALE = 16
# H100 SXM published memory rate (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# instruction issue: four warp schedulers per SM, one warp instruction each
# per clock (NVIDIA H100 architecture white paper), so at most 128 thread
# instructions per clock per SM whatever the mix; times the card's SM count
# and its maximum SM clock (nvidia-smi) this is the integer kernels' peak
INSTR_PER_CLOCK_PER_SM = 128
RMAT_INSTR_PER_EDGE_LEVEL = 9  # the least per edge and level, rmat_counter.cu
TIMED_REPS = 20


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def phase(title: str) -> None:
    print(f"\n== {title} ==", flush=True)


def cuda_ms(fn, reps: int = TIMED_REPS) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def smi(query: str, fmt: str = "csv,noheader") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        f"--format={fmt}"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def smi_line() -> str:
    return smi("name,power.limit")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script runs "
              "the port on a CUDA card", flush=True)
        return 2

    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.engine import plan_bfs
    from repro_torch.core.frontier import INT_INF, pack_bits
    from repro_torch.core.metrics import harmonic_mean, teps
    from repro_torch.core.ref import TreeValidator
    from repro_torch.graph import rmat
    from repro_torch.graph.formats import build_blocked
    from repro_torch.kernels import build
    from repro_torch.kernels.bottomup import ops as bu_ops
    from repro_torch.kernels.spmsv import ops as sp_ops
    from repro_torch.launch.mesh import make_local_mesh

    kernels = {"spmsv_csr_min": sp_ops.KERNEL,
               "bottomup_substep": bu_ops.KERNEL,
               "rmat_counter": rmat.RMAT_COUNTER}
    replaces = {"spmsv_csr_min": "src/repro/kernels/spmsv/spmsv.py:56",
                "bottomup_substep": "src/repro/kernels/bottomup/bottomup.py:89",
                "rmat_counter": "src/repro/graph/rmat.py:225"}
    dev = torch.device("cuda")
    record = {"scale": SCALE}
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- 1
    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi_nl = smi_line()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sm_mhz = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    instr_per_s = INSTR_PER_CLOCK_PER_SM * n_sm * sm_mhz * 1e6
    print(f"device: {name} (count {torch.cuda.device_count()}); torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi_nl}")
    print(f"bounds use {HBM_BYTES_PER_S / 1e12} TB/s (published H100 SXM "
          f"peak) and an instruction rate of {INSTR_PER_CLOCK_PER_SM} x "
          f"{n_sm} SMs x {sm_mhz} MHz max SM clock = "
          f"{instr_per_s / 1e12:.3f} T instructions/s")
    record["device"] = {"name": name, "smi": smi_nl, "sms": n_sm,
                        "sm_mhz_max": sm_mhz, "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # ---------------------------------------------------------------- 2
    phase("2 build")
    t0 = time.perf_counter()
    libs = build.build_libraries(kernels)
    record["build_s"] = time.perf_counter() - t0
    for k in kernels:
        print(f"{k}: {libs[k].name}")
        for line in build.build_log(k).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        kernels[k].load()
    print(f"nvcc for sm_90a, all three in parallel: {record['build_s']:.2f} s")

    # ---------------------------------------------------------------- 3
    phase(f"3 main path: Graph500 session, scale {SCALE}, grid 1x1, "
          f"local_mode='kernel'")
    cfg = BFSConfig()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edges = rmat.rmat_graph(SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    graph = build_blocked(edges, 1, 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mesh = make_local_mesh(1, 1, device=dev)
    engine = plan_bfs(graph, cfg, mesh, local_mode="kernel").compile()
    rng = np.random.default_rng(0)
    roots, search_ms, levels, modes, parents = [], [], [], [], []
    for _ in range(N_ROOTS):
        root = rmat.random_source(edges, rng)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = engine.search(root)
        torch.cuda.synchronize()
        search_ms.append((time.perf_counter() - ts) * 1e3)
        roots.append(root)
        levels.append(out[1])
        modes.append([int(x) for x in out[3][:out[1], 2]])
        parents.append(out[0].reshape(-1)[: graph.part.n_orig])
    launches = {k: v.launches for k, v in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"n={edges.n} m_input={edges.m_input} m={edges.m} (directed, "
          f"deduplicated) cap={graph.cap} cap_seg={graph.cap_seg} "
          f"maxdeg_col={graph.maxdeg_col}")
    print(f"generate (rmat_counter kernel) + preprocess: {t1 - t0:.3f} s; "
          f"build_blocked: {t2 - t1:.3f} s; ship {engine.ship_s:.4f} s; "
          f"compile (kernel load + warm-up search) {engine.compile_s:.3f} s")
    rates = [teps(edges.m_input, ms / 1e3) for ms in search_ms]
    for r, lv, md, ms, rate in zip(roots, levels, modes, search_ms, rates):
        print(f"root {r:>9}: {lv} levels, modes {md}, search {ms:8.3f} ms, "
              f"{rate:.4e} TEPS")
    hmean = harmonic_mean(rates)
    print(f"harmonic-mean TEPS over {N_ROOTS} roots (search only, m_input "
          f"edges): {hmean:.6e}; search ms median "
          f"{float(np.median(search_ms)):.3f}, min {min(search_ms):.3f}, "
          f"max {max(search_ms):.3f} ({N_ROOTS} samples)")
    print(f"peak device memory of the main path: {peak_gib:.3f} GiB")
    print(f"launches in the main path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was never launched on the main path")
    check(peak_gib < 40.0, f"main-path peak {peak_gib:.2f} GiB >= 40 GiB")
    t3 = time.perf_counter()
    validator = TreeValidator(edges.n, edges.src, edges.dst)
    for r, par in zip(roots, parents):
        ok, msg = validator.check(r, par)
        check(ok, f"tree of root {r}: {msg}")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t3
    print(f"validated {N_ROOTS} trees on the card in {val_s:.3f} s")
    del validator
    torch.cuda.empty_cache()
    dense = plan_bfs(graph, cfg, mesh, local_mode="dense").compile()
    for r, par in zip(roots[:2], parents[:2]):
        out = dense.search(r)
        check(torch.equal(out[0].reshape(-1)[: graph.part.n_orig], par),
              f"dense parents differ from kernel parents at root {r}")
    print("local_mode='dense' sessions on 2 roots: parents bit-identical")
    del dense
    record["session"] = {
        "n": edges.n, "m_input": edges.m_input, "m": edges.m,
        "gen_s": t1 - t0, "build_s": t2 - t1, "ship_s": engine.ship_s,
        "compile_s": engine.compile_s, "roots": roots, "levels": levels,
        "modes": modes, "search_ms": search_ms, "teps_hmean": hmean,
        "peak_gib": peak_gib, "validate_s": val_s, "launches": launches}

    # ---------------------------------------------------------------- 4
    phase("4 kernels against plain versions at the main path's shapes")
    part = graph.part
    col_ptr, row_idx = graph.col_ptr[0, 0], graph.row_idx[0, 0]
    lens = col_ptr[1:] - col_ptr[:-1]
    errs = {k: 0 for k in kernels}
    g = torch.Generator(device=dev).manual_seed(0)
    one, top = (torch.zeros(part.nc, dtype=torch.bool, device=dev)
                for _ in range(2))
    one[roots[0]] = True
    top[torch.argmax(lens)] = True
    fronts = {
        "1 vertex": one,
        "~1%": torch.rand(part.nc, generator=g, device=dev) < 0.01,
        "~30%": torch.rand(part.nc, generator=g, device=dev) < 0.30,
        "max-degree column": top}
    for label, mask in fronts.items():
        got = sp_ops.spmsv_csr_min(mask, col_ptr, row_idx, part.nr, 0)
        ids, offs, total = sp_ops.prepare(mask, col_ptr)
        want = sp_ops.spmsv_csr_min_plain(ids, offs, total, col_ptr, row_idx,
                                          part.nr, 0)
        e = max_err(got, want)
        errs["spmsv_csr_min"] = max(errs["spmsv_csr_min"], e)
        print(f"spmsv_csr_min     frontier {label:>18}: {ids.numel()} cols, "
              f"{total} edges, {int((want != INT_INF).sum())} rows reached, "
              f"max |kernel - plain| = {e}")
    rp_seg = graph.row_ptr[0, 0]
    ue = graph.col_idx[0, 0][: graph.cap_seg]
    n_edges = int(graph.seg_ptr[0, 0, 1])
    for ff in (0.0, 0.5, 1.0):
        f_words = pack_bits(torch.rand(part.nc, generator=g, device=dev) < ff)
        for df in (0.0, 0.5, 1.0):
            cvec = (torch.rand(part.chunk, generator=g, device=dev)
                    < df).to(torch.int32)
            got = bu_ops.bottomup_substep(rp_seg, ue, f_words, cvec, 0,
                                          n_edges)
            want = bu_ops.bottomup_substep_plain(rp_seg, ue, f_words, cvec, 0,
                                                 n_edges)
            e = max_err(got, want)
            errs["bottomup_substep"] = max(errs["bottomup_substep"], e)
            print(f"bottomup_substep  frontier {ff:4.0%} completed {df:4.0%}: "
                  f"{int((want != INT_INF).sum())} parents found, "
                  f"max |kernel - plain| = {e}")
            del got, want
    m_in = EDGE_FACTOR << SCALE
    full = rmat.rmat_edges_counter(SCALE, EDGE_FACTOR, seed=SEED, device=dev)
    sl = 1 << 22
    for start in (0, m_in // 2 - sl // 2, m_in - sl):
        want = rmat.rmat_edges_counter_plain(SCALE, EDGE_FACTOR, seed=SEED,
                                             start=start, count=sl,
                                             device=dev)
        part_k = rmat.rmat_edges_counter(SCALE, EDGE_FACTOR, seed=SEED,
                                         start=start, count=sl, device=dev)
        e = max(max_err(full[0][start:start + sl], want[0]),
                max_err(full[1][start:start + sl], want[1]),
                max_err(part_k[0], want[0]), max_err(part_k[1], want[1]))
        errs["rmat_counter"] = max(errs["rmat_counter"], e)
        print(f"rmat_counter      slice [{start}, {start + sl}) of the "
              f"{m_in}-edge stream (full-stream launch and slice launch): "
              f"max |kernel - plain| = {e}")
    del full, want, part_k
    for k, e in errs.items():
        check(e == 0, f"{k} disagrees with its plain version (max err {e})")
    print("all three kernels equal their plain versions (tolerance 0)")

    # ---------------------------------------------------------------- 5
    phase(f"5 simulated meshes at scale {MESH_SCALE}, instrumented")
    small = rmat.rmat_graph(MESH_SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    small_val = TreeValidator(small.n, small.src, small.dst)
    srng = np.random.default_rng(1)
    for (pr, pc), fold in (((2, 2), "reduce"), ((2, 2), "alltoall"),
                           ((4, 4), "reduce")):
        sg = build_blocked(small, pr, pc)
        smesh = make_local_mesh(pr, pc, device=dev)
        scfg = BFSConfig(fold_mode=fold)
        ek = plan_bfs(sg, scfg, smesh, local_mode="kernel").compile()
        ed = plan_bfs(sg, scfg, smesh, local_mode="dense").compile()
        for _ in range(2):
            r = rmat.random_source(small, srng)
            a, b = ek.run(r), ed.run(r)
            check(np.array_equal(a.parents, b.parents), f"parents {pr}x{pc}")
            check(a.n_levels == b.n_levels, f"levels {pr}x{pc}")
            check(np.array_equal(a.level_stats, b.level_stats),
                  f"level_stats {pr}x{pc}")
            for k, v in b.counters.items():
                want_v = b.counters["edges_useful"] \
                    if k == "edges_examined" else v
                check(a.counters[k] == want_v, f"counter {k} {pr}x{pc}")
            ok, msg = small_val.check(r, torch.from_numpy(a.parents).to(dev))
            check(ok, f"{pr}x{pc} tree of root {r}: {msg}")
            print(f"{pr}x{pc} fold {fold:>8} root {r:>6}: {a.n_levels} "
                  f"levels, modes {[int(x) for x in a.level_stats[:a.n_levels, 2]]}"
                  f", wire_fold {a.counters['wire_fold']}, edges_examined "
                  f"{a.counters['edges_examined']} (dense "
                  f"{b.counters['edges_examined']}): kernel == dense in "
                  f"parents, levels, level_stats and counters; tree valid")
    print("edges_examined of a kernel session is the frontier edge mass, "
          "so it equals the dense session's edges_useful")
    del small, small_val

    # ---------------------------------------------------------------- 6
    phase("6 kernel times level by level on one main-path search")
    calls = []
    real_sp, real_bu = sp_ops.spmsv_csr_min, bu_ops.bottomup_substep

    def rec_sp(*a):
        calls.append(("spmsv_csr_min", a))
        return real_sp(*a)

    def rec_bu(*a):
        calls.append(("bottomup_substep", a))
        return real_bu(*a)

    sp_ops.spmsv_csr_min, bu_ops.bottomup_substep = rec_sp, rec_bu
    try:
        out = engine.search(roots[0])
    finally:
        sp_ops.spmsv_csr_min, bu_ops.bottomup_substep = real_sp, real_bu
    torch.cuda.synchronize()
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "calls": 0} for k in kernels}
    for lvl, (kname, a) in enumerate(calls):
        row = per[kname]
        row["calls"] += 1
        if kname == "spmsv_csr_min":
            mask, cptr, ridx, nr, coff, cap_f = a
            ids, offs, total = sp_ops.prepare(mask, cptr, cap_f)
            k_ms = cuda_ms(lambda: sp_ops.launch(ids, offs, total, cptr, ridx,
                                                 nr, coff))
            lens_f = (offs[1:] - offs[:-1])
            col = torch.repeat_interleave(ids.to(torch.int64), lens_f)
            k_i = torch.repeat_interleave(
                torch.arange(ids.shape[0], device=dev), lens_f)
            pos = cptr[col].to(torch.int64) + (
                torch.arange(total, device=dev) - offs[k_i])
            v = ridx[pos].to(torch.int64)
            vals = (col + coff).to(torch.int32)
            del k_i, pos

            def run_lib():
                torch.full((nr,), INT_INF, dtype=torch.int32,
                           device=dev).scatter_reduce_(0, v, vals, "amin")
            p_ms = cuda_ms(lambda: sp_ops.spmsv_csr_min_plain(
                ids, offs, total, cptr, ridx, nr, coff), reps=3)
            lib_ms = cuda_ms(run_lib, reps=5)
            nbytes = 4 * ids.numel() + 8 * (ids.numel() + 1) \
                + 8 * ids.numel() + 4 * total + 4 * nr
            row["library_ms"] += lib_ms
            desc = f"frontier {ids.numel()} cols, {total} edges"
            del col, v, vals
        else:
            rp, uew, fw, cv, coff, ne = a
            k_ms = cuda_ms(lambda: bu_ops.launch(rp, uew, fw, cv, coff, ne))
            p_ms = cuda_ms(lambda: bu_ops.bottomup_substep_plain(
                rp, uew, fw, cv, coff, ne), reps=3)
            # edges a live row must read: up to its first hit, else all
            rl = (rp[1:] - rp[:-1]).to(torch.int64)
            rows = torch.repeat_interleave(torch.arange(cv.shape[0],
                                                        device=dev), rl)
            e_idx = torch.arange(rows.numel(), device=dev)
            uu = uew[: rows.numel()].to(torch.int64)
            hit = ((fw[uu >> 5] >> (uu & 31)) & 1).to(torch.bool)
            first = torch.full((cv.shape[0],), 2**62, dtype=torch.int64,
                               device=dev).scatter_reduce_(
                0, rows[hit], e_idx[hit], "amin")
            lo = rp[:-1].to(torch.int64)
            need = torch.where(first < 2**62, first - lo + 1, rl)
            live = cv == 0
            read = int(need[live].sum())
            n_live = int(live.sum())
            del rows, e_idx, uu, hit, first
            nbytes = 4 * (cv.numel() + 1) + 4 * cv.numel() + 4 * fw.numel() \
                + 4 * read + 4 * cv.numel()
            desc = f"{n_live} live rows, {read} edges read to the first hit"
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row["ms"] += k_ms
        row["plain_ms"] += p_ms
        row["bound_ms"] += b_ms
        print(f"call {lvl} {kname}: {desc}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({nbytes} bytes)")
    # the wrapper itself: its host work (salts, two allocations) is
    # microseconds against a launch of milliseconds
    per["rmat_counter"]["ms"] = cuda_ms(lambda: rmat.rmat_edges_counter(
        SCALE, EDGE_FACTOR, seed=SEED, device=dev), reps=5)
    per["rmat_counter"]["plain_ms"] = cuda_ms(
        lambda: rmat.rmat_edges_counter_plain(SCALE, EDGE_FACTOR, seed=SEED,
                                              device=dev), reps=1)
    rb = 8 * m_in / HBM_BYTES_PER_S * 1e3
    ro = RMAT_INSTR_PER_EDGE_LEVEL * SCALE * m_in / instr_per_s * 1e3
    per["rmat_counter"]["bound_ms"] = max(rb, ro)
    per["rmat_counter"]["calls"] = 1
    print(f"rmat_counter: full stream of {m_in} edges: kernel "
          f"{per['rmat_counter']['ms']:.4f} ms, plain "
          f"{per['rmat_counter']['plain_ms']:.4f} ms, bound "
          f"max({rb:.4f} ms bytes, {ro:.4f} ms issuing "
          f"{RMAT_INSTR_PER_EDGE_LEVEL} instructions per edge and level)")
    for k in ("spmsv_csr_min", "bottomup_substep"):
        r = per[k]
        print(f"{k}: {r['calls']} launches in one search: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms"
              + (f", library {r['library_ms']:.4f} ms"
                 if k == "spmsv_csr_min" else ""))
    record["kernel_times"] = per

    # ---------------------------------------------------------------- 7
    phase("7 profile of one main-path search")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    engine.search(roots[0])
    torch.cuda.synchronize()
    plain_search_ms = (time.perf_counter() - ts) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        engine.search(roots[0])
        torch.cuda.synchronize()
        prof_search_ms = (time.perf_counter() - ts) * 1e3
    busy_us, by_name = 0.0, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    if busy_us > 0:
        busy_ms = busy_us / 1e3
        print(f"device busy {busy_ms:.4f} ms in {len(by_name)} kinds of "
              f"kernel; search {prof_search_ms:.3f} ms under the profiler, "
              f"{plain_search_ms:.3f} ms without it: busy "
              f"{busy_ms / plain_search_ms:.1%}, idle "
              f"{1 - busy_ms / plain_search_ms:.1%} of the unprofiled search")
        for nm, us in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
            print(f"  {us / 1e3:9.4f} ms  {nm[:90]}")
    else:
        busy_ms = None
        print("the profiler recorded no device time: busy share not measured")
    record["profile"] = {"busy_ms": busy_ms, "search_ms": plain_search_ms,
                         "profiled_search_ms": prof_search_ms}
    record["total_s"] = time.perf_counter() - t_start
    print(f"total {record['total_s']:.1f} s")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    line = {"kernels": [{
        "name": k, "route": "cuda",
        "source": str(kernels[k].source.relative_to(ROOT)),
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": errs[k], "ms": per[k]["ms"],
        "plain_ms": per[k]["plain_ms"], "bound_ms": per[k]["bound_ms"],
        "bound_by": ("operations" if k == "rmat_counter" and ro > rb
                     else "bytes"),
        "library_ms": per[k]["library_ms"] if k == "spmsv_csr_min" else None,
    } for k in kernels]}
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
