#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and hold
every kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py            # the full run: Graph500 scale 24

Phases, in the order they run:
  1 device       name, count, versions, nvidia-smi name and power limit
  2 build        nvcc of the seven kernels (in parallel), ptxas report
  3 2D path      one Graph500 session at full width on the 2D grid 1x1:
                 counter R-MAT (kernel) -> preprocess -> build_blocked ->
                 plan_bfs(local_mode="kernel") -> compile -> 16 roots,
                 launch counts read around exactly this; every tree
                 validated on the card; two roots again through
                 local_mode="dense", parents bit-identical
  4 kernels      the 2D path's kernels against their plain versions at
                 its shapes, tolerance 0 (the outputs are integers)
  5 meshes       simulated 2x2 and 4x4 grids and a 16-strip 1d/1ds leg
                 (both codecs, 1 and 4 expand steps, an overflowing
                 bucket capacity) at scale 16: kernel and dense sessions
                 agree in parents, levels, stats, counters
  6 kernel times level by level on one 2D search: kernel, plain,
                 library yardstick and bound, each in ms
  7 profile      device busy and idle share of one 2D search
  8 1ds path     the same Graph500 graph on a 16-strip simulated mesh:
                 counter R-MAT -> build_blocked_1d -> plan_bfs("1ds",
                 "kernel", "dcsc", packed codec) -> compile -> 16 roots,
                 with expand_chunks 1 and then 4, launch counts read
                 around exactly this; every tree validated on the card,
                 the two runs' parents identical, and on 2 roots parents
                 and levels equal to the 2D path's; then 2 roots with
                 buckets of 64 ids, whose wider top-down levels take the
                 dense fallback, with the same parents
  9 kernels      level by level on one 1ds search per expand_chunks:
                 each kernel call (the frontiers, sub-chunks and buckets
                 of real levels, and the large frontier of a bottom-up
                 level) against its plain version, tolerance 0, and its
                 time beside the plain version's, the library yardstick
                 and the bound
 10 profile      device busy and idle share of one 1ds search
Then the card's name and power limit, the ``kernels`` JSON line and the
result line.  Any failed check exits non-zero; nothing is caught.  It
exits non-zero without a CUDA card, and where the repository's ``src``
is missing.  The full record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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
STRIPS = 16                   # the 1ds path's simulated mesh
STRIP_CHUNKS = (1, 4)         # its expand_chunks runs
OVER_CAP = 64                 # a bucket capacity that makes levels overflow
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


@contextlib.contextmanager
def recording(targets):
    """Record every call of the given module functions, ``(module,
    attribute, label)``, while the block runs: a list of (label, args,
    kwargs).  The calls still run."""
    calls = []
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrap(fn, label):
        def rec(*a, **kw):
            calls.append((label, a, kw))
            return fn(*a, **kw)
        return rec

    for (mod, attr, fn), (_, _, label) in zip(saved, targets):
        setattr(mod, attr, wrap(fn, label))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def bottomup_bytes(rp, uew, fw, cv):
    """Bytes one bottom-up sub-step must move on these inputs: the row
    pointers, the completed flags, each live row's edges up to its first
    frontier hit (all of them without one), the frontier words and the
    output.  Returns (bytes, live rows, edges read)."""
    dev = rp.device
    rl = (rp[1:] - rp[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(cv.shape[0], device=dev), rl)
    e_idx = torch.arange(rows.numel(), device=dev)
    uu = uew[int(rp[0]): int(rp[0]) + rows.numel()].to(torch.int64)
    hit = ((fw[uu >> 5] >> (uu & 31)) & 1).to(torch.bool)
    first = torch.full((cv.shape[0],), 2**62, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, rows[hit], e_idx[hit],
                                                   "amin")
    lo = rp[:-1].to(torch.int64) - int(rp[0])
    need = torch.where(first < 2**62, first - lo + 1, rl)
    live = cv == 0
    read, n_live = torch.stack([need[live].sum(), live.sum()]).tolist()
    nbytes = 4 * (cv.numel() + 1) + 4 * cv.numel() + 4 * fw.numel() \
        + 4 * read + 4 * cv.numel()
    return nbytes, n_live, read


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return int(((words.unsqueeze(-1) >> shifts) & 1).sum())


def strip_bytes(nzc, cap_nzc: int, live, edges: int, n_words: int,
                n_front: int, nr: int) -> int:
    """Bytes one strip SpMSV launch must move on these inputs: nzc; in
    each strip, the cheaper of the walk of its jc (nzc words) and one jc
    word per frontier column looked up; the cp pair of each live column;
    one row id per live edge; the frontier words once; and the (p, nr)
    candidates and the edge counter written once."""
    p = nzc.shape[0]
    find = torch.clamp(nzc, max=min(cap_nzc, n_front)).sum()
    found, n_live = torch.stack([find, live.sum()]).tolist()
    return (4 * p + 4 * found + 8 * n_live + 4 * edges + 4 * n_words
            + 4 * p * nr + 8)


def encode_bytes(count, cap: int, out_words: int) -> int:
    """Bytes one encode must move: the counts, the offsets below each
    (clamped) count, and every bucket word written once."""
    ids = int(torch.clamp(count, max=cap).sum())
    return 4 * count.numel() + 4 * ids + 4 * out_words


def decode_bytes(recv, p: int, cap: int, bits: int) -> int:
    """Bytes one decode must move: the p count words, the payload words
    that hold each bucket's live offsets, and the (p*cap,) ids written
    once."""
    counts = torch.clamp(recv.reshape(p, -1)[:, 0].to(torch.int64), 0, cap)
    payload = int(((counts * bits + 31) // 32).sum())
    return 4 * p + 4 * payload + 4 * p * cap


def profile_search(engine, root: int) -> dict:
    """Device busy and idle share of one search: the kernels that
    torch.profiler saw on the card over the search's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    engine.search(root)
    torch.cuda.synchronize()
    plain_search_ms = (time.perf_counter() - ts) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        engine.search(root)
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
        for nm, us in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
            print(f"  {us / 1e3:9.4f} ms  {nm[:90]}")
    else:
        busy_ms = None
        print("the profiler recorded no device time: busy share not measured")
    return {"busy_ms": busy_ms, "search_ms": plain_search_ms,
            "profiled_search_ms": prof_search_ms,
            "by_name_ms": {k: v / 1e3 for k, v in by_name.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script runs "
              "the port on a CUDA card", flush=True)
        return 2

    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.comm_model import codec_bits, rmat_strip_skew
    from repro_torch.core.engine import plan_bfs
    from repro_torch.core.frontier import INT_INF, pack_bits
    from repro_torch.core.metrics import harmonic_mean, teps
    from repro_torch.core.ref import TreeValidator
    from repro_torch.graph import rmat
    from repro_torch.graph.formats import build_blocked, build_blocked_1d
    from repro_torch.kernels import build
    from repro_torch.kernels.bottomup import ops as bu_ops
    from repro_torch.kernels.frontier_codec import ops as codec_ops
    from repro_torch.kernels.spmsv import ops as sp_ops
    from repro_torch.kernels.spmsv import strip
    from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d

    kernels = {"spmsv_csr_min": sp_ops.KERNEL,
               "bottomup_substep": bu_ops.KERNEL,
               "rmat_counter": rmat.RMAT_COUNTER,
               "spmsv_strip_min": strip.KERNEL,
               "spmsv_strip_chunk_min": strip.KERNEL_CHUNK,
               "codec_encode": codec_ops.ENCODE,
               "codec_decode": codec_ops.DECODE}
    replaces = {
        "spmsv_csr_min": "src/repro/kernels/spmsv/spmsv.py:56",
        "bottomup_substep": "src/repro/kernels/bottomup/bottomup.py:89",
        "rmat_counter": "src/repro/graph/rmat.py:225",
        "spmsv_strip_min": "src/repro/kernels/spmsv/strip.py:66",
        "spmsv_strip_chunk_min": "src/repro/kernels/spmsv/strip.py:139",
        "codec_encode":
            "src/repro/kernels/frontier_codec/frontier_codec.py:58",
        "codec_decode":
            "src/repro/kernels/frontier_codec/frontier_codec.py:93"}
    path_2d = ("spmsv_csr_min", "bottomup_substep", "rmat_counter")
    path_1ds = ("bottomup_substep", "rmat_counter", "spmsv_strip_min",
                "spmsv_strip_chunk_min", "codec_encode", "codec_decode")
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
    print(f"nvcc for sm_90a, all {len(kernels)} in parallel: "
          f"{record['build_s']:.2f} s")

    # ---------------------------------------------------------------- 3
    phase(f"3 2D path: Graph500 session, scale {SCALE}, grid 1x1, "
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
    launches = {k: kernels[k].launches for k in path_2d}
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
    print(f"peak device memory of the 2D path: {peak_gib:.3f} GiB")
    print(f"launches in the 2D path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was never launched on the 2D path")
    check(peak_gib < 40.0, f"2D-path peak {peak_gib:.2f} GiB >= 40 GiB")
    # kept on the host for the 1ds path's check (phase 8)
    parents_2d = [par.cpu() for par in parents[:2]]
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
    phase("4 2D kernels against plain versions at the 2D path's shapes")
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
    for k in path_2d:
        check(errs[k] == 0, f"{k} disagrees with its plain version (max err "
                            f"{errs[k]})")
    print("the 2D path's three kernels equal their plain versions "
          "(tolerance 0)")

    # ---------------------------------------------------------------- 5
    phase(f"5 simulated meshes at scale {MESH_SCALE}, instrumented: 2x2, "
          f"4x4 and {STRIPS} strips")
    small = rmat.rmat_graph(MESH_SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    small_val = TreeValidator(small.n, small.src, small.dst)
    srng = np.random.default_rng(1)

    def same_as_dense(a, b, r, tag):
        """A kernel session's result equals the dense session's in
        parents, levels, level_stats and counters, and its tree is
        valid."""
        check(np.array_equal(a.parents, b.parents), f"parents {tag}")
        check(a.n_levels == b.n_levels, f"levels {tag}")
        check(np.array_equal(a.level_stats, b.level_stats),
              f"level_stats {tag}")
        for k, v in b.counters.items():
            want_v = b.counters["edges_useful"] \
                if k == "edges_examined" else v
            check(a.counters[k] == want_v, f"counter {k} {tag}")
        ok, msg = small_val.check(r, torch.from_numpy(a.parents).to(dev))
        check(ok, f"{tag} tree of root {r}: {msg}")
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
            same_as_dense(a, b, r, f"{pr}x{pc}")
            print(f"{pr}x{pc} fold {fold:>8} root {r:>6}: {a.n_levels} "
                  f"levels, modes {[int(x) for x in a.level_stats[:a.n_levels, 2]]}"
                  f", wire_fold {a.counters['wire_fold']}, edges_examined "
                  f"{a.counters['edges_examined']} (dense "
                  f"{b.counters['edges_examined']}): kernel == dense in "
                  f"parents, levels, level_stats and counters; tree valid")
    # the 1D leg: 16 strips, both codecs, 1 and 4 expand steps, and a
    # bucket capacity of 32 ids on top-down-only runs, which overflows
    # the wider levels into the dense fallback
    sg = build_blocked_1d(small, STRIPS)
    smesh = make_local_mesh_1d(STRIPS, device=dev)
    dense_words = np.float32((STRIPS - 1) * (sg.part.n / 64.0))
    n_over = 0
    for dec, codec, c, cap_x in (
            ("1ds", "packed", 1, 0), ("1ds", "packed", 4, 0),
            ("1ds", "none", 1, 0), ("1ds", "none", 4, 0),
            ("1ds", "packed", 1, 32), ("1ds", "packed", 4, 32),
            ("1ds", "none", 4, 32), ("1d", "packed", 1, 0),
            ("1d", "packed", 4, 0)):
        scfg = BFSConfig(decomposition=dec, storage="dcsc",
                         frontier_codec=codec, expand_chunks=c,
                         direction_optimizing=cap_x == 0)
        ek = plan_bfs(sg, scfg, smesh, local_mode="kernel",
                      cap_x=cap_x).compile()
        ed = plan_bfs(sg, scfg, smesh, local_mode="dense",
                      cap_x=cap_x).compile()
        for _ in range(2):
            r = rmat.random_source(small, srng)
            a, b = ek.run(r), ed.run(r)
            tag = f"{dec}/{codec}/C={c}/cap_x={ek.plan.statics.cap_x}"
            same_as_dense(a, b, r, tag)
            st = a.level_stats[:a.n_levels]
            over = [i for i in range(a.n_levels)
                    if dec == "1ds" and st[i, 2] == 0
                    and st[i, 4] == dense_words]
            n_over += len(over)
            print(f"{tag:>30} root {r:>6}: {a.n_levels} levels, modes "
                  f"{[int(x) for x in st[:, 2]]}, overflowed top-down "
                  f"levels {over}, wire_expand "
                  f"{a.counters['wire_expand']}: kernel == dense in "
                  f"parents, levels, level_stats and counters; tree valid")
    check(n_over > 0, "no 1ds top-down level overflowed on the mesh leg")
    print("edges_examined of a kernel session is the frontier edge mass, "
          "so it equals the dense session's edges_useful")
    del small, small_val, sg

    # ---------------------------------------------------------------- 6
    phase("6 kernel times level by level on one 2D search")
    with recording([(sp_ops, "spmsv_csr_min", "spmsv_csr_min"),
                    (bu_ops, "bottomup_substep", "bottomup_substep")]
                   ) as calls:
        engine.search(roots[0])
    torch.cuda.synchronize()
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "calls": 0} for k in kernels}
    for lvl, (kname, a, _) in enumerate(calls):
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
            nbytes, n_live, read = bottomup_bytes(rp, uew, fw, cv)
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
    phase("7 profile of one 2D search")
    record["profile"] = profile_search(engine, roots[0])

    # ---------------------------------------------------------------- 8
    phase(f"8 1ds path: the same Graph500 graph on {STRIPS} simulated "
          f"strips, local_mode='kernel', storage='dcsc', packed codec, "
          f"expand_chunks {' and '.join(map(str, STRIP_CHUNKS))}")
    levels_2d = levels[:2]
    del engine, graph, edges, parents
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edges = rmat.rmat_graph(SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    graph = build_blocked_1d(edges, STRIPS, with_edge_lists=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    part = graph.part
    mesh = make_local_mesh_1d(STRIPS, device=dev)
    dense_words = np.float32((STRIPS - 1) * (part.n / 64.0))
    runs = {}
    for c in STRIP_CHUNKS:
        cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                        frontier_codec="packed", expand_chunks=c)
        eng = plan_bfs(graph, cfg, mesh, local_mode="kernel").compile()
        run = {"engine": eng, "search_ms": [], "levels": [], "modes": [],
               "overflowed": [], "wire_expand": [], "parents": []}
        for r in roots:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = eng.search(r)
            torch.cuda.synchronize()
            run["search_ms"].append((time.perf_counter() - ts) * 1e3)
            st = out[3][:out[1]]
            run["levels"].append(out[1])
            run["modes"].append([int(x) for x in st[:, 2]])
            run["overflowed"].append([i for i in range(out[1])
                                      if st[i, 2] == 0
                                      and st[i, 4] == dense_words])
            run["wire_expand"].append(float(out[2]["wire_expand"]))
            run["parents"].append(out[0].reshape(-1)[: part.n_orig])
        runs[c] = run
    launches_1ds = {k: kernels[k].launches for k in path_1ds}
    peak_1ds = torch.cuda.max_memory_allocated() / 2**30
    nnz = graph.nnz.tolist()
    cap_x = runs[STRIP_CHUNKS[0]]["engine"].plan.statics.cap_x
    print(f"n={edges.n} m={edges.m} p={part.p} chunk={part.chunk} "
          f"cap={graph.cap} (strip 0 holds {nnz[0] / edges.m:.4f} of the "
          f"edges; rmat_strip_skew {rmat_strip_skew(STRIPS):.4f}) "
          f"cap_nzc={graph.cap_nzc} "
          f"maxdeg_col={graph.maxdeg_col}; strip nnz {nnz}")
    print(f"generate + preprocess: {t1 - t0:.3f} s; build_blocked_1d: "
          f"{t2 - t1:.3f} s (peak {build_peak:.3f} GiB by the end of the "
          f"build); cap_x={cap_x}")
    rec_1ds = {"n": edges.n, "m": edges.m, "p": part.p, "cap": graph.cap,
               "cap_nzc": graph.cap_nzc, "nnz": nnz, "cap_x": cap_x,
               "gen_s": t1 - t0, "build_s": t2 - t1,
               "build_peak_gib": build_peak, "runs": {}}
    for c, run in runs.items():
        eng = run["engine"]
        rates = [teps(edges.m_input, ms / 1e3) for ms in run["search_ms"]]
        print(f"-- expand_chunks={c}: ship {eng.ship_s:.4f} s, compile "
              f"(kernel load + warm-up search) {eng.compile_s:.3f} s")
        for i, r in enumerate(roots):
            print(f"root {r:>9}: {run['levels'][i]} levels, modes "
                  f"{run['modes'][i]}, overflowed top-down levels "
                  f"{run['overflowed'][i]}, wire_expand "
                  f"{run['wire_expand'][i]}, search "
                  f"{run['search_ms'][i]:8.3f} ms, {rates[i]:.4e} TEPS")
        hm = harmonic_mean(rates)
        ms = run["search_ms"]
        print(f"expand_chunks={c}: harmonic-mean TEPS over {N_ROOTS} roots "
              f"{hm:.6e}; search ms median {float(np.median(ms)):.3f}, min "
              f"{min(ms):.3f}, max {max(ms):.3f}; wire_expand total over "
              f"the roots {sum(run['wire_expand'])}")
        rec_1ds["runs"][c] = {
            "ship_s": eng.ship_s, "compile_s": eng.compile_s,
            "search_ms": ms, "teps_hmean": hm, "levels": run["levels"],
            "modes": run["modes"], "overflowed": run["overflowed"],
            "wire_expand": run["wire_expand"]}
    print(f"peak device memory of the 1ds path (generation, build and "
          f"both sessions): {peak_1ds:.3f} GiB")
    print(f"launches in the 1ds path: {launches_1ds}")
    for k, n in launches_1ds.items():
        check(n > 0, f"kernel {k} was never launched on the 1ds path")
    check(peak_1ds < 75.0, f"1ds-path peak {peak_1ds:.2f} GiB >= 75 GiB")
    t3 = time.perf_counter()
    validator = TreeValidator(edges.n, edges.src, edges.dst)
    for c, run in runs.items():
        for r, par in zip(roots, run["parents"]):
            ok, msg = validator.check(r, par)
            check(ok, f"1ds expand_chunks={c} tree of root {r}: {msg}")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t3
    print(f"validated {len(runs) * N_ROOTS} trees on the card in "
          f"{val_s:.3f} s")
    del validator
    c0, c1 = STRIP_CHUNKS
    for i, r in enumerate(roots):
        check(torch.equal(runs[c0]["parents"][i], runs[c1]["parents"][i])
              and runs[c0]["levels"][i] == runs[c1]["levels"][i],
              f"expand_chunks {c0} and {c1} differ at root {r}")
    print(f"expand_chunks {c0} and {c1}: parents and levels identical on "
          f"all {N_ROOTS} roots")
    for i, r in enumerate(roots[:2]):
        check(torch.equal(runs[c0]["parents"][i].cpu(), parents_2d[i])
              and runs[c0]["levels"][i] == levels_2d[i],
              f"1ds parents or levels differ from the 2D path's at root {r}")
    print("1ds parents and levels equal the 2D path's on 2 roots")
    # the dense fallback at full size: buckets of OVER_CAP ids overflow
    # on the wider top-down levels, which then ship the bitmap
    over_rec = {}
    for c in STRIP_CHUNKS:
        cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                        frontier_codec="packed", expand_chunks=c)
        eng = plan_bfs(graph, cfg, mesh, local_mode="kernel",
                       cap_x=OVER_CAP).compile()
        for i, r in enumerate(roots[:2]):
            out = eng.search(r)
            st = out[3][:out[1]]
            over = [j for j in range(out[1])
                    if st[j, 2] == 0 and st[j, 4] == dense_words]
            check(len(over) > 0,
                  f"cap_x={OVER_CAP} overflowed no level, root {r}")
            check(torch.equal(out[0].reshape(-1)[: part.n_orig],
                              runs[c]["parents"][i]),
                  f"cap_x={OVER_CAP} parents differ at root {r}")
            over_rec[f"{c}/{r}"] = over
            print(f"cap_x={OVER_CAP}, expand_chunks={c}, root {r}: overflowed "
                  f"top-down levels {over} of modes "
                  f"{[int(x) for x in st[:, 2]]}, wire_expand "
                  f"{float(out[2]['wire_expand'])}: parents equal the "
                  f"planned-cap run's")
        del eng
    rec_1ds["overflow_small_cap"] = {"cap_x": OVER_CAP, "levels": over_rec}
    for run in runs.values():
        del run["parents"]
    torch.cuda.empty_cache()
    rec_1ds.update(peak_gib=peak_1ds, validate_s=val_s,
                   launches=launches_1ds)
    record["session_1ds"] = rec_1ds

    # ---------------------------------------------------------------- 9
    phase("9 1ds kernels level by level on one search per expand_chunks: "
          "each call against its plain version (tolerance 0), and timed")
    from repro_torch.kernels.frontier_codec import ref as codec_ref
    targets = [(strip, "spmsv_strip_dcsc", "spmsv_strip_min"),
               (strip, "spmsv_strip_dcsc_chunk", "spmsv_strip_chunk_min"),
               (codec_ops, "encode_offsets", "codec_encode"),
               (codec_ops, "decode_buckets", "codec_decode"),
               (bu_ops, "bottomup_substep", "bottomup_substep")]
    per_1ds = {c: {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "library_ms": 0.0, "calls": 0}
                   for _, _, k in targets} for c in STRIP_CHUNKS}
    nr = part.chunk

    def strip_call(kname, a, kw, label, row):
        """Compare one strip SpMSV call with its plain version and time
        kernel, plain and the library scatter."""
        jc, cp, nzc, ridx, words = a[:5]
        n_front = popcount(words)
        if kname == "spmsv_strip_min":
            live = strip.live_slots(jc, nzc, words)

            def run_k():
                return strip.launch(*a)

            def run_p():
                return strip.spmsv_strip_dcsc_plain(*a)
        else:
            live = strip.live_slots_chunk(jc, nzc, words, kw["k"],
                                          kw["n_chunks"], part.chunk,
                                          part.n)

            def run_k():
                return strip.launch_chunk(*a, kw["n"], kw["k"],
                                          kw["n_chunks"])

            def run_p():
                return strip.spmsv_strip_dcsc_chunk_plain(
                    *a, kw["n"], kw["k"], kw["n_chunks"])
        got, want = run_k(), run_p()
        e = max(max_err(got[0], want[0]), abs(int(got[1]) - int(want[1])))
        rows_, cols_, total = strip.gather_segments_plain(jc, cp, ridx,
                                                          live, nr)

        def run_lib():
            torch.full((jc.shape[0] * nr,), INT_INF, dtype=torch.int32,
                       device=dev).scatter_reduce_(0, rows_, cols_, "amin")
        k_ms, p_ms = cuda_ms(run_k), cuda_ms(run_p, reps=1)
        lib_ms = cuda_ms(run_lib, reps=5)
        nbytes = strip_bytes(nzc, jc.shape[1], live, total, words.numel(),
                             n_front, nr)
        if row is not None:
            row["library_ms"] += lib_ms
        print(f"  {label}: {n_front} frontier vertices, {int(live.sum())} "
              f"live columns, {total} edges: "
              f"max |kernel - plain| = {e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({nbytes} bytes)")
        return e, k_ms, p_ms, nbytes

    big_fw = None
    for c in STRIP_CHUNKS:
        eng = runs[c]["engine"]
        with recording(targets) as calls:
            eng.search(roots[0])
        torch.cuda.synchronize()
        print(f"-- expand_chunks={c}, root {roots[0]}: {len(calls)} calls")
        for i, (kname, a, kw) in enumerate(calls):
            if kname == "bottomup_substep" and c != STRIP_CHUNKS[0]:
                continue          # the same bottom-up levels as above
            row = per_1ds[c][kname]
            row["calls"] += 1
            label = f"call {i} {kname}"
            if kname in ("spmsv_strip_min", "spmsv_strip_chunk_min"):
                e, k_ms, p_ms, nbytes = strip_call(kname, a, kw, label, row)
            elif kname == "codec_encode":
                off, count, chunk = a
                got = codec_ops.launch_encode(off, count, chunk)
                e = max_err(got, codec_ref.encode_offsets(off, count, chunk))
                k_ms = cuda_ms(lambda: codec_ops.launch_encode(*a))
                p_ms = cuda_ms(lambda: codec_ref.encode_offsets(*a), reps=1)
                nbytes = encode_bytes(count, off.shape[1], got.numel())
                print(f"  {label}: {off.shape[0]} buckets of {off.shape[1]} "
                      f"slots, {int(count.sum())} ids: max |kernel - plain| "
                      f"= {e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
                      f"({nbytes} bytes)")
            elif kname == "codec_decode":
                recv, chunk, cap, n, p_ = a
                got = codec_ops.launch_decode(*a)
                e = max_err(got, codec_ref.decode_buckets(recv, chunk, cap,
                                                          n))
                k_ms = cuda_ms(lambda: codec_ops.launch_decode(*a))
                p_ms = cuda_ms(lambda: codec_ref.decode_buckets(
                    recv, chunk, cap, n), reps=1)
                nbytes = decode_bytes(recv, p_, cap, codec_bits(chunk))
                print(f"  {label}: {p_} buckets of {cap} slots: max |kernel "
                      f"- plain| = {e}; kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({nbytes} "
                      f"bytes)")
            else:
                rp, uew, fw, cv, coff, ne = a
                if big_fw is None:
                    big_fw = fw
                got = bu_ops.launch(*a)
                want = bu_ops.bottomup_substep_plain(*a)
                e = max_err(got, want)
                del got, want
                k_ms = cuda_ms(lambda: bu_ops.launch(*a))
                p_ms = cuda_ms(lambda: bu_ops.bottomup_substep_plain(*a),
                               reps=1)
                nbytes, n_live, read = bottomup_bytes(rp, uew, fw, cv)
                print(f"  {label} (strip window of {ne} edges): {n_live} "
                      f"live rows, {read} edges read to the first hit: max "
                      f"|kernel - plain| = {e}; kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
            errs[kname] = max(errs[kname], e)
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bound_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
    # a large frontier of a real level: the frontier a bottom-up level
    # of the recorded search received, through both strip kernels
    jc, cp, nzc, ridx = graph.jc, graph.cp, graph.nzc, graph.row_idx
    if big_fw is None:
        g = torch.Generator(device=dev).manual_seed(3)
        big_fw = pack_bits(torch.rand(part.n, generator=g, device=dev) < 0.3)
        print("-- no bottom-up level in the recorded search: a random 30% "
              "frontier stands in for a large one")
    else:
        print("-- the frontier of the recorded search's first bottom-up "
              "level, through the top-down strip kernels")
    e, *_ = strip_call("spmsv_strip_min", (jc, cp, nzc, ridx, big_fw, nr),
                       {}, "spmsv_strip_min, large frontier", None)
    errs["spmsv_strip_min"] = max(errs["spmsv_strip_min"], e)
    c = STRIP_CHUNKS[-1]
    subs = big_fw.reshape(part.p, c, -1)
    for k in range(c):
        sub = subs[:, k].reshape(-1).contiguous()
        e, *_ = strip_call(
            "spmsv_strip_chunk_min", (jc, cp, nzc, ridx, sub, nr),
            {"n": part.n, "k": k, "n_chunks": c},
            f"spmsv_strip_chunk_min, large frontier, step {k} of {c}", None)
        errs["spmsv_strip_chunk_min"] = max(errs["spmsv_strip_chunk_min"], e)
    for c in STRIP_CHUNKS:
        spmsv = "spmsv_strip_min" if c == 1 else "spmsv_strip_chunk_min"
        for k in (spmsv, "codec_encode", "codec_decode"):
            check(per_1ds[c][k]["calls"] > 0,
                  f"no {k} call recorded in the expand_chunks={c} search")
    for k in path_1ds:
        check(errs[k] == 0, f"{k} disagrees with its plain version (max err "
                            f"{errs[k]})")
    print("the 1ds path's kernels equal their plain versions (tolerance 0)")
    for c in STRIP_CHUNKS:
        for k, r in per_1ds[c].items():
            if r["calls"]:
                print(f"expand_chunks={c} {k}: {r['calls']} launches in one "
                      f"search: kernel {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms"
                      + (f", library {r['library_ms']:.4f} ms"
                         if k.startswith("spmsv") else ""))
    for k in ("spmsv_strip_min", "codec_encode", "codec_decode"):
        per[k] = per_1ds[STRIP_CHUNKS[0]][k]
    per["spmsv_strip_chunk_min"] = per_1ds[STRIP_CHUNKS[-1]][
        "spmsv_strip_chunk_min"]
    record["kernel_times_1ds"] = per_1ds

    # --------------------------------------------------------------- 10
    phase("10 profile of one 1ds search per expand_chunks")
    record["profile_1ds"] = {}
    for c in STRIP_CHUNKS:
        print(f"-- expand_chunks={c}, root {roots[0]}")
        record["profile_1ds"][c] = profile_search(runs[c]["engine"],
                                                  roots[0])

    record["total_s"] = time.perf_counter() - t_start
    print(f"total {record['total_s']:.1f} s")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    line = {"kernels": [{
        "name": k, "route": "cuda",
        "source": str(kernels[k].source.relative_to(ROOT)),
        "replaces": replaces[k],
        "launches": launches.get(k, 0) + launches_1ds.get(k, 0),
        "max_abs_err": errs[k], "ms": per[k]["ms"],
        "plain_ms": per[k]["plain_ms"], "bound_ms": per[k]["bound_ms"],
        "bound_by": ("operations" if k == "rmat_counter" and ro > rb
                     else "bytes"),
        "library_ms": (per[k]["library_ms"] if k.startswith("spmsv")
                       else None),
    } for k in kernels]}
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
