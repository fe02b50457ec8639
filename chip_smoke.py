#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and hold
every kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py    # Graph500 scale 24, then the serving paths,
                             # smollm-135m prefill_32k and training

Phases, in the order they run:
  1 device       name, count, versions, nvidia-smi name and power limit
  2 build        nvcc of the eleven kernel sources (thirteen C entries:
                 kernel 1 has three addressings; 8b and 9b are the
                 gradients of 8 and 9) and the integer-rate
                 benchmark (in parallel), ptxas report; kernel 7's
                 instructions per level in the SASS of its scale-24
                 build, and the integer
                 instruction rate the card reaches on its level body
                 (csrc/int_rate.cu), which kernel 7's bound uses unless
                 the kernel itself issues faster (phase 6); kernel 5's
                 SASS instructions per output word, and no division
  3 2D path      one Graph500 session at full width on the 2D grid 1x1:
                 counter R-MAT (kernel) -> preprocess -> build_blocked ->
                 plan_bfs(local_mode="kernel") -> compile -> 16 roots,
                 launch counts read around exactly this; every tree
                 validated on the card; the same 16 roots right after
                 with instrument=False, parents and levels bit-identical,
                 both TEPS, median search ms and host reads a search; two
                 roots again through local_mode="dense", parents
                 bit-identical
 3b 2D archs     the registered bfs-rmat (2d, dcsc, reduce fold) on the
                 same graph and roots, through kernel 1's DCSC entry;
                 then bfs-rmat-fast, bfs-rmat-opt-rt (the exact bitmap
                 fold and compact updates, the dense exchanges on this
                 mesh) and bfs-rmat-pipe (R/G ring counters): each search
                 timed, parents
                 and levels bit-identical to the csr session's (bfs-rmat)
                 and to bfs-rmat's (the rest), every tree validated, host
                 reads a search; storage_words of both modes
 3c multiroot    bfs-rmat-multiroot: the 16 roots over 2 pods of the 1x1
                 grid (run_batch, the kernels as the single-root session
                 runs them), instrumented and with instrument=False:
                 parents equal bfs-rmat's, trees valid, n_levels the
                 max of each scan position, stats columns 0-1 equal on a
                 root's own levels (the modes that differ counted: 2d
                 shares the decision); the batch beside run_many, host
                 reads a search, peak memory
 3d born 2D     dist_build(BuildSpec(24, 16, 1), "2d") on the 1x1 grid:
                 every field torch.equal to phase 3's build_blocked graph,
                 m and the capacities equal; its build seconds beside phase
                 3's, the route words, peak memory with phase 3 resident;
                 then BFSConfig()'s kernel session over it on the 16 roots,
                 run_many(validate=True): parents and levels equal phase
                 3's, every verdict clean
  4 kernels      the 2D path's kernels against their plain versions at
                 its shapes, tolerance 0 (the outputs are integers)
 4b kernel 1     its DCSC entry on the frontiers of one bfs-rmat search
                 (its calls under sync debug mode "error": no host read)
                 against its plain version and the col_ptr entry on the
                 same frontiers, tolerance 0; each entry timed whole (the
                 prep kernel and the walk) on the card alone and
                 host-timed, beside its plain version, scatter_reduce_ and
                 its bound (ops.forward_cost)
  5 meshes       simulated 2x2 and 4x4 grids and a 16-strip 1d/1ds leg
                 (both codecs, 1 and 4 expand steps, an overflowing
                 bucket capacity) at scale 16, and every registered 2D
                 arch on both grids (the "*_pure" folds unvalidated, as
                 they drop by design): kernel and dense sessions agree in
                 parents, levels, stats, counters
 5b schedule     the collective-schedule checks on the card:
                 ``lint_registry()`` (R1-R3 on every LocalOps combo's
                 pod-batched search at scale 9, the kernel entries among
                 them, R4 over the 18 budget cases), R1 flagging the
                 broken 2D fixture in both instrument modes, phase 3's
                 csr sessions (instrumented and not) held level by level
                 to their budgets under a recorder (phase 8 does the same
                 for its strips at expand_chunks 1 and 4), and the 16
                 roots timed with and without a recorder (the ratio)
  6 kernel times level by level on one 2D search: kernel, plain,
                 library yardstick and bound, each in ms (kernel 2 on
                 the card alone, per launch beside its bound; kernel 1's
                 entry whole, on the card alone and host-timed, its calls
                 under sync debug mode "error"); kernel 2
                 on the synthetic cases of kernels/edge_cases.py at the
                 path's width, tolerance 0
  7 profile      device busy and idle share of one 2D search,
                 instrumented and with instrument=False
  8 1ds path     the same Graph500 graph on a 16-strip simulated mesh:
                 counter R-MAT -> build_blocked_1d -> plan_bfs("1ds",
                 "kernel", "dcsc", packed codec) -> compile -> 16 roots,
                 with expand_chunks 1 and then 4, launch counts read
                 around exactly this, one bottom-up launch a bottom-up
                 level; the same roots with instrument=False at each
                 expand_chunks, as in phase 3; every tree validated on
                 the card,
                 the two runs' parents identical, and on 2 roots parents
                 and levels equal to the 2D path's; then 2 roots with
                 buckets of 64 ids, whose wider top-down levels take the
                 dense fallback, with the same parents; then 2 roots per
                 expand_chunks top-down only (the paper's 1D baseline),
                 with the same parents; the walk each kernel-3 and
                 kernel-4 call of these searches takes, and the calls
                 near the walk threshold timed with each walk forced
 8b csr strips   the same strips, built with the (p, n+1) strip col_ptr,
                 on the 16 roots: bfs-rmat-1d and bfs-rmat-1ds through
                 kernel 1's strip entry, each beside its dcsc twin
                 (bfs-rmat-1d-dcsc, and bfs-rmat-1ds on storage dcsc:
                 kernel 3), then bfs-rmat-1ds-pipe and bfs-rmat-1d-pipe
                 (kernel 1 on each sub-chunk's partial bitmap); parents
                 and levels equal to the dcsc strips', trees validated,
                 search ms and host reads, the csr - dcsc difference root
                 by root, storage_words of both modes, peak under 75 GiB
 8c 1ds batch    phase 8's 1ds dcsc session at expand_chunks 1 over 2
                 pods of the 16 strips, the same roots: parents, n_levels
                 as in 3c, stats columns 0-2 equal each root's single run
                 (each pod switches on its own frontier), beside run_many
 8d cap_f        bfs-rmat-1d with cap_f below a top-down frontier raises;
                 with cap_f at the widest, 8b's parents
  9 kernels      level by level on one 1ds search per expand_chunks:
                 each kernel call (the frontiers, sub-chunks and buckets
                 of real levels, and the large frontier of a bottom-up
                 level) against its plain version, tolerance 0, kernel 3
                 with each walk forced as well, and its time beside the
                 plain version's, the library yardstick and the bound
                 (kernels 2-5 on the card alone, kernel 5 beside the
                 zero-fill of its words); the walk each strip
                 SpMSV call took, as the kernel reports it, both walks of
                 kernels 3 and 4 required over phases 8-9; then kernels
                 2-4 on the synthetic cases at the path's widths,
                 kernels 3 and 4 with each walk forced
 9b kernel 1     its strip entry on the frontiers of one bfs-rmat-1d
                 search (under sync debug mode "error") against its plain
                 version and kernel 3 on the same frontiers, tolerance 0;
                 the entry timed whole as in 4b, kernel 3 on the card
                 alone
 10 profile      device busy and idle share of one 1ds search per
                 expand_chunks, instrumented and with instrument=False
 8g born strips  (after phase 10, once phase 8's graph is digested and
                 released) dist_build(BuildSpec(24, 16, 1), "1ds") on 16
                 strips: m, cap, cap_nzc, maxdeg_col and the digests of the
                 fields both graphs carry equal phase 8's; the route words
                 beside build_route_1d_words and the padded exchange's;
                 peak memory; the 1ds dcsc C=1 session on phase 8's roots,
                 parents and levels equal; then route_slack =
                 undersize_route_slack(0), healed within 3 attempts to the
                 same digests
 10c store       a born scale-20 graph on a 2x2 grid saved to a GraphStore
                 under build/ (bytes, save s), loaded into a kernel session
                 (load s) whose parents equal the born graph's on 16 roots;
                 a flipped and a truncated shard quarantined and
                 regenerated on the card to the stored CRC (load and
                 regeneration s); then run_fault_matrix on the card on 1
                 and 4 simulated devices, 22 of 22 cases ok
 10b drivers     python -m repro_torch.examples.graph500_bfs at scale 20
                 (2d, 2d --fast, 1ds on 16 strips with dcsc), quickstart
                 and serve_lm, each a process of its own on the card:
                 exit 0 and their TEPS or served line; then graph500_bfs
                 --scale 20 --born --store DIR twice in 2d 1x1 and in 1ds
                 16x1 dcsc: build and save, then load, the same roots and
                 level counts in all four runs; DRIVER_LANES processes at
                 a time (here and in phases 18 and 20), a layout's two
                 runs in turn
 11 AutoInt      the registered autoint config (11,238,400-row table)
                 scoring the three recsys shapes: 200 serve_p99 batches,
                 4 serve_bulk batches, 16 retrieval_cand queries against
                 1M candidates; the lookup through kernel 8 as bags of
                 one; logits equal the plain lookup's bit for bit
 12 kernel 8     against its plain version, tolerance 0, at the path's
                 shapes and multi-hot (f32/bf16, sum/mean, weighted or
                 not), with times, F.embedding(_bag) and the bound; its
                 public entry host-timed beside F.embedding; a bf16 table
                 and one of D 32 at the serve_bulk shape
 13 smollm-135m  the registered config served through Server: 8
                 requests, 32 new tokens each, attention through kernel
                 9; prefill and teacher-forced decode logits against the
                 plain-attention path within LOGIT_TOL_BF16
 14 kernel 9     against its plain version within ``ref.tolerance`` at
                 the path's calls and over the JAX test's sweep plus a
                 window-4096 shape, with times, SDPA, the bound, each
                 decode launch's blocks and the shortest decode timed
                 with 32 and 16 keys a split at least; head dims 80
                 (padded to 128) and 160, 256, 320 (the wide kernel)
                 on each path's shape, timed beside dh 64 and 128
 15 profiles     busy share and top kernels of one serve_p99 batch, one
                 serve_bulk batch and one decode step
 16 prefill_32k  smollm-135m at the registered width: one prefill of 32
                 x 32,768 random tokens into a 32,768-long cache, launch
                 count read around exactly this; its time, attention's
                 share (kernel 9 at layer 0, alone, x 30 layers), peak
                 memory and a profile of one more pass; layer 0's call
                 of kernel 9 launched again at its full shape, its first
                 and last 128 query rows of sequences 0 and 31 against
                 the plain version, and timed beside the plain version
                 (in pieces), SDPA and the bound
17 kernels 8b/9b the backward kernels against their plain versions:
                 8b at AutoInt's train_batch lookup (65,536 x 39 bags of
                 one, float32, the registered table's 11.2M rows) and
                 multi-hot (bf16, weights, pads, mean), tolerance 0 on CPU
                 copies, each shape's public entry twice under sync debug
                 mode "error" (no host read), the two bit for bit; its
                 key kernel, radix sort and tile kernel against their
                 plain twins; the entry timed on the card alone and
                 host-timed, each of its four kernels on the card alone;
                 9b at smollm-135m's training call (B 8, S 1024,
                 9/3 heads of 64, bf16, causal), float32, a window and a
                 q_offset, with kernel 9's saved log-sum-exp and without
                 it, within ``ref.backward_tolerance``, two calls bit for
                 bit; each timed beside its plain version, its library
                 call (embedding_dense_backward; SDPA's backward, its
                 backend pinned and named, 9b and SDPA in turns as
                 single calls: median, min, max) and bound
 18 training     smollm-135m at the registered width (bf16, remat full,
                 AdamW float32 state): B 8 x S 1024 for 20 steps through
                 the Trainer, checkpointing at step 10, then a second run
                 resumed from step 10: step ms, tokens/s, the loss at
                 steps 0, 10, 19 (falling), the resumed losses, params
                 and moments bit for bit, peak < 24 GiB; AutoInt at the
                 registered width, 65,536 rows for 20 steps (the table
                 trained densely): step ms, rows/s, losses, peak < 30 GiB;
                 kernels 9 and 9b, or 8 and 8b, launched on every step and
                 no plain version called (a tripwire); DevicePrefetcher's
                 batches on the card; then launch.train (smollm-135m
                 --full for 4 steps, autoint and bfs-rmat at the
                 launcher's defaults) and examples.train_lm as processes
                 of their own
 19 new LMs      (a) qwen3-moe-30b-a3b at the registered width and depth
                 (48 layers, 128 experts top-8, bf16, seeded layer by
                 layer; under 2 GiB allocated as it starts) served through
                 Server: 8 requests, 32 new tokens each; prefill ms,
                 decode ms a step, tokens/s, peak < 72 GiB; the plain-
                 attention path's logit gaps printed; each layer, fed the
                 kernel path's input, held kernel 9 against the plain
                 attention within MOE_LAYER_TOL on the tokens whose expert
                 sets agree, the flipped share at most MOE_FLIP_MAX, and
                 the whole model's flips and logit gap printed; (b)
                 mixtral-8x22b at the registered width cut to 8 of 56
                 layers: a 6,144-token prompt (the 4,096 window masks
                 keys) and 16 decode steps, held the same way; (c)
                 stablelm-3b and starcoder2-7b at the registered widths
                 and depths, 4 requests each, held end to end within
                 LOGIT_TOL_BF16 (layer by layer where a full-depth gap
                 exceeds it, and so printed); (d) kernel 9 at each
                 config's first prefill and last decode call against its
                 plain version, the first and last 128 query rows; (e)
                 the simulated 2x4 mesh at qwen3's widths:
                 moe_ep_shardmap over 4,096 tokens against _moe_reference
                 and the drops at capacity_factor 1.0, moe_decode_psum,
                 the row-sharded AutoInt lookup at serve_bulk's ids on 4
                 model shards bit for bit, dp_step's three modes on 4
                 replicas within the JAX test's convergence bounds; each
                 exchange counted by a ScheduleRecorder
 20 MoE training qwen3-moe-30b-a3b at the registered width cut to 1 of
                 48 layers (AdamW's moments of the whole model are 242
                 GB): B 4 x S 1,024 for 20 steps through the Trainer,
                 checkpointing at step 10, resumed from step 10 bit for
                 bit; the loss falling, peak < 56 GiB, kernels 9 and 9b
                 every step and no plain version (the tripwire); the same
                 run under qwen3-moe-r1 (remat "dots"), its losses beside;
                 then launch.serve --arch qwen3-moe-30b-a3b and
                 launch.train --arch mixtral-8x22b at their reduced
                 defaults as processes of their own
 21 GNN          the four GNN archs at the registered widths through
                 launch.train's gnn_setup, each 20 steps through the
                 Trainer and resumed from step 10 bit for bit (losses,
                 params, moments), step ms, edges/s, peak: (a) gin-tu on
                 ogb_products (2,449,029 nodes, 61,859,140 edges made by
                 kernel 7 on the card, d_feat 100), peak < 72 GiB, one
                 sorted segment sum beside the atomic index_add_, a
                 profiled step by what its kernels do, kernel 7's stream
                 against its plain version at both ends; (b) gat-cora on
                 full_graph_sm and meshgraphnet on minibatch_lg (1,024
                 seeds at fanout (15, 10) sampled from the 114.6 M-edge
                 CSR kernel 7 makes); (c) mace on molecule; (d) spmm_2d on
                 the ogb_products graph at d 64 on 1x1 and 4x4 against
                 index_add_, timed, its exchanges recorded; (e) each
                 arch's first step on the smoke graph, card against CPU;
                 no plain version of kernel 7 on the path (a tripwire);
                 launch.train --arch gin-tu and examples.gnn_full_graph
                 run with phase 18's drivers
 22 dry-run      the dry-run and roofline tooling: (a) python -m
                 repro_torch.launch.dryrun --cells all --mesh both in
                 DRYRUN_JOBS processes (every cell traced on meta on the
                 16x16 and 2x16x16 meshes, the BFS level steps, the eight
                 hill-climb records), exit 0 and a record each, the
                 report's two tables; (b) the 1x1 cells the card holds at
                 their registered size (CARD_CELLS), each counted on meta
                 and then run on the card with seeded inputs under the
                 same counter: FLOPs and bytes equal, the reckoned peak
                 within 10% or 512 MiB of max_memory_allocated, step ms
                 (median of 5 after 2), bound, roofline share <= 1, MFU;
                 (c) gin-tu-2d on ogb_products at full width on the
                 simulated 4x4 grid over phase 21a's graph, 10 steps: the
                 first loss within 1e-4 of gin-tu 1x1's, the loss
                 falling, peak < 60 GiB, the recorded exchanges against
                 comm_model's expand and fold volumes; (d) mace-2d on
                 full_graph_sm on 2x2, the card against the CPU; the
                 kernels' launches counted around the phase
Then the card's name and power limit, the ``kernels`` JSON line and the
result line.  ``python3 chip_smoke.py --backward`` runs phase 17 alone
(its checks and times, no result line); ``--moe`` runs phases 19-20
alone; ``--gnn`` phase 21 alone, with its two drivers; ``--dryrun``
phase 22 alone (building 22c's graph itself).

    python3 chip_smoke.py --kernel-times [--tree DIR]

times kernels 1-9 on the card alone: 1-6 at the scale-24 paths' calls
(kernel 1's entry whole, prep included, as the level steps call it, and
host-timed; on the 2D csr search, bfs-rmat and bfs-rmat-1d, each with
its synchronizing calls a search counted in sync debug mode "warn"; the
2D csr session's median search ms over the 16 roots)
(5 and 6 host-timed as well, and beside the zero-fill of their output;
kernel 5's SASS per output word), each search whole, kernel 7 on the
full scale-24 stream (also host-timed), kernel 8 at the AutoInt shapes (on the
card alone, and its public entry host-timed beside F.embedding) and
kernel 9 at dh 64, 80 and 128 on its three paths' shapes, for this
checkout or another one (``DIR``, for example a
``git archive`` of a parent commit, so that two trees compare on one
card in one call); see ``kernel_times``.  Any failed check
exits non-zero; nothing is caught.  It exits non-zero without a CUDA
card, and where the repository's ``src`` is missing.  The full record
goes to ``chiprun_out/chip_smoke.json``.  Each phase's banner shows the
seconds since the start; the seconds a phase are printed before the
card's line and kept as the record's ``phase_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's figures (H100 SXM data sheet, 700 W) from the package, which
# the dry-run's roofline prices with too: HBM3's bytes/s, the dense bf16
# tensor-core FLOP/s and float32's outside the tensor cores (kernel 9b's
# bound on float32 inputs)
from repro_torch.launch.roofline import FP32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402

SCALE = 24
EDGE_FACTOR = 16
SEED = 1
N_ROOTS = 16
PODS = 2                      # run_batch's pod axis (phases 3c, 8c)
MESH_SCALE = 16
STRIPS = 16                   # the 1ds path's simulated mesh
STRIP_CHUNKS = (1, 4)         # its expand_chunks runs
OVER_CAP = 64                 # a bucket capacity that makes levels overflow
STORE_SCALE = 20              # phase 10c: 4 shards of a 2x2 grid on disk
HEAL_ATTEMPTS = 12            # phase 8e: undersize_cap(52448) = 3264 doubles
#                               to the 2**20-vertex chunk in 9 steps
# 32-bit integer instructions: a GH100 SM has 64 INT32 lanes (against 128
# FP32 lanes), and the CUDA C++ programming guide's throughput table gives
# 64 results per clock per SM at compute capability 9.0 for 32-bit integer
# add, multiply-add, shift, logic and compare: every instruction of
# rmat_counter's fmix32 loop (IMAD, SHF, LOP3, ISETP).  Times the card's
# SM count and its maximum SM clock (nvidia-smi) this is the integer
# kernels' peak; phase 2 measures the rate the card reaches on kernel 7's
# own level body (csrc/int_rate.cu), and kernel 7's bound uses that or
# the kernel's own issue rate, whichever is larger (phase 6)
INSTR_PER_CLOCK_PER_SM = 64
RMAT_INSTR_PER_EDGE_LEVEL = 9  # the least per edge and level, rmat_counter.cu
INT_RATE_ITERS = 4096          # loop iterations of one int_rate launch
INT_RATE_LAUNCHES = 10
TIMED_REPS = 20


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


_T0 = time.perf_counter()
PHASE_S: dict = {}               # seconds of each phase, by its number
_open_phase = [None, _T0]


def phase(title: str) -> None:
    """Print the phase's banner with the seconds since the script
    started, and charge the seconds since the last banner to the phase
    that it opened (the record's ``phase_s``)."""
    now = time.perf_counter()
    close_phase(now)
    _open_phase[:] = [title.split()[0], now]
    print(f"\n== {title} == [+{now - _T0:.1f} s]", flush=True)


def close_phase(now: float) -> None:
    """Charge the open phase its seconds up to ``now``."""
    key, since = _open_phase
    if key is not None:
        PHASE_S[key] = PHASE_S.get(key, 0.0) + now - since
    _open_phase[:] = [None, now]


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


def sass(lib: Path) -> str:
    from repro_torch.kernels import build
    return subprocess.run(
        [str(Path(build.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, timeout=120,
        check=True).stdout


def sass_function(text: str, name: str) -> str:
    """The SASS of the one function whose mangled name holds ``name``."""
    for part in text.split("Function : ")[1:]:
        if name in part.splitlines()[0]:
            return part
    raise ValueError(f"no function {name} in the SASS")


def sass_instructions(text: str) -> int:
    """The instructions in a SASS listing, the NOPs that pad it left
    out."""
    n = 0
    for line in text.splitlines():
        t = line.strip()
        if t.startswith("/*") and not t.startswith("/* 0x") and "*/" in t:
            op = t[t.index("*/") + 2:].split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op and op[0][:1].isalpha() and not op[0].startswith("NOP"):
                n += 1
    return n


def sass_addresses(text: str, pattern: str):
    """The addresses of the SASS instructions whose line holds
    ``pattern``."""
    return [_address(line) for line in text.splitlines()
            if pattern in line and line.strip().startswith("/*")]


def _address(line: str) -> int:
    t = line.strip()
    return int(t[2:t.index("*/")], 16)


def sass_loop_instructions(text: str) -> int:
    """Instructions of the SASS's one loop: from the target of its
    backward branch to the branch, 16 bytes each."""
    for line in text.splitlines():
        parts = line.split()
        if "BRA" in parts and line.strip().startswith("/*"):
            at = _address(line)
            to = int(parts[parts.index("BRA") + 1].rstrip(";"), 16)
            if to < at:
                return (at - to) // 16 + 1
    raise ValueError("no backward branch in the SASS")


def encode_sass(lib: Path, codec) -> dict:
    """The static SASS of kernel 5's ``codec_encode_kernel`` in ``lib`` at
    the 1ds path's widths (20 bits at expand_chunks 1, 18 at 4): its
    instructions, and those over the words one thread writes: one word in
    a design that gives a thread a word, ``bits`` in one that gives it 32
    slots (``codec.THREAD_SLOTS``, one instantiation per width); and the
    library's MUFU.RCP and CALL instructions, which a division by a
    runtime value compiles to (a reciprocal estimate; a 64-bit one also
    calls a subroutine)."""
    text = sass(lib)
    per_thread = hasattr(codec, "THREAD_SLOTS")
    n, per_word = {}, {}
    for b in (20, 18):
        name = f"codec_encode_kernelILi{b}E" if per_thread \
            else "codec_encode_kernel"
        n[b] = sass_instructions(sass_function(text, name))
        per_word[b] = n[b] / (b if per_thread else 1)
    return {"instructions": n, "per_word": per_word,
            "mufu_rcp": text.count("MUFU.RCP"), "calls": text.count("CALL")}


def encode_sass_line(rec: dict) -> str:
    return ("codec_encode_kernel SASS: " + ", ".join(
        f"{rec['instructions'][b]} instructions at {b} bits, "
        f"{rec['per_word'][b]:.2f} an output word" for b in rec["per_word"])
        + f" (static count over the words a thread writes); "
        f"{rec['mufu_rcp']} MUFU.RCP, {rec['calls']} CALL in the library")


def measure_int_rate(lib: Path, n_sm: int) -> dict:
    """The thread instructions per clock per SM that the card reaches on
    rmat_counter's own level body (csrc/rmat_level.cuh, looped by
    csrc/int_rate.cu): a full grid of it timed
    with CUDA events, its instructions counted in its SASS, the SM clock
    sampled with nvidia-smi while the launches run."""
    import ctypes

    from repro_torch.graph import rmat
    lib_c = ctypes.CDLL(str(lib))
    fn = lib_c.int_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] + [ctypes.c_uint] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    text = sass(lib)
    per_iter = sass_loop_instructions(text)
    imad = sass_addresses(text, "0x7feb352d")
    levels = len(imad)
    salts = (ctypes.c_uint * levels)(*rmat.kernel_salts(SEED, levels))
    t1, t2, t3 = rmat.rmat_thresholds(0.57, 0.19, 0.19)
    blocks, threads = n_sm * 8, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(out.data_ptr(), blocks, threads, INT_RATE_ITERS, salts, t1,
                 t2, t3, stream)
        check(err == 0, f"int_rate: CUDA error {err}")
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(INT_RATE_LAUNCHES):
        run()
    end.record()
    mhz = float(smi("clocks.sm", "csv,noheader,nounits"))  # under load
    end.synchronize()
    ms = start.elapsed_time(end) / INT_RATE_LAUNCHES
    instr = blocks * threads * INT_RATE_ITERS * per_iter
    rate_max = instr / (ms / 1e3) / n_sm / (
        float(smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6)
    rate = instr / (ms / 1e3) / n_sm / (mhz * 1e6)
    return {"levels": levels, "instr_per_iter": per_iter,
            "instr_per_level": per_iter / levels, "ms": ms,
            "sm_mhz_under_load": mhz, "per_clock_per_sm": rate,
            "per_clock_per_sm_at_max_clock": rate_max}


@contextlib.contextmanager
def recording(targets, every: int = 1, clone: bool = False):
    """Record the calls of the given module functions, ``(module,
    attribute, label)``, while the block runs: a list of (label, args,
    kwargs) of every ``every``-th call.  With ``clone`` the tensor
    arguments are copied as the call sees them, so that later writes
    (a KV cache filled by the next batch) do not change them.  The
    calls still run."""
    calls = []
    seen = [0]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def copy(x):
        return x.clone() if clone and isinstance(x, torch.Tensor) else x

    def wrap(fn, label):
        def rec(*a, **kw):
            if seen[0] % every == 0:
                calls.append((label, tuple(copy(x) for x in a), kw))
            seen[0] += 1
            return fn(*a, **kw)
        return rec

    for (mod, attr, fn), (_, _, label) in zip(saved, targets):
        setattr(mod, attr, wrap(fn, label))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def no_host_reads(mod, attr: str):
    """Run every call of ``mod.attr`` while the block runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that reads the
    card to the host raises.  Yields the list of guarded calls' counts
    (one entry a call)."""
    fn = getattr(mod, attr)
    calls = []

    def guarded(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            calls.append(1)
    setattr(mod, attr, guarded)
    try:
        yield calls
    finally:
        setattr(mod, attr, fn)


def kernel1_edges(sp_ops, seg, words, nr: int, coff: int):
    """The frontier's edges of one kernel-1 call as ``scatter_reduce_``
    takes them (``frontier_edges``: candidate position, value), the
    candidates' size, the frontier's id count and its edge total, from
    the plain prep of ``seg``'s addressing."""
    from repro_torch.core.frontier import unpack_bits
    if seg.addressing == "strips":
        ids, offs, total = sp_ops.prepare_strips(words, seg.ptr)
        p_, n = seg.ptr.shape[0], ids.numel()
        s_ = torch.arange(p_ * n, device=ids.device) // max(n, 1)
        u = ids.repeat(p_)
        dst, vals = sp_ops.frontier_edges(
            seg.ptr[s_, u.to(torch.int64)].to(torch.int64)
            + s_ * seg.row_idx.shape[1], offs, total,
            seg.row_idx.reshape(-1), u, s_ * nr)
        return dst, vals, p_ * nr, n, total
    mask = unpack_bits(words)
    if seg.addressing == "csr":
        ids, offs, total = sp_ops.prepare(mask, seg.ptr)
        starts = seg.ptr[ids].to(torch.int64)
    else:
        ids, slot, offs, total = sp_ops.prepare_dcsc(mask, seg.jc, seg.ptr,
                                                     seg.nzc)
        starts = seg.ptr[slot].to(torch.int64)
    dst, vals = sp_ops.frontier_edges(starts, offs, total, seg.row_idx,
                                      ids + coff, torch.zeros_like(offs))
    return dst, vals, None, ids.numel(), total


def kernel1_call(sp_ops, seg, words, nr: int, coff: int) -> dict:
    """One recorded kernel-1 call of the main path, measured: its entry
    ``spmsv_min`` whole (the prep kernel and the walk) on the card alone
    (``device_ms``) and host-timed (``cuda_ms``), its plain version
    (``spmsv_min_plain``, whose prep reads the host), one
    ``scatter_reduce_`` of the frontier's edges, and the bound from
    ``forward_cost`` (and with the words the device prep reads, stated
    apart).  Checks the candidates against the plain version and the
    kernel's edges examined, count and walk against the plain total and
    the prep's twin (tolerance 0)."""
    got, out = sp_ops.launch(seg, words, nr, coff)
    want, ex = sp_ops.spmsv_min_plain(seg, words, nr, coff)
    _, count, walk = sp_ops.prep_plain(words, sp_ops.list_capacity(seg))
    err = max_err(got, want)
    stats = out.tolist()
    check(stats == [int(ex), int(count), walk],
          f"kernel 1 ({seg.addressing}): edges examined, count, walk "
          f"{stats} against the plain {[int(ex), int(count), walk]}")
    del got, want
    k_ms = device_ms(lambda: sp_ops.spmsv_min(seg, words, nr, coff))
    h_ms = cuda_ms(lambda: sp_ops.spmsv_min(seg, words, nr, coff))
    p_ms = cuda_ms(lambda: sp_ops.spmsv_min_plain(seg, words, nr, coff),
                   reps=3)
    dst, vals, size, n_ids, total = kernel1_edges(sp_ops, seg, words, nr,
                                                  coff)
    size = size or nr
    lib_ms = cuda_ms(lambda: torch.full(
        (size,), 2**31 - 1, dtype=torch.int32,
        device=words.device).scatter_reduce_(0, dst, vals, "amin"), reps=5)
    del dst, vals
    p_ = seg.ptr.shape[0] if seg.addressing == "strips" else 1
    nbytes = sp_ops.forward_cost(seg.addressing, n_ids, total, nr, p_)[1]
    prep_bytes = sp_ops.forward_cost(seg.addressing, n_ids, total, nr, p_,
                                     n_words=words.numel())[1]
    return {"ms": k_ms, "host_ms": h_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": nbytes / HBM_BW * 1e3,
            "bound_with_words_ms": prep_bytes / HBM_BW * 1e3,
            "bytes": nbytes, "ids": n_ids, "edges": total, "walk": walk,
            "err": err}


def kernel1_rows(sp_ops, calls, label: str, extra=None) -> dict:
    """Phase 6's, 4b's and 9b's rows: every recorded ``spmsv_min`` call
    of one search through ``kernel1_call``, printed, and their sums;
    ``extra(seg, words, nr, coff)`` returns more (key, ms, err) to hold
    and add up (the other addressings on the same frontiers)."""
    row = {"ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "bound_with_words_ms": 0.0, "calls": 0,
           "max_abs_err": 0}
    for i, (_, a, kw) in enumerate(calls):
        seg, words, nr, coff = a[:4]
        r = kernel1_call(sp_ops, seg, words, nr, coff)
        more = extra(seg, words, nr, coff) if extra else []
        e = max([r["err"]] + [m[2] for m in more])
        row["max_abs_err"] = max(row["max_abs_err"], e)
        for key in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_with_words_ms"):
            row[key] += r[key]
        for key, ms, _ in more:
            row[key] = row.get(key, 0.0) + ms
        row["calls"] += 1
        walk = {1: "frontier", 2: "column"}[r["walk"]]
        print(f"call {i} {label}: {r['ids']} frontier ids, {r['edges']} "
              f"edges, {walk} walk: max |kernel - plain| = {e}; entry on "
              f"the card alone {r['ms']:.4f} ms, host-timed "
              f"{r['host_ms']:.4f} ms"
              + "".join(f", {key} {ms:.4f} ms" for key, ms, _ in more)
              + f"; plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bytes']} bytes; with the prep's {words.numel()} words "
              f"{r['bound_with_words_ms']:.5f} ms)")
    check(row["calls"] > 0, f"no {label} call in the search")
    check(row["max_abs_err"] == 0, f"{label} disagrees with its plain "
          f"version (max err {row['max_abs_err']})")
    print(f"{label}: {row['calls']} calls in one search: entry on the card "
          f"alone {row['ms']:.4f} ms, host-timed {row['host_ms']:.4f} ms"
          + "".join(f", {key} {row[key]:.4f} ms" for key in row
                    if key.endswith("_ms") and key not in (
                        "ms", "host_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_with_words_ms"))
          + f"; plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"(with the prep's words {row['bound_with_words_ms']:.5f}); "
          f"equal to its plain version (tolerance 0)")
    return row


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


def epilogue_bytes(ep_ops, pi0, cand, recv) -> int:
    """Bytes one level-epilogue launch must move on these inputs
    (``ep_ops.level_bytes``): the unvisited vertices, the slots past the
    first each reads up to its first find, and the newly found."""
    unvisited = pi0 == -1
    still = unvisited.clone() if cand is None else unvisited & (
        cand == 2**31 - 1)
    slot_reads = 0
    if recv is not None:
        pc = pi0.shape[1]
        jj = torch.arange(pc, device=pi0.device)
        for s in range(1, pc):
            slot_reads += int(still.sum())
            still &= recv[:, jj, (jj + s) % pc] == 2**31 - 1
    found = int(unvisited.sum()) - int(still.sum()) if cand is not None \
        else 1
    return ep_ops.level_bytes(pi0.numel(), int(unvisited.sum()), found,
                              slot_reads, start=cand is None)[1]


def epilogue_times(ep_ops, a, kw) -> dict:
    """One recorded level-epilogue launch (``launch``'s arguments, the
    inputs cloned as the call saw them) launched again: the kernel
    against its plain twin (parents, words and masses), and on the card
    alone the launch after a copy that restores ``pi``, less the copy
    alone; the twin host-timed the same way; the byte bound."""
    pi0, deg = a[:2]
    cand = a[2] if len(a) > 2 else None
    recv = a[3] if len(a) > 3 else None
    root = a[4] if len(a) > 4 else kw.get("root", -1)
    pi, pi_p = pi0.clone(), pi0.clone()
    got = ep_ops.launch(pi, deg, cand, recv, root)
    want = ep_ops.level_epilogue_plain(pi_p, deg, cand, recv, root)
    err = max(max_err(pi, pi_p), max_err(got.words, want.words),
              max_err(got.masses, want.masses))
    copy_ms = device_ms(lambda: pi.copy_(pi0))
    k_ms = device_ms(lambda: (pi.copy_(pi0), ep_ops.launch(
        pi, deg, cand, recv, root))) - copy_ms
    p_ms = cuda_ms(lambda: (pi_p.copy_(pi0), ep_ops.level_epilogue_plain(
        pi_p, deg, cand, recv, root)), reps=3) - copy_ms
    nbytes = epilogue_bytes(ep_ops, pi0, cand, recv)
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": nbytes / HBM_BW * 1e3,
            "bytes": nbytes, "err": err, "n_f": int(want.masses[0])}


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


def profile_call(fn, label: str = "search") -> dict:
    """Device busy and idle share of one call of ``fn``: the kernels that
    torch.profiler saw on the card over the call's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    ts = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - ts) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - ts) * 1e3
    busy_us, by_name = 0.0, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    if busy_us > 0:
        busy_ms = busy_us / 1e3
        print(f"device busy {busy_ms:.4f} ms in {len(by_name)} kinds of "
              f"kernel; {label} {prof_ms:.3f} ms under the profiler, "
              f"{plain_ms:.3f} ms without it: busy "
              f"{busy_ms / plain_ms:.1%}, idle "
              f"{1 - busy_ms / plain_ms:.1%} of the unprofiled {label}")
        for nm, us in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
            print(f"  {us / 1e3:9.4f} ms  {nm[:90]}")
    else:
        busy_ms = None
        print("the profiler recorded no device time: busy share not measured")
    return {"busy_ms": busy_ms, "call_ms": plain_ms, "profiled_ms": prof_ms,
            "by_name_ms": {k: v / 1e3 for k, v in by_name.items()}}


def device_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` on the card alone: the calls queue behind a spin
    kernel of about 10 ms (``torch.cuda._sleep``), so the host's issue
    time hides behind it and the events time the device work back to
    back.  ``cuda_ms`` includes the issue time where it is the longer."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ NN side
# the serving paths of phases 11-15: AutoInt scoring at the registered
# width and smollm-135m prefill/decode (the serving launcher's two archs)
AI_P99 = 200                  # serve_p99 batches
AI_BULK = 4                   # serve_bulk batches
AI_QUERIES = 16               # retrieval_cand queries
AI_PEAK_GIB = 30.0            # PERF.md section 2
MH_BAGS, MH_WIDTH = 65536, 32  # kernel 8's multi-hot bags
LM_REQUESTS, LM_NEW = 8, 32   # requests, new tokens each
LM_MAX_BATCH, LM_BUCKET, LM_MAX_LEN = 4, 128, 2048
LM_PEAK_GIB = 4.0             # PERF.md section 2
PREFILL_32K_PEAK_GIB = 60.0   # PERF.md section 2
PLAIN_ROWS = 2048             # query rows of each piece in which
                              # prefill_32k's plain attention is timed
# kernel 9 at the mixtral config's window: (BH, Sq, Sk, dh, causal,
# window, q_offset, dtype)
WINDOW_CASE = (8, 8192, 8192, 128, True, 4096, 0, torch.bfloat16)
# kernel 9 at head dims off its widths: 80 zero-padded to 128, and 160,
# 256, 320 on the wide kernel; on each path's shape (label, (B, Sq, Sk,
# q_offset, dtype), the path at dh <= 128), 32 heads
OFF_WIDTH_DIMS = (80, 160, 256, 320)
K9_DIM_SHAPES = (
    ("prefill bf16", (4, 512, 512, 0, torch.bfloat16), "wgmma"),
    ("decode bf16", (4, 1, 1500, 1499, torch.bfloat16), "split"),
    ("float32", (2, 128, 128, 0, torch.float32), "cuda_cores"))
# kernel 9 against its plain version: kernels/flash_attention/ref.py's
# TOL and tolerance(): float32 (rtol, atol) (2e-5, 2e-5), the order of
# the sums; bfloat16 2**-7 |want| + 2e-5 + 1.25 * 2**-8 A, A the plain
# version over |v| (the tensor cores take P rounded to bf16)


def attn_close(got, q, k, v, causal, window, q_offset) -> tuple:
    """(max |got - want|, max |got - want| / bound); fails past
    ``ref.tolerance``."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = fa_ref.attention_gqa(q, k, v, **kw).float()
    d = (got.float() - want).abs()
    ratio = d / fa_ref.tolerance(q, k, v, **kw)
    bad = ~(ratio <= 1.0)
    check(not bool(bad.any()), f"kernel 9 off its plain version by "
                               f"{float(d.max())} at {int(bad.sum())} "
                               f"elements ({fa_ref.TOL[q.dtype]})")
    return float(d.max()), float(ratio.max())


def attn_bound(q, k, causal, window, q_offset) -> tuple:
    """(bound ms, by, flops, bytes) of one attention call on these
    inputs: q read and the output written once, the keys and values
    that some query's mask reaches read once; 4 dh flops per live
    (query, key) pair, over the dense bf16 peak (``fa_ops.forward_cost``,
    which the dry-run counts too)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    flops, nbytes = fa_ops.forward_cost(q, k, causal, window, q_offset)
    tb, tf_ = nbytes / HBM_BW * 1e3, flops / PEAK_FLOPS * 1e3
    return max(tb, tf_), ("bytes" if tb >= tf_ else "operations"), flops, \
        nbytes


def sdpa_mask(sq, sk, causal, window, q_offset, device):
    """(mask or None, is_causal) for F.scaled_dot_product_attention: the
    mask only where some (query, key) pair is masked out by an offset
    causal edge or a window (``sdpa``'s rule)."""
    mask, is_causal = None, causal and q_offset == 0 and sq == sk \
        and window is None
    if not is_causal and (causal or window is not None):
        qpos = q_offset + torch.arange(sq, device=device)[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= qpos - kpos < window
        if bool(mask.all()):
            mask = None
    return mask, is_causal


def sdpa(q, k, v, causal, window, q_offset):
    """The library yardstick: a zero-argument call of
    F.scaled_dot_product_attention on the same (B, S, H, dh) inputs, the
    mask (``sdpa_mask``) built here, outside the call that is timed; a
    decode row over all its keys takes no mask."""
    import torch.nn.functional as F
    mask, is_causal = sdpa_mask(q.shape[1], k.shape[1], causal, window,
                                q_offset, q.device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=is_causal, enable_gqa=gqa)


def serve_autoint(dev, kernels) -> dict:
    """Phase 11: AutoInt at the registered width over the three recsys
    shapes, through kernel 8; returns what phases 12 and 15 use."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.models import embedding
    from repro_torch.models.autoint import AutoInt
    cfg = get_config("autoint")
    shp = {s.name: s for s in cfg.shapes}
    t0 = time.perf_counter()

    def batches(n, size, step0):
        return [torch.from_numpy(recsys_batch(cfg, size, step0 + i)["idx"])
                .pin_memory() for i in range(n)]
    p99 = batches(AI_P99, shp["serve_p99"].batch, 0)
    bulk = batches(AI_BULK, shp["serve_bulk"].batch, AI_P99)
    queries = batches(AI_QUERIES, shp["retrieval_cand"].batch, 10_000)
    t1 = time.perf_counter()
    model = AutoInt(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_cand = shp["retrieval_cand"].n_candidates
    cand = torch.randn(n_cand, cfg.n_heads * cfg.d_attn, generator=gen,
                       device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tab = model.table
    print(f"autoint: {cfg.n_sparse} fields, embed_dim {cfg.embed_dim}, "
          f"{cfg.n_attn_layers} attention layers of {cfg.n_heads} heads x "
          f"d_attn {cfg.d_attn}, MLP {cfg.mlp_hidden}; table "
          f"{tuple(tab.shape)} float32 ({cfg.n_embed_rows()} rows rounded "
          f"up), {tab.numel() * 4 / 1e6:.1f} MB on the card; {n_cand} "
          f"candidates of width {cand.shape[1]}")
    print(f"batches from recsys_batch (host, pinned): {t1 - t0:.3f} s; "
          f"model and candidates made on the card: {t2 - t1:.3f} s")

    def score(idx_host):
        """One request batch: host ids in, host p(click) out."""
        with torch.inference_mode():
            idx = idx_host.to(dev, non_blocking=True)
            return torch.sigmoid(model(idx)).cpu()

    def query(idx_host):
        with torch.inference_mode():
            u = model.user_tower(idx_host.to(dev, non_blocking=True))
            s = AutoInt.retrieval_scores(u, cand)
        torch.cuda.synchronize()
        return s

    def timed(fn, xs):
        out = []
        for x in xs:
            ts = time.perf_counter()
            fn(x)
            out.append((time.perf_counter() - ts) * 1e3)
        return out
    score(p99[0])                                  # warm-up
    score(bulk[0])
    query(queries[0])
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p99_ms = timed(score, p99)
    bulk_ms = timed(score, bulk)
    q_ms = timed(query, queries)
    launches = eb_ops.KERNEL.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = shp["serve_bulk"].batch
    print(f"serve_p99: {AI_P99} batches of {shp['serve_p99'].batch} rows, "
          f"ms per batch (host ids in, host scores out) median "
          f"{float(np.median(p99_ms)):.4f}, p99 "
          f"{float(np.percentile(p99_ms, 99)):.4f}, min {min(p99_ms):.4f}, "
          f"max {max(p99_ms):.4f}")
    print(f"serve_bulk: {AI_BULK} batches of {rows} rows: ms "
          f"{[round(x, 3) for x in bulk_ms]}, "
          f"{AI_BULK * rows / (sum(bulk_ms) / 1e3):.6e} rows/s")
    print(f"retrieval_cand: {AI_QUERIES} single queries against {n_cand} "
          f"candidates: ms per query median {float(np.median(q_ms)):.4f}, "
          f"min {min(q_ms):.4f}, max {max(q_ms):.4f}")
    print(f"peak device memory of the AutoInt path: {peak:.3f} GiB "
          f"(limit {AI_PEAK_GIB})")
    print(f"launches of embedding_bag on the AutoInt path: {launches}")
    check(launches == AI_P99 + AI_BULK + AI_QUERIES,
          f"embedding_bag launched {launches} times on the AutoInt path")
    check(peak < AI_PEAK_GIB, f"AutoInt peak {peak:.2f} GiB >= "
                              f"{AI_PEAK_GIB} GiB")
    for label, x in (("serve_p99", p99[0]), ("serve_bulk", bulk[0])):
        with torch.inference_mode():
            idx = x.to(dev)
            got = model(idx)
            plain = model.logits(tab[embedding.flat_indices(cfg, idx).long()])
        check(torch.equal(got, plain), f"{label} logits through kernel 8 "
                                       f"differ from the plain lookup's")
        check(bool(torch.isfinite(got).all()), f"{label} logits not finite")
        del got, plain
    print("logits through kernel 8 equal the plain lookup's (tab[rows]) bit "
          "for bit on a serve_p99 and a serve_bulk batch; all finite")
    torch.cuda.empty_cache()
    return {"cfg": cfg, "model": model, "p99": p99, "bulk": bulk,
            "queries": queries, "score": score, "launches": launches,
            "record": {"p99_ms": p99_ms, "bulk_ms": bulk_ms,
                       "query_ms": q_ms, "peak_gib": peak,
                       "launches": launches,
                       "rows_per_s": AI_BULK * rows / (sum(bulk_ms) / 1e3)}}


def check_kernel8(ai, dev) -> dict:
    """Phase 12: kernel 8 against its plain version, bit for bit, at the
    AutoInt path's shapes and multi-hot, with times; returns the kernels
    line's row (path totals: per-shape times x the path's launches)."""
    import itertools

    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.models import embedding
    cfg, tab = ai["cfg"], ai["model"].table
    plain_tab = tab.detach()
    d = tab.shape[1]
    worst = 0.0

    def same(got, want, label):
        e = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want), f"embedding_bag {label}: kernel != "
                                      f"plain (max err {e})")
        return e

    def distinct_rows(ids):
        return int(torch.unique(ids[ids >= 0]).numel())

    def rows_of(xs):
        return [embedding.flat_indices(cfg, x.to(dev)).reshape(-1, 1)
                .contiguous() for x in xs]
    # bags of one at the path's three shapes; the serve_p99 and
    # retrieval launches cycle through different batches, so the table
    # rows they read come cold as in serving
    shapes = {"serve_p99": (rows_of(ai["p99"][:64]), AI_P99),
              "serve_bulk": (rows_of(ai["bulk"][:1]), AI_BULK),
              "retrieval_cand": (rows_of(ai["queries"]), AI_QUERIES)}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for label, (rows, count) in shapes.items():
        longs = [r[:, 0].long() for r in rows]
        for r, lr in zip(rows[:4], longs):
            got = eb_ops.launch(tab, r, None, "sum")
            worst = max(worst, same(got, eb_ref.embedding_bag(tab, r), label))
            check(torch.equal(got, F.embedding(lr, tab)),
                  f"embedding_bag {label}: kernel != F.embedding")
        cyc = itertools.cycle(range(len(rows)))
        k_ms = cuda_ms(lambda: eb_ops.launch(tab, rows[next(cyc)], None,
                                             "sum"), reps=50)
        p_ms = cuda_ms(lambda: eb_ref.embedding_bag(tab, rows[next(cyc)]),
                       reps=5)
        # the library call as serving makes it: on the plain tensor under
        # inference_mode; and, for the record, on the nn.Parameter with
        # autograd on, as the first timing of this yardstick did
        with torch.inference_mode():
            l_ms = cuda_ms(lambda: F.embedding(longs[next(cyc)], plain_tab),
                           reps=50)
            # the two gathers PyTorch has: F.embedding is index_select
            sel_ms = cuda_ms(lambda: plain_tab.index_select(
                0, longs[next(cyc)]), reps=50)
            idx_ms = cuda_ms(lambda: plain_tab[longs[next(cyc)]], reps=50)
            # kernel 8 as the library call is timed: on the plain tensor
            # under inference_mode, its launch and its public entry (the
            # checks, the device test, the launch)
            ki_ms = cuda_ms(lambda: eb_ops.launch(plain_tab, rows[next(cyc)],
                                                  None, "sum"), reps=50)
            pub_ms = cuda_ms(lambda: eb_ops.embedding_bag(
                plain_tab, rows[next(cyc)]), reps=50)
        l_grad_ms = cuda_ms(lambda: F.embedding(longs[next(cyc)], tab),
                            reps=50)
        n = rows[0].shape[0]
        # ids read, each distinct row read once, the output written once;
        # the timed launches cycle through the batches, so the mean
        nbytes = sum(eb_ops.forward_cost(n, n, tab.shape[0], d, 4,
                                         distinct=distinct_rows(r))[1]
                     for r in rows) / len(rows)
        b_ms = nbytes / HBM_BW * 1e3
        for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                         ("library_ms", l_ms)):
            tot[key] += count * val
        print(f"embedding_bag {label:>14}: {n} bags of one, float32: "
              f"kernel == plain == F.embedding; kernel {k_ms:.5f} ms, plain "
              f"{p_ms:.5f} ms, library (F.embedding) {l_ms:.5f} ms "
              f"({l_grad_ms:.5f} ms on the nn.Parameter with autograd on), "
              f"bound {b_ms:.5f} ms ({nbytes:.0f} bytes, {len(rows)} "
              f"batches); {count} launches a path")
        print(f"    {label} library gathers: index_select {sel_ms:.5f} ms, "
              f"advanced indexing tab[ids] {idx_ms:.5f} ms")
        print(f"    {label} host-timed under inference_mode beside "
              f"F.embedding {l_ms:.5f} ms: kernel 8's launch {ki_ms:.5f} ms, "
              f"its public entry embedding_bag {pub_ms:.5f} ms")
        with torch.inference_mode():
            kd_ms = device_ms(lambda: eb_ops.launch(tab, rows[next(cyc)],
                                                    None, "sum"))
            ld_ms = device_ms(lambda: F.embedding(longs[next(cyc)],
                                                  plain_tab))
        print(f"    {label} on the card alone (queued behind a spin "
              f"kernel): kernel {kd_ms:.5f} ms, F.embedding {ld_ms:.5f} ms")
        ai["record"][f"k8_{label}"] = {"bags": n, "ms": k_ms, "plain_ms": p_ms,
                                       "library_ms": l_ms,
                                       "library_grad_ms": l_grad_ms,
                                       "index_select_ms": sel_ms,
                                       "inference_ms": ki_ms,
                                       "entry_ms": pub_ms,
                                       "index_ms": idx_ms,
                                       "device_ms": kd_ms,
                                       "device_library_ms": ld_ms,
                                       "bound_ms": b_ms, "bytes": nbytes}
    # kernel 8's other layouts at the serve_bulk shape: a bf16 copy of
    # the table (2 lanes of 8 elements a row) and a float32 table of D 32
    # (8 lanes of 4), bit for bit, on the card alone beside F.embedding
    bulk = shapes["serve_bulk"][0][0]
    lbulk = bulk[:, 0].long()
    n = bulk.shape[0]
    layouts = {}
    for label, t in (("bf16 D 16", plain_tab.to(torch.bfloat16)),
                     ("float32 D 32", torch.cat([plain_tab, -plain_tab], 1))):
        got = eb_ops.launch(t, bulk, None, "sum")
        worst = max(worst, same(got, eb_ref.embedding_bag(t, bulk), label))
        check(torch.equal(got, F.embedding(lbulk, t)),
              f"embedding_bag {label}: kernel != F.embedding")
        del got
        vec, lanes = eb_ops.layout(t.shape[1], t.element_size(),
                                   t.data_ptr() % eb_ops.VECTOR_BYTES == 0)
        with torch.inference_mode():
            kd_ms = device_ms(lambda: eb_ops.launch(t, bulk, None, "sum"))
            ld_ms = device_ms(lambda: F.embedding(lbulk, t))
        nbytes = eb_ops.forward_cost(n, n, t.shape[0], t.shape[1],
                                     t.element_size(),
                                     distinct=distinct_rows(bulk))[1]
        b_ms = nbytes / HBM_BW * 1e3
        print(f"embedding_bag serve_bulk, {label} ({vec} elements a lane, "
              f"{lanes} lanes a bag): {n} bags of one: kernel == plain == "
              f"F.embedding; on the card alone kernel {kd_ms:.5f} ms, "
              f"F.embedding {ld_ms:.5f} ms, bound {b_ms:.5f} ms "
              f"({nbytes} bytes)")
        layouts[label] = {"device_ms": kd_ms, "device_library_ms": ld_ms,
                          "bound_ms": b_ms, "vec": vec, "lanes": lanes}
        del t
    ai["record"]["k8_bulk_layouts"] = layouts
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    ids = torch.randint(0, tab.shape[0], (MH_BAGS, MH_WIDTH), generator=g,
                        device=dev, dtype=torch.int32)
    lens = torch.randint(0, MH_WIDTH + 1, (MH_BAGS,), generator=g, device=dev)
    ids[torch.arange(MH_WIDTH, device=dev)[None, :] >= lens[:, None]] = -1
    w = torch.rand(MH_BAGS, MH_WIDTH, generator=g, device=dev)
    valid = ids >= 0
    packed, psw = ids[valid].long(), w[valid]
    offsets = torch.cumsum(lens, 0) - lens
    n_valid = int(valid.sum())
    n_rows = distinct_rows(ids)
    mh = {}
    for t in (plain_tab, plain_tab.to(torch.bfloat16)):
        for mode in ("sum", "mean"):
            for ww in (w, None):
                label = (f"multi-hot {str(t.dtype)[6:]} {mode}"
                         f"{' weighted' if ww is not None else ''}")
                # through the multi-hot entry point of models/embedding
                got = embedding.embedding_bag(t, ids, ww, mode)
                worst = max(worst, same(got, eb_ref.embedding_bag(
                    t, ids, ww, mode), label))
                k_ms = cuda_ms(lambda: eb_ops.launch(t, ids, ww, mode))
                p_ms = cuda_ms(lambda: eb_ref.embedding_bag(t, ids, ww, mode),
                               reps=3)
                lib = None
                if t.dtype == torch.float32 or ww is None:
                    if ww is None or mode == "sum":
                        def run_lib():
                            return F.embedding_bag(
                                packed, t, offsets, mode=mode,
                                per_sample_weights=None if ww is None
                                else psw)
                        with torch.inference_mode():
                            lib = cuda_ms(run_lib)
                elt = t.element_size()
                nbytes = eb_ops.forward_cost(MH_BAGS, ids.numel(),
                                             t.shape[0], d, elt,
                                             ww is not None,
                                             distinct=n_rows)[1]
                b_ms = nbytes / HBM_BW * 1e3
                print(f"embedding_bag {label}: {MH_BAGS} bags of up to "
                      f"{MH_WIDTH} ids ({n_valid} valid, {n_rows} distinct "
                      f"rows): kernel == plain; "
                      f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, library "
                      + (f"{lib:.5f} ms" if lib is not None else "none")
                      + f", bound {b_ms:.5f} ms ({nbytes} bytes)")
                mh[label] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib,
                             "bound_ms": b_ms}
    ai["record"]["k8_multi_hot"] = mh
    print(f"kernel 8 equals its plain version bit for bit in all "
          f"{3 + len(layouts) + len(mh)} cases; over the AutoInt path's "
          f"{AI_P99 + AI_BULK + AI_QUERIES} "
          f"launches: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} "
          f"ms, library {tot['library_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms")
    return dict(tot, max_abs_err=worst, bound_by="bytes")


def serve_lm(dev, kernels) -> dict:
    """Phase 13: smollm-135m at the registered width through the server,
    attention through kernel 9; the kernel path against the plain one."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import make_lm_server
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.server import Request
    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, LM_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    server = make_lm_server(cfg, params, dev, max_batch=LM_MAX_BATCH,
                            max_len=LM_MAX_LEN, bucket=LM_BUCKET)
    kv_bytes = 2 * cfg.n_layers * LM_MAX_BATCH * LM_MAX_LEN \
        * cfg.n_kv_heads * cfg.d_head * 2
    print(f"smollm-135m: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of {cfg.d_head}, "
          f"vocab {cfg.vocab}, {cfg.dtype}: {n_par} parameters "
          f"(n_params() {cfg.n_params()}), made on the card in "
          f"{time.perf_counter() - t0:.3f} s; KV cache ({LM_MAX_BATCH}, "
          f"{LM_MAX_LEN}) = {kv_bytes / 1e6:.1f} MB")
    print(f"{LM_REQUESTS} requests, prompt lengths {lens.tolist()} "
          f"(default_rng(0)), {LM_NEW} new tokens each, max_batch "
          f"{LM_MAX_BATCH}, bucket {LM_BUCKET}")
    log, state = [], {}
    pre, dec = server.prefill_fn, server.decode_fn

    def timed_prefill(tokens):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = pre(tokens)
        torch.cuda.synchronize()
        state["cache"] = out[0]
        log.append(("prefill", (time.perf_counter() - ts) * 1e3,
                    tokens.clone(), None, out[1].clone()))
        return out

    def timed_decode(c, tok, pos):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = dec(c, tok, pos)
        torch.cuda.synchronize()
        log.append(("decode", (time.perf_counter() - ts) * 1e3, tok.clone(),
                    pos, out[1].clone()))
        return out
    server.prefill_fn, server.decode_fn = timed_prefill, timed_decode
    with torch.inference_mode():
        server.serve([Request(prompt=prompts[0][:40], max_new_tokens=2)])
    log.clear()
    reqs = [Request(prompt=p, max_new_tokens=LM_NEW) for p in prompts]
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # layer 0 of each call, its q, k and v copied as that call saw them
    with recording([(fa_ops, "flash_attention_gqa", "flash_attention")],
                   every=cfg.n_layers, clone=True) as calls, \
            torch.inference_mode():
        ts = time.perf_counter()
        done = server.serve(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - ts
    launches = fa_ops.KERNEL.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    copies = sum(x.numel() * x.element_size() for _, a, _ in calls
                 for x in a if isinstance(x, torch.Tensor)) / 2**30
    n_calls = len(log)
    check(len(calls) == n_calls, f"recorded {len(calls)} layer-0 calls of "
                                 f"kernel 9 for {n_calls} model calls")
    check(launches == n_calls * cfg.n_layers,
          f"flash_attention launched {launches} times for {n_calls} prefill "
          f"and decode calls of {cfg.n_layers} layers")
    pre_ms = [x[1] for x in log if x[0] == "prefill"]
    dec_ms = [x[1] for x in log if x[0] == "decode"]
    n_gen = sum(len(r.out) for r in done)
    check(n_gen == LM_REQUESTS * LM_NEW and all(
        ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done),
        "served tokens missing or out of the vocabulary")
    print(f"prefill ms per batch {[round(x, 3) for x in pre_ms]} (buckets "
          f"{[int(x[2].shape[1]) for x in log if x[0] == 'prefill']})")
    print(f"decode ms per step ({len(dec_ms)} steps of {LM_MAX_BATCH} rows) "
          f"median {float(np.median(dec_ms)):.4f}, min {min(dec_ms):.4f}, "
          f"max {max(dec_ms):.4f}")
    print(f"served {LM_REQUESTS} requests in {serve_s:.4f} s: {n_gen} "
          f"generated tokens, {n_gen / serve_s:.3f} tokens/s end to end; "
          f"decode {LM_MAX_BATCH / (float(np.median(dec_ms)) / 1e3):.3f} "
          f"tokens/s at the median step")
    print(f"peak device memory of the LM path: {peak:.3f} GiB (limit "
          f"{LM_PEAK_GIB}), with the recorded layer-0 copies of q, k and v "
          f"for phase 14 ({copies:.3f} GiB by the end)")
    print(f"launches of flash_attention on the LM path: {launches} "
          f"({n_calls} prefill and decode calls x {cfg.n_layers} layers)")
    check(peak < LM_PEAK_GIB, f"LM peak {peak:.2f} GiB >= {LM_PEAK_GIB}")
    # the plain path (the JAX model's chunked attention over the cache),
    # teacher-forced on the kernel path's tokens, logit by logit
    gaps = []
    with torch.inference_mode():
        for kind, _, tok, pos, logits in log:
            if kind == "prefill":
                c = tf.init_kv_cache(cfg, LM_MAX_BATCH, LM_MAX_LEN, device=dev)
                c, want = tf.prefill(params, tok, c, cfg,
                                     attn=tf.plain_attention)
            else:
                c, want = tf.decode_step(params, c, tok, pos, cfg,
                                         attn=tf.plain_attention)
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            gap = tf.logit_gap(logits, want)
            gaps.append((kind, gap))
            for key, lim in tf.LOGIT_TOL_BF16.items():
                check(gap[key] <= lim, f"{kind} logits at pos {pos}: "
                                       f"{key} gap {gap[key]:.5f} > {lim}")
    pg = [g for k, g in gaps if k == "prefill"]
    dg = [g for k, g in gaps if k == "decode"]
    print(f"kernel path vs plain path (chunked attention), logit gaps over "
          f"max|logit|: prefill max {[round(g['max'], 5) for g in pg]}; "
          f"teacher-forced decode ({len(dg)} steps) max of max "
          f"{max(g['max'] for g in dg):.5f}, max of mean "
          f"{max(g['mean'] for g in dg):.5f} (limits "
          f"{tf.LOGIT_TOL_BF16})")
    return {"cfg": cfg, "params": params, "cache": state["cache"],
            "decode": dec, "calls": calls,
            "launches": launches,
            "record": {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                       "serve_s": serve_s, "tokens_per_s": n_gen / serve_s,
                       "peak_gib": peak, "copies_gib": copies,
                       "launches": launches, "gaps": gaps,
                       "prompt_lens": lens.tolist()}}


def check_kernel9(lm, dev) -> dict:
    """Phase 14: kernel 9 against its plain version within tolerance at
    the LM path's calls (layer 0 of each, times the layers) and over the
    JAX test's sweep plus a window-4096 shape; times and bounds."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    n_layers = lm["cfg"].n_layers
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "flops": 0, "bytes": 0, "device_ms": 0.0,
           "device_library_ms": 0.0}
    worst = 0.0
    ratio = {"path": 0.0, "sweep float32": 0.0, "sweep bfloat16": 0.0}
    rows = []
    for _, (q, k, v), kw in lm["calls"]:
        causal, window, q_off = kw["causal"], kw["window"], kw["q_offset"]
        want = fa_ref.attention_gqa(q, k, v, causal=causal, window=window,
                                    q_offset=q_off)
        e, r = attn_close(fa_ops.launch(q, k, v, causal, window, q_off), q,
                          k, v, causal, window, q_off)
        worst, ratio["path"] = max(worst, e), max(ratio["path"], r)
        k_ms = cuda_ms(lambda: fa_ops.launch(q, k, v, causal, window, q_off),
                       reps=10)
        p_ms = cuda_ms(lambda: fa_ref.attention_gqa(
            q, k, v, causal=causal, window=window, q_offset=q_off), reps=2)
        lib = sdpa(q, k, v, causal, window, q_off)
        l_err = float((lib().transpose(1, 2).float() - want.float()).abs()
                      .max())
        l_ms = cuda_ms(lib, reps=5)
        kd_ms = device_ms(lambda: fa_ops.launch(q, k, v, causal, window,
                                                q_off))
        ld_ms = device_ms(lib)
        b_ms, by, flops, nbytes = attn_bound(q, k, causal, window, q_off)
        path, n_split = fa_ops.plan(q.shape[0], k.shape[2],
                                    q.shape[2] // k.shape[2], q.shape[1],
                                    k.shape[1], q.dtype, causal, window,
                                    q_off)
        blocks = (q.shape[0] * k.shape[2] * n_split if path == "split" else
                  q.shape[0] * q.shape[2] * -(-q.shape[1] // 64))
        for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                         ("library_ms", l_ms), ("flops", flops),
                         ("bytes", nbytes), ("device_ms", kd_ms),
                         ("device_library_ms", ld_ms)):
            tot[key] += n_layers * val
        rows.append({"b": q.shape[0], "sq": q.shape[1], "sk": k.shape[1],
                     "hq": q.shape[2], "hkv": k.shape[2], "q_offset": q_off,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "library_err": l_err, "bound_ms": b_ms, "by": by,
                     "device_ms": kd_ms, "device_library_ms": ld_ms,
                     "path": path, "n_split": n_split, "blocks": blocks})
    for r in rows:
        if r["sq"] > 1:
            print(f"flash_attention prefill B={r['b']} S={r['sq']} heads "
                  f"{r['hq']}/{r['hkv']} ({r['path']}, {r['blocks']} "
                  f"blocks): "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library (SDPA, no mask) {r['library_ms']:.4f} ms "
                  f"(max |SDPA - plain| {r['library_err']:.3e}), bound "
                  f"{r['bound_ms']:.5f} ms ({r['by']}) a layer")
    dec = [r for r in rows if r["sq"] == 1]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        tot[f"decode_{key}"] = sum(r[key] for r in dec) * n_layers
    print(f"flash_attention decode, {len(dec)} steps (Sk "
          f"{min(r['sk'] for r in dec)}-{max(r['sk'] for r in dec)}), summed "
          f"over the steps and {n_layers} layers: kernel "
          f"{tot['decode_ms']:.4f} ms, plain {tot['decode_plain_ms']:.4f} ms, "
          f"library {tot['decode_library_ms']:.4f} ms, bound "
          f"{tot['decode_bound_ms']:.5f} ms; median step a layer "
          f"{float(np.median([r['ms'] for r in dec])):.5f} ms, SDPA (no "
          f"mask: a decode row reaches all its keys) "
          f"{float(np.median([r['library_ms'] for r in dec])):.5f} ms (max "
          f"|SDPA - plain| {max(r['library_err'] for r in dec):.3e})")
    print(f"over the LM path's {len(rows) * n_layers} launches: kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
          f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['flops'] / 1e9:.3f} GFLOP, {tot['bytes'] / 1e9:.4f} GB); "
          f"{tot['flops'] / (tot['ms'] / 1e3) / 1e12:.3f} TFLOP/s achieved")
    print(f"on the card alone (queued behind a spin kernel), over the same "
          f"launches: kernel {tot['device_ms']:.4f} ms (prefill "
          f"{[round(r['device_ms'], 5) for r in rows if r['sq'] > 1]} a "
          f"layer, decode median "
          f"{float(np.median([r['device_ms'] for r in dec])):.5f}), SDPA "
          f"{tot['device_library_ms']:.4f} ms (prefill "
          f"{[round(r['device_library_ms'], 5) for r in rows if r['sq'] > 1]}"
          f", decode median "
          f"{float(np.median([r['device_library_ms'] for r in dec])):.5f})")
    blocks = sorted((r["blocks"], r["sk"]) for r in dec)
    print(f"decode launches (key splits, {fa_ops.MIN_SPLIT_KEYS} keys a "
          f"split at least, {fa_ops.TARGET_BLOCKS} blocks wanted): "
          f"{blocks[0][0]} blocks at Sk {blocks[0][1]} to {blocks[-1][0]} "
          f"at Sk {blocks[-1][1]}, median "
          f"{int(np.median([b for b, _ in blocks]))}")
    # the 32-key floor against 16 keys a split at the shortest cache,
    # where 16 keys reach the wanted blocks: on the card alone
    _, (q, k, v), kw = min(lm["calls"], key=lambda c: (
        c[1][0].shape[1] > 1, c[1][1].shape[1]))
    floor_ms = {}
    for keys in (fa_ops.MIN_SPLIT_KEYS, 16):
        saved, fa_ops.MIN_SPLIT_KEYS = fa_ops.MIN_SPLIT_KEYS, keys
        try:
            _, n = fa_ops.plan(q.shape[0], k.shape[2],
                               q.shape[2] // k.shape[2], 1, k.shape[1],
                               q.dtype, kw["causal"], kw["window"],
                               kw["q_offset"])
            floor_ms[keys] = (q.shape[0] * k.shape[2] * n, device_ms(
                lambda: fa_ops.launch(q, k, v, kw["causal"], kw["window"],
                                      kw["q_offset"])))
        finally:
            fa_ops.MIN_SPLIT_KEYS = saved
    print(f"decode at Sk {k.shape[1]} on the card alone: " + ", ".join(
        f"{keys} keys a split at least {b} blocks {t:.5f} ms"
        for keys, (b, t) in floor_ms.items()))
    lm["record"]["k9_split_floor"] = {str(x): y for x, y in floor_ms.items()}
    lm["record"]["k9_device_totals"] = {
        "kernel_ms": tot["device_ms"], "library_ms": tot["device_library_ms"]}
    sweep = [(128, 128, 64, True, None, 0), (64, 64, 32, False, None, 0),
             (128, 256, 64, True, 64, 0), (1, 256, 64, True, None, 255),
             (64, 192, 128, True, None, 128), (96, 100, 64, True, None, 4)]
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = [(3, sq, sk, dh, c, w, o, dt) for sq, sk, dh, c, w, o in sweep
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(WINDOW_CASE)
    sweep_rec = []
    for bh, sq, sk, dh, causal, window, q_off, dt in cases:
        q = torch.randn(bh, sq, 1, dh, generator=g, device=dev).to(dt)
        k, v = (torch.randn(bh, sk, 1, dh, generator=g, device=dev).to(dt)
                for _ in range(2))
        e, r = attn_close(fa_ops.launch(q, k, v, causal, window, q_off), q,
                          k, v, causal, window, q_off)
        worst = max(worst, e)
        key = f"sweep {str(dt)[6:]}"
        ratio[key] = max(ratio[key], r)
        k_ms = cuda_ms(lambda: fa_ops.launch(q, k, v, causal, window, q_off),
                       reps=10)
        l_ms = cuda_ms(sdpa(q, k, v, causal, window, q_off), reps=5)
        b_ms, by, _, _ = attn_bound(q, k, causal, window, q_off)
        print(f"flash_attention sweep BH={bh} Sq={sq} Sk={sk} dh={dh} "
              f"causal={causal} window={window} q_offset={q_off} "
              f"{str(dt)[6:]}: max |kernel - plain| {e:.3e} ({r:.4f} of "
              f"the bound); kernel "
              f"{k_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({by})")
        sweep_rec.append({"case": [bh, sq, sk, dh, causal, window, q_off,
                                   str(dt)], "err": e, "ms": k_ms,
                          "library_ms": l_ms, "bound_ms": b_ms})
    # head dims beside the kernel's widths, 32 heads, on each path's
    # shape: 80 (stablelm-3b's) zero-padded to 128, and 160, 256 and 320
    # on the wide kernel (the head dim a runtime argument), timed beside
    # 64 and 128
    for dh in OFF_WIDTH_DIMS:
        ratio[f"head dim {dh}"] = 0.0
    pad_rec = {}
    for label, (b, sq, sk, q_off, dt), want_path in K9_DIM_SHAPES:
        check(fa_ops.plan(b, 32, 1, sq, sk, dt, True, None, q_off)[0]
              == want_path, f"{label} does not take the {want_path} path")
        times, off = {}, {}
        for dh in sorted((64, 128) + OFF_WIDTH_DIMS):
            if dh > 128:
                check(fa_ops.padded_dim(dh) == dh, f"dh {dh} is not run by "
                                                   f"the wide kernel")
            q = torch.randn(b, sq, 32, dh, generator=g, device=dev).to(dt)
            k, v = (torch.randn(b, sk, 32, dh, generator=g, device=dev)
                    .to(dt) for _ in range(2))
            e, r = attn_close(fa_ops.launch(q, k, v, True, None, q_off), q,
                              k, v, True, None, q_off)
            worst = max(worst, e)
            if dh in OFF_WIDTH_DIMS:
                ratio[f"head dim {dh}"] = max(ratio[f"head dim {dh}"], r)
                off[dh] = (e, r)
            times[dh] = device_ms(lambda: fa_ops.launch(q, k, v, True, None,
                                                        q_off))
            del q, k, v
        print(f"flash_attention {label} B={b} Sq={sq} Sk={sk} 32 heads, "
              f"max |kernel - plain| (of the bound): " + ", ".join(
                  f"dh {d} {x[0]:.3e} ({x[1]:.4f})" for d, x in off.items())
              + f"; on the card alone ({want_path} to dh 128, then wide): "
              + ", ".join(f"dh {d} {t:.5f} ms" for d, t in times.items()))
        pad_rec[label] = {"err": {str(d): x[0] for d, x in off.items()},
                          "ratio": {str(d): x[1] for d, x in off.items()},
                          "device_ms": {str(d): t for d, t in times.items()}}
    lm["record"]["k9_head_dims"] = pad_rec
    print(f"kernel 9 agrees with its plain version within "
          f"{fa_ref.TOL[torch.float32]} (float32) and "
          f"{fa_ref.TOL[torch.bfloat16]} (bfloat16) (rtol, atol, vtol) on "
          f"{len(rows)} path calls, {len(cases)} sweep cases and "
          f"{len(OFF_WIDTH_DIMS) * len(pad_rec)} head-dim cases; max "
          f"|kernel - plain| / bound: " + ", ".join(
              f"{k} {x:.4f}" for k, x in ratio.items()))
    lm["record"]["k9_calls"] = rows
    lm["record"]["k9_bound_ratio"] = ratio
    lm["record"]["k9_sweep"] = sweep_rec
    by = "operations" if tot["flops"] / PEAK_FLOPS \
        >= tot["bytes"] / HBM_BW else "bytes"
    return {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "library_ms": tot["library_ms"],
            "flops": tot["flops"], "bytes": tot["bytes"],
            "max_abs_err": worst, "bound_by": by}


def prefill_32k(dev, kernels, params) -> dict:
    """Phase 16: smollm-135m's prefill_32k shape (configs/base.py
    LM_SHAPES) through ``transformer.prefill`` at the registered width:
    32 x 32,768 random tokens into a cache of 32,768.  Kernel 9 is
    launched again at layer 0's call, its output held against its plain
    version on the first and last 128 query rows of the first and last
    sequences, and timed (ms, plain, library, bound; each x the
    layers)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import LM_SHAPES, get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import transformer as tf
    cfg = get_config("smollm-135m")
    shape = next(x for x in LM_SHAPES if x.name == "prefill_32k")
    b, s_len = shape.global_batch, shape.seq_len
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    tokens = torch.randint(1, cfg.vocab, (b, s_len), generator=g,
                           device=dev, dtype=torch.int32)
    cache = tf.init_kv_cache(cfg, b, s_len, device=dev)
    kv_gb = sum(x.numel() * x.element_size() for x in cache.values()) / 1e9
    print(f"smollm-135m prefill_32k: {b} x {s_len} tokens, KV cache ({b}, "
          f"{s_len}) = {kv_gb:.2f} GB; decode_32k (128 x 32,768, a 96.6 GB "
          f"cache) does not fit one card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    # layer 0's call, its q copied (k and v are layer 0 of the cache,
    # which later layers leave as they are)
    with recording([(fa_ops, "flash_attention_gqa", "flash_attention")],
                   every=cfg.n_layers) as calls, torch.inference_mode():
        ts = time.perf_counter()
        cache, logits = tf.prefill(params, tokens, cache, cfg)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - ts
        q0 = calls[0][1][0]
    launches = {k: v.launches for k, v in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in "
          f"a prefill of {cfg.n_layers} layers")
    check(tuple(logits.shape) == (b, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"prefill_32k logits {tuple(logits.shape)} not finite")
    check(peak < PREFILL_32K_PEAK_GIB,
          f"prefill_32k peak {peak:.2f} GiB >= {PREFILL_32K_PEAK_GIB}")
    k0, v0 = cache["k"][0], cache["v"][0]
    # layer 0's launch at the path's shape and grid, its output checked
    # on rows with few keys and with all 32,768
    out = fa_ops.launch(q0, k0, v0, True, None, 0)
    rows, errs = 128, []
    for i in (0, b - 1):
        for r0 in (0, s_len - rows):
            errs.append((i, r0) + attn_close(
                out[i:i + 1, r0:r0 + rows], q0[i:i + 1, r0:r0 + rows],
                k0[i:i + 1], v0[i:i + 1], True, None, r0))
    del out
    for i, r0, e, r in errs:
        print(f"kernel 9 at prefill_32k's shape, sequence {i}, query rows "
              f"{r0}-{r0 + rows - 1} over their causal keys: max |kernel "
              f"- plain| {e:.3e}, {r:.4f} of the bound")
    kd_ms = device_ms(lambda: fa_ops.launch(q0, k0, v0, True, None, 0),
                      reps=3)
    k_ms = cuda_ms(lambda: fa_ops.launch(q0, k0, v0, True, None, 0),
                   reps=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q0, k0, v0))

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    ld_ms = device_ms(lib, reps=3)
    l_ms = cuda_ms(lib, reps=2)
    # the plain version over the whole call does not fit the card (its
    # scores alone are 1.24 TB): timed over the call in pieces of
    # PLAIN_ROWS query rows of one sequence (rows are independent)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(b):
        for r0 in range(0, s_len, PLAIN_ROWS):
            fa_ref.attention_gqa(q0[i:i + 1, r0:r0 + PLAIN_ROWS],
                                 k0[i:i + 1], v0[i:i + 1], causal=True,
                                 q_offset=r0)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    b_ms, by, flops, nbytes = attn_bound(q0, k0, True, None, 0)
    attn_s = kd_ms * cfg.n_layers / 1e3
    n_tok = b * s_len
    print(f"prefill_32k: {total_s:.4f} s ({n_tok / total_s:.1f} tokens/s), "
          f"peak device memory {peak:.3f} GiB (limit "
          f"{PREFILL_32K_PEAK_GIB}); flash_attention launches "
          f"{launches['flash_attention']}")
    print(f"kernel 9 at layer 0: {k_ms:.4f} ms (plain, in pieces of "
          f"{PLAIN_ROWS} rows, {p_ms:.1f} ms; SDPA {l_ms:.4f} ms); on the "
          f"card alone {kd_ms:.4f} ms (SDPA "
          f"{ld_ms:.4f} ms, bound {b_ms:.4f} ms by {by}, "
          f"{flops / (kd_ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{flops / (kd_ms / 1e3) / PEAK_FLOPS:.1%} of the bf16 "
          f"peak); x {cfg.n_layers} layers {attn_s:.4f} s, "
          f"{attn_s / total_s:.1%} of the prefill")
    print("-- profile of one more prefill_32k pass")
    with torch.inference_mode():
        prof = profile_call(lambda: tf.prefill(params, tokens, cache, cfg),
                            "prefill_32k")
    n = cfg.n_layers
    return {"s": total_s, "tokens_per_s": n_tok / total_s, "peak_gib": peak,
            "launches": launches["flash_attention"], "k9_layer_ms": kd_ms,
            "sdpa_layer_ms": ld_ms, "bound_layer_ms": b_ms,
            "attention_s": attn_s, "attention_share": attn_s / total_s,
            "slice_err": max(e for _, _, e, _ in errs),
            "slice_ratio": max(r for _, _, _, r in errs),
            "slices": errs, "kv_gb": kv_gb, "profile": prof,
            # kernel 9's launches here, as the kernels line sums them
            "ms": k_ms * n, "plain_ms": p_ms * n, "bound_ms": b_ms * n,
            "library_ms": l_ms * n, "flops": flops * n, "bytes": nbytes * n}


# ------------------------------------------------------------ training
# phases 17-18: the two backward kernels and training at full width
TRAIN_STEPS, TRAIN_RESUME_AT = 20, 10
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_CHUNK = 8, 1024, 512
LM_TRAIN_PEAK_GIB = 24.0      # PERF.md section 2
AI_TRAIN_ROWS = 65536         # RECSYS_SHAPES train_batch
AI_TRAIN_PEAK_GIB = 30.0      # PERF.md section 2
MH_BWD = (16384, 32)          # kernel 8b's multi-hot bags (B, L), bf16
# kernel 9b's checks: (label, (B, Sq, Sk, Hq, Hkv, dh, causal, window,
# q_offset, dtype)); the first is the training path's call
K9B_CASES = (
    ("smollm-135m train", (8, 1024, 1024, 9, 3, 64, True, None, 0,
                           torch.bfloat16)),
    ("float32", (2, 512, 512, 9, 3, 64, True, None, 0, torch.float32)),
    ("window 256", (8, 1024, 1024, 9, 3, 64, True, 256, 0, torch.bfloat16)),
    ("q_offset 512", (8, 512, 1024, 9, 3, 64, True, None, 512,
                      torch.bfloat16)))
TRAIN_DRIVERS = [
    ("launch.train smollm-135m --full", "repro_torch.launch.train",
     ["--arch", "smollm-135m", "--full", "--batch", "8", "--seq", "1024",
      "--steps", "4"], "smollm-135m: 4 steps"),
    ("launch.train autoint", "repro_torch.launch.train",
     ["--arch", "autoint", "--steps", "20"], "autoint: 20 steps"),
    ("launch.train bfs-rmat", "repro_torch.launch.train",
     ["--arch", "bfs-rmat"], "search 7:"),
    ("examples.train_lm", "repro_torch.examples.train_lm", [],
     "trained 30 steps")]


@contextlib.contextmanager
def plain_tripwire():
    """Count every call of kernels 8, 8b, 9 and 9b's plain versions while
    the block runs (the kernels line's launches come from runs in which
    this count must stay 0)."""
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    calls = {}
    saved = []
    for mod, name in ((eb_ref, "embedding_bag"),
                      (eb_ref, "embedding_bag_backward"),
                      (fa_ref, "attention_gqa"),
                      (fa_ref, "attention_gqa_backward")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_kernel8b(dev) -> dict:
    """Phase 17a: kernel 8b against its plain version on CPU copies of
    the inputs, tolerance 0, at AutoInt's train_batch lookup (65,536 rows
    x 39 fields, bags of one, float32, the registered table's rows) and
    multi-hot (bf16, weights, pads, mean) on the same table's rows: each
    shape's public entry called twice under sync debug mode "error" (no
    host read), the two bit for bit; its key kernel and sort against the
    plain twin on CPU copies.  Times at the train_batch shape: the public
    entry on the card alone and host-timed; the key kernel, the sort, the
    two together and the gradient kernel each on the card alone; the
    plain version and the key kernel's plain twin on the card;
    aten.embedding_dense_backward on the same ids, on the card alone and
    host-timed.  Returns kernel 8b's record, the key kernel's under
    "keys"."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.models import embedding
    cfg = get_config("autoint")
    _, n_rows = embedding.table_meta(cfg)
    d = cfg.embed_dim
    idx = torch.from_numpy(recsys_batch(cfg, AI_TRAIN_ROWS, 0)["idx"]).to(dev)
    ids = embedding.flat_indices(cfg, idx).reshape(-1, 1).to(
        torch.int32).contiguous()
    n = ids.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    gout = torch.randn(n, d, generator=g, device=dev)
    b, w = MH_BWD
    mh_ids = torch.randint(0, n_rows, (b, w), generator=g, device=dev,
                           dtype=torch.int32)
    mh_ids[torch.rand(b, w, generator=g, device=dev) < 0.2] = -1
    mh_w = torch.rand(b, w, generator=g, device=dev) + 0.5
    mh_gout = torch.randn(b, d, generator=g, device=dev).to(torch.bfloat16)
    rec, key_errs = {}, []
    for label, args in (
            ("train_batch bags of one float32", (gout, ids, None, "sum")),
            (f"multi-hot {b} x {w} bf16 weighted mean",
             (mh_gout, mh_ids, mh_w, "mean"))):
        go, bi, bw, mode = args
        eb_ops.embedding_bag_backward(go, bi, n_rows, bw, mode)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = eb_ops.embedding_bag_backward(go, bi, n_rows, bw, mode)
            again = eb_ops.embedding_bag_backward(go, bi, n_rows, bw, mode)
            prep = eb_ops.prepare_backward(bi, bw, mode, n_rows)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"kernel 8b {label}: two calls differ")
        cpu_w = None if bw is None else bw.cpu()
        want = eb_ref.embedding_bag_backward(go.cpu(), bi.cpu(), n_rows,
                                             cpu_w, mode)
        err = float((got.cpu().float() - want.float()).abs().max())
        check(torch.equal(got.cpu(), want),
              f"kernel 8b {label}: off its plain version by {err}")
        twin = eb_ops.prepare_backward(bi.cpu(), cpu_w, mode, n_rows)
        key_err = max(
            int((prep.keys.cpu().long() - twin.keys.long()).abs().max()),
            int((prep.pos.cpu() - twin.pos).abs().max()),
            0 if twin.den is None else
            float((prep.den.cpu() - twin.den).abs().max()))
        check(key_err == 0 and (prep.den is None) == (twin.den is None),
              f"kernel 8b's key kernel and sort {label}: off the plain twin "
              f"by {key_err}")
        key_errs.append(key_err)
        live = int((got != 0).any(1).sum())
        print(f"kernel 8b {label}: no host sync under sync debug mode "
              f"\"error\", two calls bit for bit, equal to the plain "
              f"version (CPU copies), keys and sort equal to the plain "
              f"twin; {live:,} live rows of {n_rows:,}")
        rec[label] = {"max_abs_err": err, "live_rows": live,
                      "keys_max_abs_err": key_err}
        del got, again, want, prep, twin
    entry = lambda: eb_ops.embedding_bag_backward(gout, ids, n_rows)  # noqa
    prep = eb_ops.prepare_backward(ids, None, "sum", n_rows)
    keys, _ = eb_ops.backward_keys(ids, None, "sum", n_rows)
    items = eb_ops.tile_items(*eb_ops.layout(d, gout.element_size(), True))
    bounds = eb_ops.tile_bounds(prep.keys, n_rows, items)
    want_bounds = eb_ops.tile_bounds_plain(prep.keys.cpu(), n_rows, items)
    tile_err = int((bounds.cpu().long() - want_bounds.long()).abs().max())
    check(tile_err == 0, f"kernel 8b's tile kernel: off the plain twin by "
                         f"{tile_err}")
    print(f"kernel 8b's tile kernel at {items} rows plus terms a tile: "
          f"equal to the plain twin (CPU copies), {bounds.shape[0] - 1:,} "
          f"tiles")
    k_dev = device_ms(entry)
    k_ms = cuda_ms(entry)
    keys_ms = device_ms(lambda: eb_ops.backward_keys(ids, None, "sum",
                                                     n_rows))
    sort_ms = device_ms(lambda: eb_ops.sort_keys(keys, n_rows))
    tsort_ms = device_ms(lambda: torch.sort(keys, stable=True))
    sp_ms = cuda_ms(lambda: eb_ops.sort_keys_plain(keys))
    prep_ms = device_ms(lambda: eb_ops.prepare_backward(ids, None, "sum",
                                                        n_rows))
    tiles_ms = device_ms(lambda: eb_ops.tile_bounds(prep.keys, n_rows,
                                                    items))
    launch_ms = device_ms(lambda: eb_ops.launch_backward(gout, prep, n_rows))
    tp_ms = cuda_ms(lambda: eb_ops.tile_bounds_plain(prep.keys, n_rows,
                                                     items))
    # yardsticks of the gradient kernel's two streams, each alone: the
    # dense output's write (zero_) and the gather of dout's rows in the
    # sorted order (index_select, which also writes them out)
    dense_out = torch.empty(n_rows, d, device=dev)
    zero_ms = device_ms(lambda: dense_out.zero_())
    order = prep.pos.long()
    gather_ms = device_ms(lambda: torch.index_select(gout, 0, order))
    del dense_out, order
    p_ms = cuda_ms(lambda: eb_ref.embedding_bag_backward(gout, ids, n_rows),
                   reps=5)
    kp_ms = cuda_ms(lambda: eb_ops.backward_keys_plain(ids, None, "sum",
                                                       n_rows))
    flat = ids.reshape(-1).long()

    def dense():
        return torch.ops.aten.embedding_dense_backward(gout, flat, n_rows,
                                                       -1, False)
    l_dev = device_ms(dense)
    l_ms = cuda_ms(dense)
    # bytes: the ids and dout read once, the dense (V, D) output written
    nbytes = eb_ops.backward_cost(n, n, n_rows, d, 4)[1]
    bound = nbytes / HBM_BW * 1e3
    # the key kernel: the ids read and the keys written once; the tile
    # kernel: the sorted keys read and the tile bounds written once
    key_bytes = n * 4 + n * 4
    key_bound = key_bytes / HBM_BW * 1e3
    tile_bytes = n * 4 + bounds.numel() * 4
    tile_bound = tile_bytes / HBM_BW * 1e3
    # the sort: the keys read, the sorted keys and positions written once
    sort_bytes = n * 4 + n * 8
    sort_bound = sort_bytes / HBM_BW * 1e3
    print(f"kernel 8b at train_batch ({n:,} ids, {n_rows:,} x {d} float32): "
          f"the public entry {k_dev:.4f} ms on the card alone ({k_ms:.4f} "
          f"ms host-timed, {bound / k_dev:.1%} of its bound); the key "
          f"kernel {keys_ms:.4f} ms, the sort {sort_ms:.4f} ms, the two "
          f"{prep_ms:.4f} ms; the tile kernel {tiles_ms:.4f} ms, it and "
          f"the gradient kernel {launch_ms:.4f} ms (the output's zero_ "
          f"alone {zero_ms:.4f} ms, dout's rows gathered in the sorted "
          f"order by index_select {gather_ms:.4f} ms); "
          f"all on the card alone; plain {p_ms:.4f} ms, "
          f"embedding_dense_backward {l_dev:.4f} ms on the card alone "
          f"({l_ms:.4f} ms host-timed), bound {bound:.4f} ms (bytes: "
          f"{nbytes / 1e9:.3f} GB)")
    print(f"kernel 8b's key kernel: {keys_ms:.4f} ms on the card alone, "
          f"plain twin {kp_ms:.4f} ms, bound {key_bound:.4f} ms (bytes: "
          f"{key_bytes / 1e6:.1f} MB); its tile kernel ({bounds.shape[0]:,} "
          f"bounds): {tiles_ms:.4f} ms, plain twin {tp_ms:.4f} ms, bound "
          f"{tile_bound:.4f} ms); its sort: {sort_ms:.4f} ms, plain twin "
          f"{sp_ms:.4f} ms, torch.sort(stable=True) {tsort_ms:.4f} ms on "
          f"the card alone, bound {sort_bound:.4f} ms")
    rec.update(ms=k_dev, host_ms=k_ms, keys_ms=keys_ms, sort_ms=sort_ms,
               prep_ms=prep_ms, tiles_ms=tiles_ms, launch_ms=launch_ms,
               zero_ms=zero_ms, gather_ms=gather_ms, plain_ms=p_ms, library_ms=l_dev,
               library_host_ms=l_ms, bound_ms=bound, bound_by="bytes",
               items=items,
               max_abs_err=max(r["max_abs_err"] for r in rec.values()))
    rec["keys"] = {"ms": keys_ms, "plain_ms": kp_ms, "bound_ms": key_bound,
                   "bound_by": "bytes", "library_ms": None,
                   "max_abs_err": max(key_errs)}
    rec["sort"] = {"ms": sort_ms, "plain_ms": sp_ms, "bound_ms": sort_bound,
                   "bound_by": "bytes", "library_ms": tsort_ms,
                   "max_abs_err": max(key_errs)}
    rec["tiles"] = {"ms": tiles_ms, "plain_ms": tp_ms,
                    "bound_ms": tile_bound, "bound_by": "bytes",
                    "library_ms": None, "max_abs_err": tile_err}
    return rec


def bwd_bound(q, k, causal, window, q_offset) -> tuple:
    """(bound ms, by, flops, bytes) of one attention gradient: q, o, dO
    read and dq written, k, v read and dk, dv written, once each; 10 dh
    flops per live (query, key) pair (S, dP, dV, dQ, dK) at the card's
    peak for the inputs' type: the dense bf16 tensor-core rate for bf16,
    the CUDA cores' rate for float32 (``fa_ops.backward_cost``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    flops, nbytes = fa_ops.backward_cost(q, k, causal, window, q_offset)
    peak = (FP32_FLOPS if q.dtype == torch.float32
            else PEAK_FLOPS)
    tb, tf_ = nbytes / HBM_BW * 1e3, flops / peak * 1e3
    return max(tb, tf_), ("bytes" if tb >= tf_ else "operations"), flops, \
        nbytes


# SDPA's backends in the order phase 17b tries them for its yardstick: the
# first that runs a case (flash takes no mask, nor efficient GQA)
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")
TIMED_CALLS = 25              # single calls a timing in turns takes


def single_calls_ms(fns: dict, calls: int = TIMED_CALLS) -> dict:
    """Each of ``fns`` (name -> zero-argument call) timed as single calls
    in turns, ``calls`` rounds, each between its own CUDA event pair
    queued behind a short spin kernel (``torch.cuda._sleep``), so that
    the events time the device work and not the host's issue: name ->
    (median, min, max) ms."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(calls):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (float(np.median(t)), float(min(t)), float(max(t)))
            for name, t in times.items()}


def sdpa_backward(q, k, v, do, causal, window, q_offset):
    """(backend name, call): SDPA's backward through autograd on the same
    inputs, its forward run once under the first of SDPA_BACKENDS that
    takes the case (the backward follows the forward's backend), the mask
    built outside the timed call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    mask, is_causal = sdpa_mask(q.shape[1], k.shape[1], causal, window,
                                q_offset, q.device)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    for name in SDPA_BACKENDS:
        try:  # the yardstick's backend; the port's path has no fallback
            with sdpa_kernel(getattr(SDPBackend, name)):
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=is_causal,
                    enable_gqa=q.shape[2] != k.shape[2])
                torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True)
        except RuntimeError:
            continue
        return name, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True)
    raise RuntimeError("no SDPA backend takes this case")


def check_kernel9b(dev) -> dict:
    """Phase 17b: kernel 9b against its plain version on the same inputs
    (o from kernel 9) within ``ref.backward_tolerance``, at each K9B_CASES
    shape, with the log-sum-exp kernel 9 saved (the bf16 prefill path)
    and without it (9b's first pass computes it), two calls bit for bit;
    times: 9b with the saved log-sum-exp, 9b without it and SDPA's
    backward (backend pinned and named) as single calls in turns, median,
    min and max; the plain version; the bound."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    rec = {}
    for label, (b, sq, sk, hq, hkv, dh, causal, window, off, dt) in \
            K9B_CASES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn(b, sq, hq, dh, generator=g, device=dev).to(dt)
        k = torch.randn(b, sk, hkv, dh, generator=g, device=dev).to(dt)
        v = torch.randn(b, sk, hkv, dh, generator=g, device=dev).to(dt)
        do = torch.randn(b, sq, hq, dh, generator=g, device=dev).to(dt)
        o, lse = fa_ops.attention_with_lse(q, k, v, causal, window, off)
        check((lse is not None) == (dt == torch.bfloat16),
              f"kernel 9 {label}: log-sum-exp saved {lse is not None}")

        def kern(saved=lse):
            return fa_ops.flash_attention_gqa_backward(
                q, k, v, o, do, causal, window, off, lse=saved)

        def plain():
            return fa_ref.attention_gqa_backward(
                q, k, v, o, do, causal=causal, window=window, q_offset=off)
        want = plain()
        bounds = fa_ref.backward_tolerance(q, k, v, o, do, causal=causal,
                                           window=window, q_offset=off)
        worst, ratio = 0.0, {}
        for saved in ((lse, None) if lse is not None else (None,)):
            tag = "computed" if saved is None else "saved"
            got = kern(saved)
            ratio[tag] = 0.0
            for x, y, bound, name in zip(got, want, bounds, "qkv"):
                err = (x.float() - y.float()).abs()
                r = float((err / bound).max())
                check(r <= 1.0, f"kernel 9b {label}, log-sum-exp {tag}: "
                                f"d{name} off its plain version by "
                                f"{float(err.max())}, {r:.3f} of the bound "
                                f"({fa_ref.TOL_BWD[dt]})")
                worst, ratio[tag] = max(worst, float(err.max())), max(
                    ratio[tag], r)
            del got
        first, second = kern(), kern()
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        check(same, f"kernel 9b {label}: two calls differ")
        del want, bounds, first, second
        backend, lib = sdpa_backward(q, k, v, do, causal, window, off)
        fns = {"9b": kern, "SDPA": lib}
        if lse is not None:
            fns["9b, log-sum-exp computed"] = lambda: kern(None)
        t = single_calls_ms(fns)
        p_ms = cuda_ms(plain, reps=3)
        bound, by, flops, nbytes = bwd_bound(q, k, causal, window, off)
        k_ms, l_ms = t["9b"][0], t["SDPA"][0]
        spread = "; ".join(f"{n} {m:.4f} ms (min {lo:.4f}, max {hi:.4f})"
                           for n, (m, lo, hi) in t.items())
        ratios = ", ".join(f"{r:.3f} with the log-sum-exp {n}"
                           for n, r in ratio.items())
        print(f"kernel 9b {label} (B {b}, Sq {sq}, Sk {sk}, {hq}/{hkv} "
              f"heads of {dh}, {str(dt).replace('torch.', '')}, causal "
              f"{causal}, window {window}, q_offset {off}): max err "
              f"{worst:.3e} ({ratios} of the "
              f"bound), two calls bit for bit; median of {TIMED_CALLS} "
              f"single calls in turns: {spread} (SDPA backend {backend}); "
              f"plain {p_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{flops / k_ms / 1e9:.2f} TFLOP/s of the bound's flops)")
        rec[label] = {"max_abs_err": worst, "ratio": ratio, "ms": k_ms,
                      "ms_min": t["9b"][1], "ms_max": t["9b"][2],
                      "single_calls_ms": t, "sdpa_backend": backend,
                      "plain_ms": p_ms, "library_ms": l_ms,
                      "bound_ms": bound, "bound_by": by, "flops": flops,
                      "bytes": nbytes, "bit_for_bit": same}
        del q, k, v, do, o, lse, lib
        gc.collect()
        torch.cuda.empty_cache()
    first = rec[K9B_CASES[0][0]]
    rec.update({key: first[key] for key in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")})
    rec["max_abs_err"] = max(r["max_abs_err"] for r in rec.values()
                             if isinstance(r, dict))
    return rec


def train_run(label, setup, steps, ckpt_dir, kernels, counted_keys,
              resume=False):
    """One Trainer run of ``setup() -> (state, step_fn, make_batch)`` to
    ``steps``, checkpointing every TRAIN_RESUME_AT steps into ``ckpt_dir``:
    (final state, losses, step seconds, launches a step of each of
    ``counted_keys``)."""
    from repro_torch.runtime.trainer import Trainer
    state, step_fn, make_batch = setup()
    times, launches = [], []

    def step(st, batch):
        before = {k: kernels[k].launches for k in counted_keys}
        t0 = time.perf_counter()
        out = step_fn(st, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append({k: kernels[k].launches - before[k]
                         for k in counted_keys})
        return out
    tr = Trainer(step, make_batch, str(ckpt_dir), ckpt_every=TRAIN_RESUME_AT,
                 meta={"arch": label})
    state, log = tr.run(state, steps, resume=resume)
    return state, [m["loss"] for m in log], times, launches


def resume_point(run_a: Path, run_b: Path) -> None:
    """Hand run a's step-TRAIN_RESUME_AT checkpoint to run b's directory
    by a rename (phase 20's checkpoint is 8.7 GiB; a copy would write it
    again)."""
    step = f"step_{TRAIN_RESUME_AT:010d}"
    run_b.mkdir(parents=True, exist_ok=True)
    (run_a / step).rename(run_b / step)


def check_prefetcher(dev, cfg) -> None:
    """DevicePrefetcher on the card: step_stream's batches, in order, as
    CUDA tensors."""
    from repro_torch.data.pipeline import (DevicePrefetcher, lm_batch,
                                           step_stream)
    pf = DevicePrefetcher(step_stream(lambda s: lm_batch(
        cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, s)), device=dev)
    for s in range(3):
        got = next(pf)
        want = lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, s)
        check(all(got[k].is_cuda and torch.equal(
            got[k].cpu(), torch.from_numpy(want[k])) for k in want),
            f"DevicePrefetcher batch {s} differs from step_stream's")
    pf.close()
    print("DevicePrefetcher on the card: 3 batches of step_stream in order, "
          "pinned and copied on a side stream")


def profile_step(setup) -> dict:
    """``profile_call`` of one training step from ``setup()``'s state on
    step 0's batch."""
    state, step_fn, make_batch = setup()
    batch = make_batch(0)
    out = profile_call(lambda: step_fn(state, batch), "training step")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(dev, kernels) -> dict:
    """Phase 18: smollm-135m and AutoInt trained at the registered widths
    through the launcher's setups (``launch/train.py``), the Trainer and
    AdamW, under the plain-version tripwire; then the training drivers as
    processes of their own."""
    import shutil
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import lm_setup, recsys_setup
    from repro_torch.optim.adamw import AdamW
    rec = {}
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    lm_cfg = get_config("smollm-135m")
    ai_cfg = get_config("autoint")
    check_prefetcher(dev, lm_cfg)
    # the optimizer of examples/train_lm.py
    opt = AdamW(lr=1e-3, total_steps=100, warmup_steps=5,
                schedule="constant")
    from repro_torch.kernels.flash_attention import ops as fa_ops
    lm_keys = ("flash_attention", "flash_attention_bwd")
    ai_keys = ("embedding_bag", "embedding_bag_bwd_keys",
               "embedding_bag_bwd_sort", "embedding_bag_bwd_tiles",
               "embedding_bag_bwd")
    launches = {k: 0 for k in lm_keys + ai_keys}
    lse_pass = fa_ops.KERNEL_BWD_LSE.launches
    with plain_tripwire() as plain_calls:
        def lm():
            return lm_setup(lm_cfg, dev, LM_TRAIN_BATCH, LM_TRAIN_SEQ, opt,
                            seq_chunk=LM_TRAIN_CHUNK)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full, losses, times, per_step = train_run(
            "smollm-135m", lm, TRAIN_STEPS, work / "lm_a", kernels, lm_keys)
        peak = torch.cuda.max_memory_allocated() / 2**30
        resume_point(work / "lm_a", work / "lm_b")
        resumed, losses_b, times_b, per_step_b = train_run(
            "smollm-135m", lm, TRAIN_STEPS, work / "lm_b", kernels, lm_keys,
            resume=True)
        same_loss = losses_b == losses[TRAIN_RESUME_AT:]
        same_params = all(torch.equal(full[0][k], resumed[0][k])
                          for k in full[0])
        same_state = all(torch.equal(full[1].mu[k], resumed[1].mu[k])
                         and torch.equal(full[1].nu[k], resumed[1].nu[k])
                         for k in full[1].mu)
        for ps in per_step + per_step_b:
            for k in lm_keys:
                launches[k] += ps[k]
        step_s = float(np.median(times[1:]))
        tok = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        print(f"smollm-135m ({lm_cfg.n_layers} layers, d {lm_cfg.d_model}, "
              f"vocab {lm_cfg.vocab}, {lm_cfg.dtype}, remat "
              f"{lm_cfg.remat_policy}, AdamW float32 state), B "
              f"{LM_TRAIN_BATCH} x S {LM_TRAIN_SEQ}, seq_chunk "
              f"{LM_TRAIN_CHUNK}: step {step_s * 1e3:.3f} ms median (first "
              f"{times[0] * 1e3:.1f} ms), {tok / step_s:,.1f} tokens/s; loss "
              f"step 0 {losses[0]:.4f}, step {TRAIN_RESUME_AT} "
              f"{losses[TRAIN_RESUME_AT]:.4f}, step {TRAIN_STEPS - 1} "
              f"{losses[-1]:.4f}; peak {peak:.3f} GiB")
        print(f"resumed from step {TRAIN_RESUME_AT}: losses of steps "
              f"{TRAIN_RESUME_AT}-{TRAIN_STEPS - 1} bit for bit "
              f"{same_loss}, final params bit for bit {same_params}, AdamW "
              f"moments bit for bit {same_state} (step "
              f"{times_b[1] * 1e3:.1f} ms)")
        check(losses[-1] < losses[TRAIN_RESUME_AT] < losses[0],
              f"smollm-135m loss does not fall: {losses}")
        check(same_loss and same_params and same_state,
              "the resumed smollm-135m run differs from the uninterrupted "
              "one")
        check(peak < LM_TRAIN_PEAK_GIB, f"smollm-135m training peak "
                                        f"{peak:.3f} GiB")
        check(all(ps["flash_attention_bwd"] == lm_cfg.n_layers
                  and ps["flash_attention"] >= lm_cfg.n_layers
                  for ps in per_step + per_step_b),
              f"a step missed kernel 9 or 9b: {per_step + per_step_b}")
        lse_pass = fa_ops.KERNEL_BWD_LSE.launches - lse_pass
        print(f"kernel 9b's first pass (the log-sum-exp computed): "
              f"{lse_pass} launches over both runs; 9b took kernel 9's "
              f"saved log-sum-exp on every call")
        check(lse_pass == 0, "9b recomputed the log-sum-exp while training")
        rec["smollm-135m"] = {
            "step_ms": step_s * 1e3, "tokens_per_s": tok / step_s,
            "first_step_ms": times[0] * 1e3, "losses": losses,
            "losses_resumed": losses_b, "peak_gib": peak,
            "resume_bit_for_bit": same_loss and same_params and same_state,
            "launches_a_step": per_step[1]}
        del full, resumed
        gc.collect()
        torch.cuda.empty_cache()
        print("-- profile of one smollm-135m training step (fresh state)")
        rec["smollm-135m"]["profile"] = profile_step(lm)

        def autoint():
            return recsys_setup(ai_cfg, dev, AI_TRAIN_ROWS, opt)
        torch.cuda.reset_peak_memory_stats()
        _, ai_losses, ai_times, ai_steps = train_run(
            "autoint", autoint, TRAIN_STEPS, work / "ai", kernels, ai_keys)
        ai_peak = torch.cuda.max_memory_allocated() / 2**30
        for ps in ai_steps:
            for k in ai_keys:
                launches[k] += ps[k]
        ai_s = float(np.median(ai_times[1:]))
        print(f"autoint ({ai_cfg.n_sparse} fields, table "
              f"{ai_cfg.n_embed_rows():,} rows x {ai_cfg.embed_dim} float32, "
              f"trained densely), {AI_TRAIN_ROWS:,} rows a step: step "
              f"{ai_s * 1e3:.3f} ms median (first {ai_times[0] * 1e3:.1f} "
              f"ms), {AI_TRAIN_ROWS / ai_s:,.1f} rows/s; loss step 0 "
              f"{ai_losses[0]:.4f}, step {TRAIN_RESUME_AT} "
              f"{ai_losses[TRAIN_RESUME_AT]:.4f}, step {TRAIN_STEPS - 1} "
              f"{ai_losses[-1]:.4f}; peak {ai_peak:.3f} GiB")
        check(ai_losses[-1] < ai_losses[0],
              f"autoint loss does not fall: {ai_losses}")
        check(ai_peak < AI_TRAIN_PEAK_GIB, f"autoint training peak "
                                           f"{ai_peak:.3f} GiB")
        check(all(ps[k] == 1 for ps in ai_steps for k in ai_keys),
              f"a step missed kernel 8 or one of 8b's three: {ai_steps}")
        print("-- profile of one autoint training step (fresh state)")
        ai_prof = profile_step(autoint)
        rec["autoint"] = {"profile": ai_prof, "step_ms": ai_s * 1e3,
                          "rows_per_s": AI_TRAIN_ROWS / ai_s,
                          "first_step_ms": ai_times[0] * 1e3,
                          "losses": ai_losses, "peak_gib": ai_peak,
                          "launches_a_step": ai_steps[1]}
    check(not any(plain_calls.values()),
          f"a plain version ran while training on the card: {plain_calls}")
    print(f"kernel launches over the training runs: {launches}; plain "
          f"versions called: {plain_calls}")
    shutil.rmtree(work, ignore_errors=True)
    rec["drivers"] = run_train_drivers()
    rec["launches"] = launches
    return rec


def run_train_drivers(drivers=TRAIN_DRIVERS) -> dict:
    """Phase 18's (and 20's) drivers: each of ``drivers`` in a process of
    its own on the card, as users run them, ``DRIVER_LANES`` at a time,
    a trainer's checkpoint directory of its own under build/; each must
    exit 0 and print its line."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    chains, cks = [], []
    for label, module, args, want in drivers:
        ck = tempfile.mkdtemp(prefix="train_ck_", dir=ROOT / "build")
        trains = "train" in module and "bfs" not in label
        cks.append(ck)
        chains.append([[sys.executable, "-m", module, *args,
                        *(["--ckpt-dir", ck] if trains else [])]])
    ts = time.perf_counter()
    try:
        results = run_lanes(chains)
    finally:
        for ck in cks:
            shutil.rmtree(ck, ignore_errors=True)
    print(f"{len(drivers)} training drivers, {DRIVER_LANES} at a time: "
          f"{time.perf_counter() - ts:.1f} s")
    rec = {}
    for (label, module, args, want), [(r, wall)] in zip(drivers, results):
        check(r.returncode == 0, f"{label} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        hit = [x for x in r.stdout.splitlines() if want in x]
        check(bool(hit), f"{label} printed no '{want}' line")
        print(f"-- {label} (python -m {module} {' '.join(args)}): exit 0 "
              f"in {wall:.1f} s: {hit[-1]}")
        rec[label] = {"wall_s": wall, "line": hit[-1]}
    return rec


# ------------------------------------------- MoE and the new LM configs
# phases 19-20: the four LM configs that came with the MoE layers,
# served and trained at the registered widths
NEW_LM_START_GIB = 2.0        # allocated when phase 19 starts
QWEN_PEAK_GIB = 72.0          # PERF.md section 2: 56.3 GiB of bf16 weights
MIXTRAL_LAYERS = 8            # of 56: 5.008 GB a layer, 280.9 GB in all
MIXTRAL_PROMPT, MIXTRAL_NEW = 6144, 16   # a prompt the 4,096 window masks
DENSE_REQUESTS = 4            # stablelm-3b and starcoder2-7b
# Phase 19's layer-by-layer hold: each layer, fed the kernel path's
# input, run with kernel 9 and with the plain attention; the gap of the
# two outputs over max|output| of the plain run, on the tokens whose
# top-k expert sets agree in both runs.  Derivation: kernel 9 is within
# ref.tolerance of the plain attention, 2**-7 |o| + 1.25 * 2**-8 max|v|,
# so within 2**-6 of max|v|; the output projection keeps that relative
# size (the error and the signal are sums over the same Hq * dh terms);
# the SwiGLU FFN, about 1-Lipschitz at these scales, carries it once
# more; the two bf16 roundings of the residual stream (+ attention, then
# + FFN) add half an ulp each, 2**-9 of max|output|.  2 * 2**-6 + 2 *
# 2**-9 = 0.035: max 0.05.  Most elements differ by their rounding
# alone, at most 2**-9 of max|output| on average: mean 0.005.
MOE_LAYER_TOL = {"max": 0.05, "mean": 0.005}
# A token's expert set flips where its k-th and (k+1)-th router logits lie
# closer than the logits move: the input of the router moves by about
# 2**-8 of its size (an ulp of bf16 where the attention's gap crosses a
# rounding edge), its logits, about N(0, 1) at these weights, by about
# 0.003, and the gap between the 8th and 9th largest of 128 such logits
# is about 0.06 on average: about 5% of the tokens a layer (fewer at 8
# experts top-2, whose gap is wider).  A wrong mask or head mapping moves
# the logits by their own scale and flips most of them.
MOE_FLIP_MAX = 0.25
EP_GRID = (2, 4)              # phase 19e's simulated "data" x "model" mesh
EP_TOKENS = 4096
EP_CAP_MULT = 0.1             # queue capacity 128: a shard's 512 tokens
#                               choose an expert about 32 times
EP_TOL = 2e-5                 # float32 against max|reference| (two sums
#                               over 2,048 and 768 terms in other orders)
DP_STEPS = 100                # tests/_dist_nn_main.py's dp_compress run
MOE_TRAIN_LAYERS = 1          # of 48: AdamW's float32 moments of all
#                               30.2 B parameters are 242 GB; one layer
#                               keeps each of the run's three checkpoints
#                               to 8.7 GiB
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 1024
# PERF.md section 2: 0.934 B parameters, 1.7 GiB in bf16, 1.7 GiB of
# gradients, 7.0 GiB of float32 moments, the optimizer's new state beside
# the old (8.7 GiB), a layer's MoE activations recomputed (about 8 GiB at
# 4,096 tokens) and the logit chunks: about 28 GiB
MOE_TRAIN_PEAK_GIB = 56.0
NEW_DRIVERS = [
    ("launch.serve qwen3-moe-30b-a3b", "repro_torch.launch.serve",
     ["--arch", "qwen3-moe-30b-a3b"], "req5:"),
    ("launch.train mixtral-8x22b", "repro_torch.launch.train",
     ["--arch", "mixtral-8x22b", "--steps", "20"],
     "mixtral-8x22b: 20 steps")]


def free_card() -> float:
    """Collect garbage and return cached blocks; GiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def gap_on(got, want, rows=None) -> dict:
    """{"max", "mean"} of |got - want| over max|want|, on the (token, :)
    rows where ``rows`` (a bool mask over the flattened tokens) holds."""
    d = (got.float() - want.float()).abs().reshape(-1, got.shape[-1])
    if rows is not None:
        d = d[rows]
    scale = float(want.float().abs().max())
    if d.numel() == 0:
        return {"max": 0.0, "mean": 0.0}
    return {"max": float(d.max()) / scale, "mean": float(d.mean()) / scale}


def layer_hold(cfg, params, tokens, dev) -> dict:
    """Phase 19's hold, layer by layer, of the prefill of ``tokens``:
    each layer fed the kernel path's input and run with kernel 9 and with
    the plain attention, held within MOE_LAYER_TOL on the tokens whose
    expert sets agree (at most MOE_FLIP_MAX flipped); beside it the
    plain path run on its own inputs, whose expert choices and final
    logits are printed against the kernel path's."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import rms_norm
    b, s = tokens.shape
    keys = tf.layer_keys(cfg)
    dt = params["wq"].dtype
    kv = (b, s, cfg.n_kv_heads, cfg.d_head)

    def run(h, lp, attn):
        ck = torch.empty(kv, dtype=dt, device=dev)
        cv = torch.empty(kv, dtype=dt, device=dev)
        a = tf._attn(h, lp, cfg, 0, ck, cv, attn)
        sets = None
        if cfg.moe is not None:
            hn = rms_norm(a, lp["ln2"], cfg.norm_eps).reshape(b * s, -1)
            sets = tf.moe_route(hn, lp["router"], cfg.moe.top_k)[1].sort(
                -1).values
        return tf._ffn(a, lp, cfg), sets

    rows = []
    with torch.inference_mode():
        h_k = params["embed"][tokens].to(dt)
        h_p = h_k
        for i in range(cfg.n_layers):
            lp = {k: params[k][i] for k in keys}
            out_k, set_k = run(h_k, lp, tf.kernel_attention)
            out_p, set_p = run(h_k, lp, tf.plain_attention)
            traj, set_t = run(h_p, lp, tf.plain_attention)
            agree = None if set_k is None else (set_k == set_p).all(-1)
            flips = 0.0 if agree is None else 1 - float(agree.float().mean())
            flips_t = 0.0 if set_k is None else 1 - float(
                (set_k == set_t).all(-1).float().mean())
            gap = gap_on(out_k, out_p, agree)
            rows.append({"layer": i, **gap, "flips": flips,
                         "flips_trajectory": flips_t})
            for key, lim in MOE_LAYER_TOL.items():
                check(gap[key] <= lim, f"{cfg.arch} layer {i}: {key} gap "
                                       f"{gap[key]:.5f} > {lim} on the "
                                       f"tokens whose experts agree")
            check(flips <= MOE_FLIP_MAX, f"{cfg.arch} layer {i}: "
                                         f"{flips:.3f} of the tokens chose "
                                         f"other experts")
            h_k, h_p = out_k, traj
        logits = [torch.einsum(
            "bd,vd->bv", rms_norm(h, params["final_ln"], cfg.norm_eps)[
                :, -1].float(), params["embed"].float())
            for h in (h_k, h_p)]
    whole = tf.logit_gap(*logits)
    mx = max(rows, key=lambda r: r["max"])
    print(f"{cfg.arch} layer by layer ({cfg.n_layers} layers, {b} x {s} "
          f"tokens, each layer fed the kernel path's input): worst max gap "
          f"{mx['max']:.5f} (layer {mx['layer']}), worst mean gap "
          f"{max(r['mean'] for r in rows):.5f} (limits {MOE_LAYER_TOL}); "
          f"expert sets flipped at the same input: "
          f"{float(np.mean([r['flips'] for r in rows])):.4f} of the (token, "
          f"layer) pairs, at most {max(r['flips'] for r in rows):.4f} a "
          f"layer (limit {MOE_FLIP_MAX})")
    print(f"{cfg.arch} whole model, each path on its own inputs: expert "
          f"sets differ at {float(np.mean([r['flips_trajectory'] for r in rows])):.4f} "
          f"of the (token, layer) pairs; last-position logit gap max "
          f"{whole['max']:.5f}, mean {whole['mean']:.5f} over max|logit|")
    return {"layers": rows, "whole_model_gap": whole,
            "flip_share": float(np.mean([r["flips"] for r in rows])),
            "flip_share_trajectory": float(np.mean(
                [r["flips_trajectory"] for r in rows]))}


def serve_config(dev, kernels, cfg, params, prompts, n_new, max_batch,
                 max_len, bucket) -> dict:
    """Serve ``prompts`` through ``Server`` with attention through kernel
    9: each prefill and decode call timed, layer 0's call of kernel 9
    recorded (copied), the launches counted; then the plain-attention
    path teacher-forced on the same calls, its logit gaps printed."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import make_lm_server
    from repro_torch.models import transformer as tf
    from repro_torch.runtime.server import Request
    server = make_lm_server(cfg, params, dev, max_batch=max_batch,
                            max_len=max_len, bucket=bucket)
    log = []
    pre, dec = server.prefill_fn, server.decode_fn

    def timed(kind, fn):
        def call(*a):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - ts) * 1e3
            tok = a[0] if kind == "prefill" else a[1]
            log.append((kind, ms, tok.clone(), None if kind == "prefill"
                        else a[2], out[1].clone()))
            return out
        return call
    server.prefill_fn = timed("prefill", pre)
    server.decode_fn = timed("decode", dec)
    reqs = [Request(prompt=p, max_new_tokens=n_new) for p in prompts]
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording([(fa_ops, "flash_attention_gqa", "flash_attention")],
                   every=cfg.n_layers, clone=True) as calls, \
            torch.inference_mode():
        ts = time.perf_counter()
        done = server.serve(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - ts
    launches = fa_ops.KERNEL.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == len(log) * cfg.n_layers,
          f"{cfg.arch}: flash_attention launched {launches} times for "
          f"{len(log)} calls of {cfg.n_layers} layers")
    n_gen = sum(len(r.out) for r in done)
    check(n_gen == len(prompts) * n_new and all(
        ((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done),
        f"{cfg.arch}: served tokens missing or out of the vocabulary")
    pre_ms = [x[1] for x in log if x[0] == "prefill"]
    dec_ms = [x[1] for x in log if x[0] == "decode"]
    gaps = []
    with torch.inference_mode():
        for kind, _, tok, pos, logits in log:
            check(bool(torch.isfinite(logits).all()),
                  f"{cfg.arch}: non-finite logits")
            if kind == "prefill":
                c = tf.init_kv_cache(cfg, max_batch, max_len, device=dev)
                c, want = tf.prefill(params, tok, c, cfg,
                                     attn=tf.plain_attention)
            else:
                c, want = tf.decode_step(params, c, tok, pos, cfg,
                                         attn=tf.plain_attention)
            gaps.append((kind, tf.logit_gap(logits, want)))
        del c
    dmed = float(np.median(dec_ms))
    print(f"{cfg.arch}: {len(prompts)} requests (prompts "
          f"{[len(p) for p in prompts]}), {n_new} new tokens each, "
          f"max_batch {max_batch}, bucket {bucket}: prefill ms "
          f"{[round(x, 3) for x in pre_ms]}; decode ms a step median "
          f"{dmed:.4f} (min {min(dec_ms):.4f}, max {max(dec_ms):.4f}, "
          f"{len(dec_ms)} steps of {max_batch} rows); {n_gen / serve_s:.3f} "
          f"tokens/s end to end, decode {max_batch / (dmed / 1e3):.3f} "
          f"tokens/s at the median step; peak {peak:.3f} GiB; kernel 9 "
          f"launched {launches} times ({smi_line()})")
    pg = [g for k, g in gaps if k == "prefill"]
    dg = [g for k, g in gaps if k == "decode"]
    print(f"{cfg.arch} whole model, kernel path vs plain path, logit gaps "
          f"over max|logit|: prefill max {[round(g['max'], 5) for g in pg]}, "
          f"teacher-forced decode ({len(dg)} steps) max of max "
          f"{max(g['max'] for g in dg):.5f}, max of mean "
          f"{max(g['mean'] for g in dg):.5f}")
    return {"calls": calls, "log": log, "launches": launches, "gaps": gaps,
            "record": {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                       "decode_median_ms": dmed, "serve_s": serve_s,
                       "tokens_per_s": n_gen / serve_s, "peak_gib": peak,
                       "launches": launches, "gaps": gaps,
                       "prompt_lens": [len(p) for p in prompts]}}


def kernel9_slices(calls, label) -> float:
    """Phase 19d: kernel 9 launched again at the first prefill call and
    the last decode call recorded at layer 0 (q, k, v copied as the call
    saw them), its first and last 128 query rows of the first and last
    sequences held against the plain version; the largest error."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    worst = 0.0
    picks = [calls[0], calls[-1]]
    for _, (q, k, v), kw in picks:
        causal, window, off = kw["causal"], kw["window"], kw["q_offset"]
        out = fa_ops.launch(q, k, v, causal, window, off)
        b, sq = q.shape[:2]
        rows = min(128, sq)
        for i in sorted({0, b - 1}):
            for r0 in sorted({0, sq - rows}):
                e, r = attn_close(out[i:i + 1, r0:r0 + rows],
                                  q[i:i + 1, r0:r0 + rows], k[i:i + 1],
                                  v[i:i + 1], causal, window, off + r0)
                worst = max(worst, e)
        print(f"kernel 9 at {label}'s {'prefill' if sq > 1 else 'decode'} "
              f"call (q {tuple(q.shape)}, {k.shape[1]} keys, window "
              f"{window}, q_offset {off}): the first and last {rows} query "
              f"rows of sequences 0 and {b - 1} within ref.tolerance, max "
              f"|kernel - plain| {e:.3e}")
    return worst


def serve_qwen(dev, kernels) -> dict:
    """Phase 19a: qwen3-moe-30b-a3b at the registered width and depth."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen3-moe-30b-a3b")
    start = free_card()
    print(f"device memory allocated as the phase starts: {start:.3f} GiB "
          f"(limit {NEW_LM_START_GIB})")
    check(start < NEW_LM_START_GIB, f"{start:.3f} GiB still allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.values())
    print(f"qwen3-moe-30b-a3b: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}: {n_par:,} "
          f"parameters (n_params() {cfg.n_params():,}, active "
          f"{cfg.n_active_params():,}), {n_par * 2 / 2**30:.3f} GiB, made on "
          f"the card layer by layer in {time.perf_counter() - t0:.3f} s")
    check(n_par == cfg.n_params(), "parameter count differs from n_params()")
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, LM_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]
    sv = serve_config(dev, kernels, cfg, params, prompts, LM_NEW,
                      LM_MAX_BATCH, LM_MAX_LEN, LM_BUCKET)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(peak < QWEN_PEAK_GIB, f"qwen3-moe-30b-a3b peak {peak:.3f} GiB")
    err = kernel9_slices(sv["calls"], cfg.arch)
    hold = layer_hold(cfg, params, sv["log"][0][2], dev)
    # where a prefill's and a decode step's time goes: every expert on
    # every token (_moe_reference) against attention and the rest
    prof = {}
    tokens = sv["log"][0][2]
    tok = torch.ones(LM_MAX_BATCH, 1, dtype=torch.int32, device=dev)
    cache = tf.init_kv_cache(cfg, LM_MAX_BATCH, LM_MAX_LEN, device=dev)
    with torch.inference_mode():
        print(f"-- profile of one prefill of {tuple(tokens.shape)}")
        prof["prefill"] = profile_call(
            lambda: tf.prefill(params, tokens, cache, cfg), "prefill")
        print("-- profile of one decode step (4 rows at position 1500)")
        prof["decode"] = profile_call(
            lambda: tf.decode_step(params, cache, tok, 1500, cfg),
            "decode step")
    del cache
    print(f"qwen3-moe-30b-a3b peak device memory over the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (limit "
          f"{QWEN_PEAK_GIB})")
    return {"launches": sv["launches"], "err": err,
            "record": {**sv["record"], "hold": hold, "k9_err": err,
                       "profile": prof}}


def serve_mixtral(dev, kernels) -> dict:
    """Phase 19b: mixtral-8x22b at the registered width, cut in depth."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_par = sum(p.numel() for p in params.values())
    print(f"mixtral-8x22b cut to {MIXTRAL_LAYERS} of {full.n_layers} layers "
          f"(its {full.n_params() * 2 / 1e9:.1f} GB of bf16 parameters do "
          f"not fit one card): d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, {cfg.moe.n_experts} "
          f"experts top-{cfg.moe.top_k} of d_ff {cfg.moe.d_ff_expert}, window "
          f"{cfg.swa_window}: {n_par:,} parameters, "
          f"{n_par * 2 / 1e9:.3f} GB")
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab, MIXTRAL_PROMPT).astype(np.int32)
    sv = serve_config(dev, kernels, cfg, params, [prompt], MIXTRAL_NEW, 1,
                      MIXTRAL_PROMPT + LM_BUCKET, LM_BUCKET)
    err = kernel9_slices(sv["calls"], cfg.arch)
    hold = layer_hold(cfg, params, sv["log"][0][2], dev)
    return {"launches": sv["launches"], "err": err,
            "record": {**sv["record"], "hold": hold, "k9_err": err,
                       "layers": MIXTRAL_LAYERS}}


def serve_dense(dev, kernels, arch) -> dict:
    """Phase 19c: a dense config at the registered width and depth, 4
    requests, held end to end within LOGIT_TOL_BF16; where a full-depth
    gap exceeds it, held layer by layer instead (and so printed)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_par = sum(p.numel() for p in params.values())
    print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_par:,} parameters, {n_par * 2 / 1e9:.3f} GB")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in rng.integers(64, 1025, DENSE_REQUESTS)]
    sv = serve_config(dev, kernels, cfg, params, prompts, LM_NEW,
                      LM_MAX_BATCH, LM_MAX_LEN, LM_BUCKET)
    err = kernel9_slices(sv["calls"], arch)
    over = [(k, g) for k, g in sv["gaps"] if any(
        g[key] > lim for key, lim in tf.LOGIT_TOL_BF16.items())]
    rec = {**sv["record"], "k9_err": err, "held": "end to end"}
    if over:
        print(f"{arch}: {len(over)} of {len(sv['gaps'])} calls' full-depth "
              f"logit gaps exceed LOGIT_TOL_BF16 {tf.LOGIT_TOL_BF16} (worst "
              f"{max(g['max'] for _, g in over):.5f}): held layer by layer")
        rec["held"] = "layer by layer"
        rec["hold"] = layer_hold(cfg, params, sv["log"][0][2], dev)
    else:
        print(f"{arch}: every call's full-depth logits within "
              f"LOGIT_TOL_BF16 {tf.LOGIT_TOL_BF16}")
    return {"launches": sv["launches"], "err": err, "record": rec}


def mesh_checks(dev) -> dict:
    """Phase 19e: the simulated mesh's exchanges at the registered
    widths, each counted by a ScheduleRecorder."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.core.collectives import ScheduleRecorder
    from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
    from repro_torch.models import embedding
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import ShardCtx
    from repro_torch.optim import dp_step
    from repro_torch.optim.adamw import SGDM
    free_card()
    rec = {}
    cfg = get_config("qwen3-moe-30b-a3b")
    ctx = ShardCtx(make_local_mesh(*EP_GRID, device=dev))
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    d, e_n, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale
    x = rnd(EP_TOKENS, d)
    w = [rnd(d, e_n, scale=d ** -0.5), rnd(e_n, d, f, scale=d ** -0.5),
         rnd(e_n, d, f, scale=d ** -0.5), rnd(e_n, f, d, scale=f ** -0.5)]
    n_dev = EP_GRID[0] * EP_GRID[1]
    tp = EP_GRID[1]
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        want = tf._moe_reference(x, *w, cfg)
        cap = tf.ep_capacity(EP_TOKENS // n_dev, cfg, tp, EP_CAP_MULT)
        r = tf.ep_route(x.reshape(n_dev, -1, d), w[0], cfg, tp, cap)
        check(bool(r["keep"].all()), f"capacity {cap} dropped choices")
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with ScheduleRecorder() as sched:
            got = tf.moe_ep_shardmap(x, *w, cfg, ctx,
                                     capacity_mult=EP_CAP_MULT)
        torch.cuda.synchronize()
        ep_ms = (time.perf_counter() - ts) * 1e3
        gap = gap_on(got, want)
        check(sched.counts() == {"all-to-all": 2, "total": 2},
              f"moe_ep_shardmap recorded {sched.counts()}")
        check(gap["max"] <= EP_TOL, f"moe_ep_shardmap off _moe_reference by "
                                    f"{gap['max']:.3e} of max|reference|")
        r2 = dataclasses.replace(cfg.moe, capacity_factor=1.0)
        cfg2 = dataclasses.replace(cfg, moe=r2)
        cap2 = tf.ep_capacity(EP_TOKENS // n_dev, cfg2, tp)
        drops = int((~tf.ep_route(x.reshape(n_dev, -1, d), w[0], cfg2, tp,
                                  cap2)["keep"]).sum())
        print(f"moe_ep_shardmap on a simulated {EP_GRID[0]}x{EP_GRID[1]} "
              f"('data', 'model') mesh at qwen3-moe-30b-a3b's widths, "
              f"{EP_TOKENS} float32 tokens, {e_n} experts top-"
              f"{cfg.moe.top_k}, queue capacity {cap}: {ep_ms:.3f} ms, "
              f"{sched.counts()['all-to-all']} all_to_alls recorded, max "
              f"|EP - reference| {gap['max']:.3e} of max|reference| (limit "
              f"{EP_TOL}), nothing dropped; at capacity_factor 1.0 "
              f"(qwen3-moe-r2) capacity {cap2}: {drops} of "
              f"{EP_TOKENS * cfg.moe.top_k} choices dropped; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        xd = x[:LM_MAX_BATCH]
        with ScheduleRecorder() as sched_d:
            got_d = tf.moe_decode_psum(xd, *w, cfg, ctx)
        gap_d = gap_on(got_d, tf._moe_reference(xd, *w, cfg))
        check(sched_d.counts() == {"all-reduce": 1, "total": 1},
              f"moe_decode_psum recorded {sched_d.counts()}")
        check(gap_d["max"] <= EP_TOL, f"moe_decode_psum off by "
                                      f"{gap_d['max']:.3e}")
        print(f"moe_decode_psum, {LM_MAX_BATCH} decode tokens on the same "
              f"mesh: 1 psum recorded, max |psum - reference| "
              f"{gap_d['max']:.3e} of max|reference|")
    rec["ep"] = {"ms": ep_ms, "gap": gap, "cap": cap, "drops_cf1": drops,
                 "cap_cf1": cap2, "decode_gap": gap_d}
    del x, w, want, got, r
    free_card()
    # the row-sharded lookup over the registered AutoInt table
    ai = get_config("autoint")
    bulk = next(s for s in ai.shapes if s.name == "serve_bulk")
    ga = torch.Generator(device=dev).manual_seed(SEED + 20)
    table = embedding.init_table(ai, ga, dev)
    idx = torch.stack([torch.randint(0, v, (bulk.batch,), generator=ga,
                                     device=dev)
                       for v in ai.vocab_sizes], 1).to(torch.int32)
    rows = embedding.flat_indices(ai, idx)
    ctx4 = ShardCtx(make_local_mesh(1, 4, device=dev))
    with torch.inference_mode():
        want = embedding.lookup(table, rows)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with ScheduleRecorder() as sched_l:
            got = embedding.lookup(table, rows, ctx4)
        torch.cuda.synchronize()
        lk_ms = (time.perf_counter() - ts) * 1e3
    same = bool(torch.equal(got, want))
    check(same, "the row-sharded lookup differs from the lookup with no mesh")
    check(sched_l.counts() == {"all-reduce": 1, "total": 1},
          f"the sharded lookup recorded {sched_l.counts()}")
    print(f"row-sharded lookup of the registered AutoInt table "
          f"({table.shape[0]:,} rows x {table.shape[1]}) on 4 'model' "
          f"shards, serve_bulk's {rows.numel():,} ids: {lk_ms:.3f} ms, 1 psum "
          f"recorded, bit for bit the lookup with no mesh (kernel 8)")
    rec["lookup"] = {"ms": lk_ms, "ids": rows.numel(), "bit_for_bit": same}
    del table, idx, rows, want, got
    free_card()
    # dp_step's three modes on 4 simulated replicas: the JAX test's run
    mesh = make_local_mesh_1d(4, device=dev)
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy((rng.normal(size=(16, 1)) * 0.3).astype(
        np.float32)).to(dev)
    opt = SGDM(lr=0.02, momentum=0.8)

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    rec["dp"], l0 = {}, None
    for mode in dp_step.MODES:
        step = dp_step.make_dp_compressed_step(loss_fn, opt, mesh, "data",
                                               mode=mode, ratio=0.25)
        state = dp_step.init_dp_state({"w": torch.zeros(16, 1, device=dev)},
                                      opt, mesh)
        for i in range(DP_STEPS):
            xb = torch.from_numpy(rng.normal(size=(4 * 8, 16)).astype(
                np.float32)).to(dev)
            with ScheduleRecorder() as sched_p:
                state, m = step(state, {"x": xb, "y": xb @ w_true})
            if l0 is None:
                l0 = float(m["loss"])
        last = float(m["loss"])
        rec["dp"][mode] = {"final_loss": last,
                           "residual_replicas": tuple(
                               state[2].residual["w"].shape)}
        check(sched_p.counts() == {"all-reduce": 2, "total": 2},
              f"dp_step {mode} recorded {sched_p.counts()}")
    lim = {"none": 0.05, "int8": 0.05, "topk": 0.5}
    for mode, r_ in rec["dp"].items():
        check(r_["final_loss"] < lim[mode] * l0,
              f"dp_step {mode}: loss {r_['final_loss']} after {DP_STEPS} "
              f"steps, not below {lim[mode]} x the first {l0}")
    print(f"dp_step on 4 simulated replicas, {DP_STEPS} steps each (the JAX "
          f"test's run): first loss {l0:.4f}; final "
          + ", ".join(f"{m} {r_['final_loss']:.5f} (< {lim[m]} x first)"
                      for m, r_ in rec["dp"].items())
          + "; 2 pmeans a step recorded; top-k residuals stacked "
          f"{rec['dp']['topk']['residual_replicas']}")
    rec["dp"]["first_loss"] = l0
    return rec


def moe_train_phase(dev, kernels) -> dict:
    """Phase 20: qwen3-moe-30b-a3b at the registered width, cut in depth,
    trained through the launcher's setup and the Trainer with a
    checkpoint at step 10, resumed; the same run under qwen3-moe-r1
    (remat "dots"); then the launchers of the new archs as processes."""
    import shutil
    import tempfile
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import lm_setup
    from repro_torch.optim.adamw import AdamW
    free_card()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train_moe_", dir=ROOT / "build"))
    full = get_config("qwen3-moe-30b-a3b")
    cfg = reduced(full, n_layers=MOE_TRAIN_LAYERS)
    cfg_r1 = reduced(get_config("qwen3-moe-r1"), n_layers=MOE_TRAIN_LAYERS)
    opt = AdamW(lr=1e-3, total_steps=100, warmup_steps=5,
                schedule="constant")
    keys = ("flash_attention", "flash_attention_bwd")
    lse_pass = fa_ops.KERNEL_BWD_LSE.launches
    launches = {k: 0 for k in keys}

    def setup(c):
        return lambda: lm_setup(c, dev, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, opt,
                                seq_chunk=LM_TRAIN_CHUNK)
    rec = {}
    with plain_tripwire() as plain_calls:
        torch.cuda.reset_peak_memory_stats()
        a, losses, times, per_step = train_run(
            "qwen3-moe-30b-a3b", setup(cfg), TRAIN_STEPS, work / "a",
            kernels, keys)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_par = sum(p.numel() for p in a[0].values())
        resume_point(work / "a", work / "b")
        shutil.rmtree(work / "a", ignore_errors=True)
        b, losses_b, times_b, per_step_b = train_run(
            "qwen3-moe-30b-a3b", setup(cfg), TRAIN_STEPS, work / "b",
            kernels, keys, resume=True)
        shutil.rmtree(work / "b", ignore_errors=True)
        same = (losses_b == losses[TRAIN_RESUME_AT:]
                and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
                and all(torch.equal(a[1].mu[k], b[1].mu[k])
                        and torch.equal(a[1].nu[k], b[1].nu[k])
                        for k in a[1].mu))
        del a, b
        free_card()
        # the same run under remat "dots", without checkpoints
        state, step_fn, make_batch = setup(cfg_r1)()
        losses_r1 = []
        for s in range(TRAIN_STEPS):
            state, m = step_fn(state, make_batch(s))
            losses_r1.append(float(m["loss"]))
        del state
        free_card()
        for ps in per_step + per_step_b:
            for k in keys:
                launches[k] += ps[k]
    step_s = float(np.median(times[1:]))
    tok = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    r1_gap = max(abs(x - y) / abs(y) for x, y in zip(losses_r1, losses))
    print(f"qwen3-moe-30b-a3b cut to {MOE_TRAIN_LAYERS} of {full.n_layers} "
          f"layers ({n_par:,} parameters; AdamW's float32 moments of the "
          f"whole model would be {full.n_params() * 8 / 1e9:.0f} GB), bf16, "
          f"remat {cfg.remat_policy}, B {MOE_TRAIN_BATCH} x S "
          f"{MOE_TRAIN_SEQ}, seq_chunk {LM_TRAIN_CHUNK}: step "
          f"{step_s * 1e3:.3f} ms median (first {times[0] * 1e3:.1f} ms), "
          f"{tok / step_s:,.1f} tokens/s; loss step 0 {losses[0]:.4f}, step "
          f"{TRAIN_RESUME_AT} {losses[TRAIN_RESUME_AT]:.4f}, step "
          f"{TRAIN_STEPS - 1} {losses[-1]:.4f}; peak {peak:.3f} GiB (limit "
          f"{MOE_TRAIN_PEAK_GIB}) ({smi_line()})")
    print(f"resumed from step {TRAIN_RESUME_AT}: losses, params and AdamW "
          f"moments bit for bit {same}; qwen3-moe-r1 (remat dots) losses "
          f"within {r1_gap:.3e} of remat full's (bit for bit "
          f"{losses_r1 == losses})")
    check(losses[-1] < losses[TRAIN_RESUME_AT] < losses[0],
          f"qwen3-moe loss does not fall: {losses}")
    check(same, "the resumed qwen3-moe run differs from the uninterrupted "
                "one")
    check(r1_gap <= 1e-5, f"remat dots losses off remat full's by {r1_gap}")
    check(peak < MOE_TRAIN_PEAK_GIB, f"qwen3-moe training peak {peak:.3f} "
                                     f"GiB")
    check(all(ps["flash_attention_bwd"] == cfg.n_layers
              and ps["flash_attention"] >= cfg.n_layers
              for ps in per_step + per_step_b),
          f"a step missed kernel 9 or 9b: {per_step + per_step_b}")
    check(fa_ops.KERNEL_BWD_LSE.launches == lse_pass,
          "9b recomputed the log-sum-exp while training")
    check(not any(plain_calls.values()),
          f"a plain version ran while training on the card: {plain_calls}")
    print(f"kernel launches over the two runs: {launches}; plain versions "
          f"called: {plain_calls}")
    shutil.rmtree(work, ignore_errors=True)
    rec.update({"step_ms": step_s * 1e3, "tokens_per_s": tok / step_s,
                "first_step_ms": times[0] * 1e3, "losses": losses,
                "losses_resumed": losses_b, "losses_r1": losses_r1,
                "r1_gap": r1_gap, "peak_gib": peak, "resume_bit_for_bit":
                same, "params": n_par, "launches_a_step": per_step[1]})
    rec["drivers"] = run_train_drivers(NEW_DRIVERS)
    rec["launches"] = launches
    return rec


def new_lm_phases(dev, kernels) -> dict:
    """Phases 19-20 (``main`` and ``--moe``): the new configs served and
    held, the simulated mesh, MoE training; their records and kernel
    launches."""
    rec, launches, errs, secs = {}, {}, {}, {}
    t0 = time.perf_counter()

    def lap(label):
        secs[label] = time.perf_counter() - t0 - sum(secs.values())
        print(f"({label}: {secs[label]:.1f} s)")
    phase("19a qwen3-moe-30b-a3b served at the registered width and depth: "
          "8 requests, held layer by layer")
    parts = {"qwen3-moe-30b-a3b": serve_qwen(dev, kernels)}
    lap("19a")
    phase(f"19b mixtral-8x22b at the registered width, {MIXTRAL_LAYERS} of "
          f"56 layers: a {MIXTRAL_PROMPT}-token prompt and {MIXTRAL_NEW} "
          f"decode steps, held layer by layer")
    parts["mixtral-8x22b"] = serve_mixtral(dev, kernels)
    lap("19b")
    phase("19c stablelm-3b and starcoder2-7b at the registered widths and "
          "depths: 4 requests each, held end to end")
    for arch in ("stablelm-3b", "starcoder2-7b"):
        parts[arch] = serve_dense(dev, kernels, arch)
    lap("19c")
    for arch, p in parts.items():
        rec[arch] = p["record"]
    launches["flash_attention"] = sum(p["launches"] for p in parts.values())
    errs["flash_attention"] = max(p["err"] for p in parts.values())
    print(f"19d: kernel 9 held against its plain version at each config's "
          f"prefill and decode call above; max |kernel - plain| "
          f"{errs['flash_attention']:.3e}")
    del parts
    phase("19e the simulated mesh: moe_ep_shardmap and moe_decode_psum at "
          "qwen3's widths, the row-sharded AutoInt lookup, dp_step's three "
          "modes")
    rec["mesh"] = mesh_checks(dev)
    lap("19e")
    phase(f"20 MoE training: qwen3-moe-30b-a3b, {MOE_TRAIN_LAYERS} of 48 "
          f"layers, B {MOE_TRAIN_BATCH} x S {MOE_TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps resumed from {TRAIN_RESUME_AT}; qwen3-moe-r1; the new "
          f"archs' launchers")
    rec["train"] = tr = moe_train_phase(dev, kernels)
    lap("20")
    rec["seconds"] = secs
    for k, n in tr["launches"].items():
        launches[k] = launches.get(k, 0) + n
    return {"record": rec, "launches": launches, "errs": errs}


def same_graph(got, want, tag: str) -> None:
    """Two graphs equal: the same fields, each ``torch.equal``, and the
    same m, m_input and capacities."""
    for c in ("m", "m_input", "cap", "cap_seg", "cap_nzc", "maxdeg_col"):
        check(getattr(got, c, None) == getattr(want, c, None),
              f"{tag}: {c} {getattr(got, c, None)} against "
              f"{getattr(want, c, None)}")
    ga, wa = got.device_arrays(), want.device_arrays()
    check(set(ga) == set(wa), f"{tag}: fields {sorted(ga)} against "
                              f"{sorted(wa)}")
    for k in ga:
        check(torch.equal(ga[k], wa[k]), f"{tag}: field {k} differs")


def digest(t: torch.Tensor) -> tuple:
    """A tensor's shape, dtype and two position-weighted int64 sums,
    taken on its device in pieces of 2^26 elements (the sums wrap
    modulo 2^64 in any order, so equal tensors give equal digests; an odd
    weight is invertible modulo 2^64, so one changed element changes
    both sums)."""
    flat = t.reshape(-1)
    s1 = torch.zeros((), dtype=torch.int64, device=t.device)
    s2 = torch.zeros((), dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), 1 << 26):
        x = flat[lo: lo + (1 << 26)].to(torch.int64)
        i = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                         device=t.device)
        s1 += (x * (2 * i + 1)).sum()
        s2 += ((x + 0x9E3779B9) * (i * 0x5851F42D | 1)).sum()
    return (tuple(t.shape), str(t.dtype), int(s1), int(s2))


def hold_budget(eng, roots_, tag: str) -> dict:
    """A scale-24 session held to its collective budget: each search from
    ``roots_`` again, untimed, under a ``ScheduleRecorder`` of its own;
    every level's recorded collectives (an instrumented level's counter
    psums aside) against ``comm_model.level_collective_budget`` of the
    session's schedule and grid (rule R4: no finding).  The first root's
    levels are printed, recorded count against budget."""
    from repro_torch.analysis.registry import session_budget_findings
    from repro_torch.core.collectives import ScheduleRecorder
    rows_all = []
    for i, r in enumerate(roots_):
        with ScheduleRecorder() as rec:
            eng.search(r)
        findings, rows = session_budget_findings(eng, rec, tag)
        check(not findings, f"{tag} root {r}: R4 "
              f"{[f.message for f in findings]}")
        if i == 0:
            print(f"{tag}, root {r}, level (mode) recorded/budget: "
                  + ", ".join(f"{x['level']} ({x['mode']}) "
                              f"{x['recorded']}/{x['budget']}"
                              for x in rows))
        rows_all.append(rows)
    most = {m: max((x["recorded"], x["budget"]) for rows in rows_all
                   for x in rows if x["mode"] == m)
            for m in ("td", "bu")
            if any(x["mode"] == m for rows in rows_all for x in rows)}
    print(f"{tag}: {sum(map(len, rows_all))} levels over {len(roots_)} "
          f"roots within budget (R4: no finding); the most a level "
          + ", ".join(f"{m} {a}/{b}" for m, (a, b) in most.items()))
    return {"rows": rows_all, "most": most}


def recorder_cost(eng, roots_) -> dict:
    """The searches from ``roots_`` host-timed in turns without and with
    a ``ScheduleRecorder`` (off, on, on, off); the ratio on/off of the
    sums."""
    from repro_torch.core.collectives import ScheduleRecorder
    wall = {"off": [], "on": []}
    n_rec = 0
    for kind in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        if kind == "on":
            with ScheduleRecorder() as rec:
                for r in roots_:
                    eng.search(r)
            n_rec = len(rec.records)
        else:
            for r in roots_:
                eng.search(r)
        torch.cuda.synchronize()
        wall[kind].append(time.perf_counter() - ts)
    ratio = sum(wall["on"]) / sum(wall["off"])
    print(f"recorder cost on {len(roots_)} searches, in turns (off, on, "
          f"on, off): off {wall['off'][0]:.4f} / {wall['off'][1]:.4f} s, on "
          f"{wall['on'][0]:.4f} / {wall['on'][1]:.4f} s ({n_rec} records); "
          f"on/off {ratio:.4f}")
    return {"off_s": wall["off"], "on_s": wall["on"], "records": n_rec,
            "ratio": ratio}


def graph_paths(dev, kernels, record, instr_per_s, path_2d, path_1ds):
    """Phases 3-10: the Graph500 paths (2D, then 1ds on 16 strips), their
    kernels and profiles.  Returns the launches on each path, each
    kernel's largest error, the per-kernel times and whether rmat_counter
    is bound by operations.  Everything it made on the card dies with
    it."""
    from dataclasses import replace

    from repro_torch.configs.base import BFSConfig, get_config, list_archs
    from repro_torch.core import decomp, steps_1d_sparse
    from repro_torch.core.comm_model import (codec_bits, codec_packed_words,
                                             rmat_strip_skew)
    from repro_torch.core.engine import plan_bfs, run_bfs_healed
    from repro_torch.core.frontier import INT_INF, pack_bits
    from repro_torch.core.metrics import harmonic_mean, teps
    from repro_torch.core.ref import TreeValidator
    from repro_torch.graph import rmat
    from repro_torch.graph.dist_build import BuildSpec, dist_build
    from repro_torch.graph.formats import build_blocked, build_blocked_1d
    from repro_torch.kernels import edge_cases
    from repro_torch.kernels.bottomup import ops as bu_ops
    from repro_torch.kernels.epilogue import ops as ep_ops
    from repro_torch.kernels.frontier_codec import ops as codec_ops
    from repro_torch.kernels.spmsv import ops as sp_ops
    from repro_torch.kernels.spmsv import strip
    from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
    from repro_torch.core.validate import validate_device, validate_parents
    from repro_torch.runtime.faultinject import (PARENT_FAULTS,
                                                 inject_parents,
                                                 undersize_cap)
    from repro_torch.runtime.retry import CapacityOverflow

    path_2d_csr = ("spmsv_csr_min", "bottomup_substep")
    path_2d_dcsc = ("spmsv_dcsc_min", "bottomup_substep")
    path_1d_csr = ("spmsv_strips_csr_min", "bottomup_substep")
    launches_new = {}      # the launches of phases 3b and 8b

    def host_reads(eng, roots_) -> float:
        """Host reads a search from ``roots_``, run again untimed: the
        level loop's tail reads (``decomp._masses``, in 2D
        ``decomp._read_front_2d``) and the 1ds exchange's own
        (``_send_counts``).  Kernel 1 reads nothing:
        phases 4b, 6 and 9b run its calls in a search under sync debug
        mode "error"."""
        return reads_of(lambda: [eng.search(r) for r in roots_],
                        len(roots_))

    def reads_of(run, n_searches: int) -> float:
        """Host reads a search of ``run()``, which runs ``n_searches``
        searches (the reads ``host_reads`` counts)."""
        with recording([(decomp, "_masses", "masses"),
                        (decomp, "_read_front_2d", "masses_2d"),
                        (steps_1d_sparse, "_send_counts", "send_counts")]
                       ) as calls:
            run()
        torch.cuda.synchronize()
        return len(calls) / n_searches

    def batch_beside_many(eng_b, tag) -> dict:
        """The roots batched and one by one, host-timed in turns (one by
        one, batched, batched, one by one): ``run_batch`` against
        ``run_many`` (each with the parents' host copy), then
        ``search_batch`` against ``search`` a root (the searches alone,
        parents left on the card); host reads a search of each."""
        wall = {"many": [], "batch": [], "search": [], "search_batch": []}
        runs_ = {"many": lambda: eng_b.run_many(roots),
                 "batch": lambda: eng_b.run_batch(roots),
                 "search": lambda: [eng_b.search(r) for r in roots],
                 "search_batch": lambda: eng_b.search_batch(roots)}
        for one, both in (("many", "batch"), ("search", "search_batch")):
            for kind in (one, both, both, one):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                out_ = runs_[kind]()
                torch.cuda.synchronize()
                wall[kind].append(time.perf_counter() - ts)
                del out_
        reads_b = reads_of(lambda: eng_b.search_batch(roots), len(roots))
        reads_m = host_reads(eng_b, roots)
        print(f"{tag}: {len(roots)} roots in {PODS} pods, in turns (one by "
              f"one, batched, batched, one by one): run_batch "
              f"{wall['batch'][0]:.4f} / {wall['batch'][1]:.4f} s, run_many "
              f"{wall['many'][0]:.4f} / {wall['many'][1]:.4f} s (each with "
              f"the parents' host copy); search_batch "
              f"{wall['search_batch'][0]:.4f} / "
              f"{wall['search_batch'][1]:.4f} s, {len(roots)} searches "
              f"{wall['search'][0]:.4f} / {wall['search'][1]:.4f} s (the "
              f"searches alone); host reads a search {reads_b:.2f} "
              f"batched, {reads_m:.2f} one by one")
        return {**{f"{k}_s": v for k, v in wall.items()},
                "host_reads_batch": reads_b, "host_reads_many": reads_m}

    def check_batch(b, want_par, want_lv, want_st, tag, lv_stats: bool,
                    validator) -> int:
        """A batch over ``roots`` against the single-root runs: parents
        (on every root, and each tree valid), the lockstep trip count of
        each scan position, and with ``lv_stats`` the stats rows: columns
        0-1 (``lv_stats == 2``) or 0-2 (3) on a root's own levels, column
        0 zero beyond them; else (uninstrumented) all zeros.  Returns
        the number of levels whose mode column differs from the single
        run's."""
        rpp = len(roots) // PODS
        own = np.asarray(want_lv)
        check(np.array_equal(b.n_levels, np.tile(
            np.maximum.reduce(own.reshape(PODS, rpp)), PODS)),
            f"{tag}: n_levels {b.n_levels.tolist()} is not the max of each "
            f"scan position's {own.tolist()}")
        n_diff = 0
        for i, r in enumerate(roots):
            par = torch.from_numpy(b.parents[i]).to(dev, torch.int32)
            check(torch.equal(par, want_par[i]),
                  f"{tag}: parents differ from the single-root run at "
                  f"root {r}")
            ok, msg = validator.check(r, par)
            check(ok, f"{tag} tree of root {r}: {msg}")
            st = b.level_stats[i]
            if lv_stats:
                lv = own[i]
                check(np.array_equal(st[:lv, :lv_stats],
                                     want_st[i][:lv, :lv_stats])
                      and not st[lv:, 0].any(),
                      f"{tag}: stats rows differ from the single-root "
                      f"run's at root {r}")
                n_diff += int((st[:lv, 2] != want_st[i][:lv, 2]).sum())
            else:
                check(not st.any(), f"{tag}: uninstrumented stats")
        return n_diff

    def fast_searches(eng, parents_, levels_, tag):
        """The roots again through ``eng``, an ``instrument=False``
        session: each search host-timed, its parents and levels checked
        bit-identical to the instrumented run's, no counters, zero
        stats.  Returns the search ms."""
        ms_ = []
        for r, par, lv in zip(roots, parents_, levels_):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = eng.search(r)
            torch.cuda.synchronize()
            ms_.append((time.perf_counter() - ts) * 1e3)
            check(out[1] == lv and torch.equal(
                out[0].reshape(-1)[: par.numel()], par),
                f"{tag}: instrument=False parents or levels differ at "
                f"root {r}")
            check(out[2] == {} and not out[3].any(),
                  f"{tag}: instrument=False returned counters or stats")
        return ms_

    def compare_fast(tag, ms_i, ms_f, reads_i, reads_f) -> dict:
        hm_i = harmonic_mean([teps(edges.m_input, x / 1e3) for x in ms_i])
        hm_f = harmonic_mean([teps(edges.m_input, x / 1e3) for x in ms_f])
        print(f"{tag}: instrument=False, the same {len(ms_f)} roots right "
              f"after: harmonic-mean TEPS {hm_f:.6e} (instrumented "
              f"{hm_i:.6e}); search ms median {float(np.median(ms_f)):.3f}"
              f" (instrumented {float(np.median(ms_i)):.3f}), min "
              f"{min(ms_f):.3f}, max {max(ms_f):.3f}; host reads a search "
              f"{reads_f:.2f} (instrumented {reads_i:.2f}); parents and "
              f"levels bit-identical on every root, no counters")
        return {"search_ms": ms_f, "teps_hmean": hm_f,
                "host_reads": reads_f, "host_reads_instrumented": reads_i}

    def validate_session(eng, tag, tv, path, limit) -> dict:
        """The Graph500 loop with validation on ``eng``: ``run_many(roots,
        validate=True)``, each report ok, its n_tree the host tree's size,
        and ``tv`` (the separate edge-list TreeValidator) agreeing.  Then
        each root's search again, and on its device parents the engine's
        validator alone (``validate_device``), host-timed beside
        ``tv.check`` on the same tree: validation stays outside every
        timed search.  The validated searches' launches of ``path`` join
        ``launches_new``.  The peak is reset here: the validation's own
        (the graph and sessions resident, the validator's pieces and
        ``tv``'s checks on top) and the phase's until here (``tv``'s keys
        included) must each stay under ``limit`` GiB."""
        before = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        res = eng.run_many(roots, validate=True)
        lv = {k: kernels[k].launches for k in path}
        for k, n in lv.items():
            check(n > 0, f"kernel {k} was never launched by the validated "
                         f"{tag} searches")
            launches_new[k] = launches_new.get(k, 0) + n
        n_orig = eng.plan.part.n_orig
        v_ms, t_ms, n_tree = [], [], []
        for r, x in zip(roots, res):
            rep = x.validation
            check(rep is not None and rep.ok, f"{tag} root {r}: "
                  f"{rep and rep.summary()}")
            check(rep.n_tree == int((x.parents >= 0).sum()),
                  f"{tag} root {r}: n_tree {rep.n_tree} is not the host "
                  f"tree's size")
            out = eng.search(r)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            again = validate_device(eng, r, out[0])
            t1 = time.perf_counter()
            ok, msg = tv.check(r, out[0].reshape(-1)[:n_orig])
            t2 = time.perf_counter()
            check(again == rep and ok == rep.ok,
                  f"{tag} root {r}: the validator's verdict {again.summary()}"
                  f" and TreeValidator's ({msg}) disagree")
            v_ms.append((t1 - ts) * 1e3)
            t_ms.append((t2 - t1) * 1e3)
            n_tree.append(rep.n_tree)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{tag}: run_many(validate=True) on {len(roots)} roots, every "
              f"report ok, n_tree the host tree's size, TreeValidator "
              f"agreeing; the engine's validator a tree (validate_device, "
              f"host-timed, one host read): median "
              f"{float(np.median(v_ms)):.3f} ms, min {min(v_ms):.3f}, max "
              f"{max(v_ms):.3f}; TreeValidator.check a tree median "
              f"{float(np.median(t_ms)):.3f} ms, min {min(t_ms):.3f}, max "
              f"{max(t_ms):.3f}; launches {lv}; peak device memory of the "
              f"validated searches and checks {peak:.3f} GiB (limit "
              f"{limit:.0f}; the phase's until then {before:.3f}); "
              f"{smi_line()}")
        check(max(peak, before) < limit, f"{tag}: peak {peak:.2f} GiB, the "
              f"phase's before it {before:.2f}, limit {limit} GiB")
        return {"validate_ms": v_ms, "tree_validator_ms": t_ms,
                "n_tree": n_tree, "launches": lv, "peak_gib": peak,
                "peak_before_gib": before}

    def kill_cases(eng, tag, tv, root, par_dev) -> list:
        """The five PARENT_FAULTS (seed 0) on one root's tree: injected on
        the host (the edge keys of ``tv`` and one BFS's true depths, both
        on the card, made once for the five), each validated on the card
        with ``validate_parents``, which must flag it, as ``tv`` must."""
        ts = time.perf_counter()
        depth = tv.depths(root)
        par = par_dev.cpu().numpy().astype(np.int64)
        setup_s = time.perf_counter() - ts
        cases = []
        for kind in PARENT_FAULTS:
            ts = time.perf_counter()
            bad, info = inject_parents(kind, par, root, 0, n=edges.n,
                                       src=edges.src, dst=edges.dst,
                                       chunk=eng.plan.part.chunk,
                                       keys=tv.keys, depth=depth)
            inject_s = time.perf_counter() - ts
            torch.cuda.synchronize()
            ts = time.perf_counter()
            rep = validate_parents(eng, root, bad)
            val_ms = (time.perf_counter() - ts) * 1e3
            ok, msg = tv.check(root, torch.from_numpy(bad).to(dev))
            check(not rep.ok, f"8f {tag} {kind}: the validator missed "
                              f"{info}")
            check(not ok, f"8f {tag} {kind}: TreeValidator passed {info}")
            print(f"8f kill {tag} {kind}: {info}; violations "
                  f"{rep.violations} (TreeValidator: {msg}); injection "
                  f"{inject_s:.3f} s on the host, validate_parents "
                  f"{val_ms:.3f} ms (the host array shipped and checked on "
                  f"the card)")
            cases.append({"session": tag, "kind": kind, "info": info,
                          "violations": rep.violations, "inject_s": inject_s,
                          "validate_ms": val_ms})
        print(f"8f kill {tag}: the oracle's true depths (one BFS on the card)"
              f" and the host copy of the tree {setup_s:.3f} s, once for the "
              f"five")
        cases[0]["setup_s"] = setup_s
        return cases
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
    # the same roots uninstrumented, right after; plan_bfs ships the
    # arrays already on the card as they are, so the graph stays one copy
    fast = plan_bfs(graph, BFSConfig(instrument=False), mesh,
                    local_mode="kernel").compile()
    for k in kernels.values():
        k.launches = 0
    fast_ms = fast_searches(fast, parents, levels, "2D")
    launches_fast = {k: kernels[k].launches for k in path_2d
                     if k != "rmat_counter"}
    peak_fast = torch.cuda.max_memory_allocated() / 2**30
    rec_fast = compare_fast("2D", search_ms, fast_ms,
                            host_reads(engine, roots),
                            host_reads(fast, roots))
    print(f"launches in the uninstrumented 2D searches: {launches_fast}; "
          f"peak device memory with both sessions {peak_fast:.3f} GiB")
    for k, n in launches_fast.items():
        check(n > 0, f"kernel {k} was never launched on the "
                     f"uninstrumented 2D path")
    check(peak_fast < 40.0, f"2D-path peak {peak_fast:.2f} GiB >= 40 GiB")
    rec_fast.update(launches=launches_fast, peak_gib=peak_fast)
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
    rec_val_3 = {"csr": validate_session(engine, "2D csr session", validator,
                                         path_2d_csr, 40.0)}
    # phase 8f's 2d 1x1 cases: the 2D graph does not outlive phase 3
    kills = kill_cases(engine, "2d 1x1", validator, roots[0], parents[0])
    del validator
    torch.cuda.empty_cache()
    dense = plan_bfs(graph, cfg, mesh, local_mode="dense").compile()
    # the oracle ends each level with the epilogue's plain twin
    ep_before = kernels["level_epilogue"].launches
    for r, par in zip(roots[:2], parents[:2]):
        out = dense.search(r)
        check(torch.equal(out[0].reshape(-1)[: graph.part.n_orig], par),
              f"dense parents differ from kernel parents at root {r}")
    check(kernels["level_epilogue"].launches == ep_before,
          "the dense oracle launched the level-epilogue kernel")
    print("local_mode='dense' sessions on 2 roots (no kernel, the level "
          "epilogue's plain twin included): parents bit-identical")
    del dense
    record["session"] = {
        "n": edges.n, "m_input": edges.m_input, "m": edges.m,
        "gen_s": t1 - t0, "build_s": t2 - t1, "ship_s": engine.ship_s,
        "compile_s": engine.compile_s, "roots": roots, "levels": levels,
        "modes": modes, "search_ms": search_ms, "teps_hmean": hmean,
        "peak_gib": peak_gib, "validate_s": val_s, "launches": launches,
        "fast": rec_fast, "validation": rec_val_3}

    # --------------------------------------------------------------- 3b
    phase(f"3b the registered bfs-rmat (2d, dcsc, reduce) on the same graph "
          f"and {N_ROOTS} roots, local_mode='kernel'; then bfs-rmat-fast, "
          f"bfs-rmat-opt-rt and bfs-rmat-pipe")
    words_2d = {m: graph.storage_words(m) for m in ("csr", "dcsc")}
    print(f"storage_words of the 2D graph (int32 words, §5.1): csr "
          f"{words_2d['csr']}, dcsc {words_2d['dcsc']}; peak device memory "
          f"of the 2D path {peak_gib:.3f} GiB")
    validator = TreeValidator(edges.n, edges.src, edges.dst)
    runs_2d = {}
    for arch in ("bfs-rmat", "bfs-rmat-fast", "bfs-rmat-opt-rt",
                 "bfs-rmat-pipe"):
        eng_a = plan_bfs(graph, get_config(arch), mesh,
                         local_mode="kernel").compile()
        for k in kernels.values():
            k.launches = 0
        ms_a, par_a, lv_a, st_a = [], [], [], []
        for r in roots:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = eng_a.search(r)
            torch.cuda.synchronize()
            ms_a.append((time.perf_counter() - ts) * 1e3)
            par_a.append(out[0].reshape(-1)[: graph.part.n_orig])
            lv_a.append(out[1])
            st_a.append(out[3].copy())
        la = {k: kernels[k].launches for k in path_2d_dcsc}
        for k, n in la.items():
            check(n > 0, f"kernel {k} was never launched by {arch}")
            launches_new[k] = launches_new.get(k, 0) + n
        want_p, want_l, what = (parents, levels, "the csr session's") \
            if arch == "bfs-rmat" else (runs_2d["bfs-rmat"]["parents"],
                                        runs_2d["bfs-rmat"]["levels"],
                                        "bfs-rmat's")
        for r, par, lv, wp, wl in zip(roots, par_a, lv_a, want_p, want_l):
            check(lv == wl and torch.equal(par, wp),
                  f"{arch}: parents or levels differ from {what} at root {r}")
            ok, msg = validator.check(r, par)
            check(ok, f"{arch} tree of root {r}: {msg}")
        reads = host_reads(eng_a, roots)
        hm = harmonic_mean([teps(edges.m_input, x / 1e3) for x in ms_a])
        print(f"{arch}: harmonic-mean TEPS {hm:.6e}; search ms median "
              f"{float(np.median(ms_a)):.3f}, min {min(ms_a):.3f}, max "
              f"{max(ms_a):.3f}; host reads a search {reads:.2f}; "
              f"launches {la}; parents and levels bit-identical to {what} "
              f"on all {N_ROOTS} roots, every tree valid")
        runs_2d[arch] = {"search_ms": ms_a, "teps_hmean": hm,
                         "host_reads": reads, "launches": la,
                         "parents": par_a, "levels": lv_a}
        if arch == "bfs-rmat":
            stats_2d = st_a
            eng_dcsc = eng_a
            rec_val_3["bfs-rmat"] = validate_session(
                eng_a, "bfs-rmat (2d, dcsc)", validator, path_2d_dcsc, 40.0)
        del eng_a
        if arch != "bfs-rmat":
            del runs_2d[arch]["parents"]
    print(f"beside the csr session (phase 3, bfs-rmat-csr's storage with "
          f"the reduce fold): TEPS {hmean:.6e}, search ms median "
          f"{float(np.median(search_ms)):.3f}, host reads a search "
          f"{rec_fast['host_reads_instrumented']:.2f}; uninstrumented "
          f"{rec_fast['teps_hmean']:.6e}, "
          f"{float(np.median(rec_fast['search_ms'])):.3f} ms, "
          f"{rec_fast['host_reads']:.2f}")

    # --------------------------------------------------------------- 3c
    phase(f"3c bfs-rmat-multiroot: the same {N_ROOTS} roots batched over "
          f"{PODS} pods of the 1x1 grid (run_batch), instrumented and not, "
          f"against bfs-rmat's single-root runs and beside run_many")
    single = runs_2d["bfs-rmat"]
    pod_mesh = make_local_mesh(1, 1, device=dev, pods=PODS)
    rec_3c = {}
    for instrument in (True, False):
        tag = f"bfs-rmat-multiroot, instrument={instrument}"
        eng_b = plan_bfs(graph, replace(get_config("bfs-rmat-multiroot"),
                                        instrument=instrument), pod_mesh,
                         local_mode="kernel").compile()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        ts = time.perf_counter()
        b = eng_b.run_batch(roots)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - ts
        lb = {k: kernels[k].launches for k in path_2d_dcsc}
        peak_b = torch.cuda.max_memory_allocated() / 2**30
        for k, n in lb.items():
            check(n > 0, f"kernel {k} was never launched by {tag}")
            launches_new[k] = launches_new.get(k, 0) + n
        n_diff = check_batch(b, single["parents"], single["levels"],
                             stats_2d, tag, 2 if instrument else 0,
                             validator)
        print(f"{tag}: n_levels {b.n_levels.tolist()} (bfs-rmat's own "
              f"{single['levels']}); parents equal bfs-rmat's on all "
              f"{N_ROOTS} roots, every tree valid; launches {lb}; first "
              f"batch {first_s:.4f} s (program built in "
              f"{eng_b.batch_compile_s:.4f} s); peak device memory "
              f"{peak_b:.3f} GiB"
              + (f"; stats columns 0-1 equal on each root's own levels, "
                 f"{n_diff} levels' modes differ (the shared decision)"
                 if instrument else "; stats all zero"))
        rec_3c[str(instrument)] = {
            "n_levels": b.n_levels.tolist(), "launches": lb,
            "peak_gib": peak_b, "first_batch_s": first_s,
            "modes_differ": n_diff, **batch_beside_many(eng_b, tag)}
        del eng_b, b
    # nothing of these searches may outlive the 2D graph (phase 8's peak)
    del runs_2d["bfs-rmat"]["parents"], validator, par_a, want_p, out, par
    del wp, single, stats_2d
    torch.cuda.empty_cache()
    record["session_2d_archs"] = {"storage_words": words_2d,
                                  "runs": runs_2d, "multiroot": rec_3c}

    # --------------------------------------------------------------- 3d
    phase(f"3d the born-sharded build: dist_build(BuildSpec({SCALE}, "
          f"{EDGE_FACTOR}, {SEED}), '2d') on the 1x1 grid against phase 3's "
          f"build_blocked graph, then BFSConfig()'s kernel session over it "
          f"on the {N_ROOTS} roots, validated")
    resident = torch.cuda.memory_allocated() / 2**30
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    born, info = dist_build(BuildSpec(SCALE, EDGE_FACTOR, SEED), "2d", mesh,
                            (1, 1))
    torch.cuda.synchronize()
    peak_3d = torch.cuda.max_memory_allocated() / 2**30
    gen_3d = kernels["rmat_counter"].launches
    check(gen_3d == 1, f"3d: {gen_3d} counter launches for one slice")
    launches_new["rmat_counter"] = launches_new.get("rmat_counter", 0) + gen_3d
    same_graph(born, graph, "3d")
    gen_s, build_s = record["session"]["gen_s"], record["session"]["build_s"]
    print(f"the born graph equals phase 3's field for field "
          f"({len(born.device_arrays())} fields, torch.equal) with m={born.m}"
          f", cap={born.cap}, cap_seg={born.cap_seg}, maxdeg_col="
          f"{born.maxdeg_col}; dist_build {info['build_s']:.3f} s "
          f"(generate and route {info['gen_route_s']:.3f} s, dedup and "
          f"formats {info['format_s']:.3f} s; {info['build_teps']:.4e} "
          f"input edges/s) against phase 3's generate + preprocess "
          f"{gen_s:.3f} s and build_blocked {build_s:.3f} s; route words "
          f"measured {info['route_words_measured']} (expected "
          f"{info['route_words_expected']}, the padded exchange's "
          f"{info['route_words_padded']}); peak device memory "
          f"{peak_3d:.3f} GiB with phase 3's graph and sessions resident "
          f"({resident:.3f} GiB before the build; limit 75); {smi_line()}")
    check(peak_3d < 75.0, f"3d peak {peak_3d:.2f} GiB >= 75 GiB")
    eng = plan_bfs(born, cfg, mesh, local_mode="kernel").compile()
    for k in kernels.values():
        k.launches = 0
    res = eng.run_many(roots, validate=True)
    lb = {k: kernels[k].launches for k in path_2d_csr}
    for k, n in lb.items():
        check(n > 0, f"kernel {k} was never launched by the born session")
        launches_new[k] = launches_new.get(k, 0) + n
    for r, x, par, lv in zip(roots, res, parents, levels):
        check(x.validation.ok and x.n_levels == lv and torch.equal(
            torch.from_numpy(x.parents).to(dev, torch.int32), par),
            f"3d root {r}: the born session's tree differs from phase 3's "
            f"or fails validation: {x.validation.summary()}")
    print(f"BFSConfig() kernel session over the born graph, run_many(roots, "
          f"validate=True): parents and n_levels equal phase 3's csr session"
          f" on all {N_ROOTS} roots, every verdict clean; launches {lb}")
    record["born_2d"] = {
        "build_s": info["build_s"], "gen_route_s": info["gen_route_s"],
        "format_s": info["format_s"], "host_gen_s": gen_s,
        "host_build_s": build_s, "peak_gib": peak_3d,
        "resident_gib": resident, "launches": {"rmat_counter": gen_3d, **lb},
        **{k: info[k] for k in ("cap_route", "route_words_measured",
                                "route_words_expected",
                                "route_words_padded")}}
    del eng, res, born, x
    torch.cuda.empty_cache()

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
    for name, (pi0, deg_, cand, recv, root_) in edge_cases.epilogue_cases(
            1, 1, part.chunk, device=dev).items():
        pi_k = pi0.clone()
        got = ep_ops.level_epilogue(pi_k, deg_, cand, recv, root_)
        want = ep_ops.level_epilogue_plain(pi0, deg_, cand, recv, root_)
        e = max(max_err(pi_k, pi0), max_err(got.words, want.words),
                max_err(got.masses, want.masses))
        errs["level_epilogue"] = max(errs["level_epilogue"], e)
        print(f"level_epilogue    case {name:>14} ({part.chunk} vertices): "
              f"masses {want.masses.tolist()}, max |kernel - plain| = {e}")
        del pi0, deg_, cand, recv, pi_k, got, want
    for k in path_2d:
        check(errs[k] == 0, f"{k} disagrees with its plain version (max err "
                            f"{errs[k]})")
    print(f"the 2D path's {len(path_2d)} kernels equal their plain versions "
          f"(tolerance 0)")

    # --------------------------------------------------------------- 4b
    phase("4b kernel 1 through the DCSC on the frontiers of one bfs-rmat "
          "search against its plain version and the col_ptr addressing "
          "(tolerance 0), each entry timed whole; the search's kernel-1 "
          "calls under sync debug mode 'error'")
    with recording([(sp_ops, "spmsv_min", "spmsv_dcsc_min")]) as calls, \
            no_host_reads(sp_ops, "spmsv_min") as guarded:
        eng_dcsc.search(roots[0])
    torch.cuda.synchronize()
    check(len(guarded) > 0, "no kernel-1 call in the bfs-rmat search")
    print(f"one bfs-rmat search: its {len(guarded)} kernel-1 calls ran under "
          f"torch.cuda.set_sync_debug_mode('error'): no host read")
    cptr = graph.col_ptr[0, 0]

    def csr_beside(seg, words, nr, coff):
        """The col_ptr addressing on the same frontier: equal, and its
        entry on the card alone."""
        by_ptr = sp_ops.csr(cptr, seg.row_idx)
        e = max_err(sp_ops.launch(seg, words, nr, coff)[0],
                    sp_ops.launch(by_ptr, words, nr, coff)[0])
        return [("csr_ms", device_ms(lambda: sp_ops.spmsv_min(
            by_ptr, words, nr, coff)), e)]
    per_dcsc = kernel1_rows(sp_ops, calls, "spmsv_dcsc_min", csr_beside)
    errs["spmsv_dcsc_min"] = per_dcsc["max_abs_err"]
    del calls

    # ---------------------------------------------------------------- 5
    phase(f"5 simulated meshes at scale {MESH_SCALE}, instrumented: 2x2, "
          f"4x4 and {STRIPS} strips")
    small = rmat.rmat_graph(MESH_SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    small_val = TreeValidator(small.n, small.src, small.dst)
    srng = np.random.default_rng(1)

    def same_as_dense(a, b, r, tag, validate=True):
        """A kernel session's result equals the dense session's in
        parents, levels, level_stats and counters, and its tree is
        valid (unless ``validate`` is False: a "*_pure" fold drops
        winners by design)."""
        check(np.array_equal(a.parents, b.parents), f"parents {tag}")
        check(a.n_levels == b.n_levels, f"levels {tag}")
        check(np.array_equal(a.level_stats, b.level_stats),
              f"level_stats {tag}")
        for k, v in b.counters.items():
            want_v = b.counters["edges_useful"] \
                if k == "edges_examined" else v
            check(a.counters[k] == want_v, f"counter {k} {tag}")
        if validate:
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
    # every registered 2D arch on both grids (the bitmap fold, compact
    # updates, edge-row reads, the R/G ring); the "*_pure" folds drop
    # what passes their capacities, so their trees are not validated
    archs_2d = [a for a in list_archs() if a.startswith("bfs-rmat")
                and get_config(a).decomposition == "2d"
                and a != "bfs-rmat-multiroot"]    # bfs-rmat batched: 3c
    # and every tree through the engine's own validator (validate_parents
    # on the kernel session's shards), whose verdict must be
    # TreeValidator's, the "*_pure" folds' overflowed trees included
    flagged = []
    for pr, pc in ((2, 2), (4, 4)):
        sg = build_blocked(small, pr, pc)
        smesh = make_local_mesh(pr, pc, device=dev)
        for arch in archs_2d:
            acfg = get_config(arch)
            ek = plan_bfs(sg, acfg, smesh, local_mode="kernel").compile()
            ed = plan_bfs(sg, acfg, smesh, local_mode="dense").compile()
            pure = acfg.fold_mode.endswith("_pure")
            for _ in range(2):
                r = rmat.random_source(small, srng)
                a, b = ek.run(r), ed.run(r)
                same_as_dense(a, b, r, f"{arch} {pr}x{pc}", validate=not pure)
                rep = validate_parents(ek, r, a.parents)
                ok, msg = small_val.check(r, torch.from_numpy(a.parents).to(
                    dev))
                check(rep.ok == ok, f"{arch} {pr}x{pc} root {r}: validator "
                      f"{rep.summary()} against TreeValidator {msg}")
                if not rep.ok:
                    flagged.append((arch, f"{pr}x{pc}", r, rep.violations))
                print(f"{pr}x{pc} {arch:>16} root {r:>6}: {a.n_levels} "
                      f"levels: kernel == dense in parents, levels, "
                      f"level_stats and counters; validator "
                      f"{'ok' if rep.ok else 'FLAGGED'} as TreeValidator ("
                      f"{msg})")
    print(f"phase 5: the validator flagged {len(flagged)} trees, each one "
          f"TreeValidator rejects: {flagged}")
    record["mesh_validation_flagged"] = flagged
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

    # --------------------------------------------------------------- 5b
    phase("5b the collective-schedule checks on the card: the registry "
          "lint (R1-R4, every LocalOps combo, the kernel entries among "
          "them), the broken 2D fixture, phase 3's scale-24 sessions held "
          "to their budgets, the recorder's cost")
    from repro_torch.analysis.fixtures import FIXTURE_NAME, lint_fixture
    from repro_torch.analysis.registry import lint_registry
    t0 = time.perf_counter()
    report = lint_registry(device=dev)
    lint_s = time.perf_counter() - t0
    check(report["clean"], f"registry lint: {report['findings'][:3]}")
    kernel_combos = sum("/kernel/" in c["name"] for c in report["combos"])
    print(f"lint_registry on the card: {len(report['combos'])} combos "
          f"({kernel_combos} on kernel entries) clean of R1-R3, "
          f"{len(report['budget_cases'])} budget cases within their "
          f"budgets (R4), in {lint_s:.3f} s")
    check(kernel_combos > 0, "the registry lint ran no kernel entry")
    fixture = {}
    for instr in (False, True):
        fs = lint_fixture(instr, device=dev)
        r1 = [f for f in fs if f.rule == "R1"
              and f.detail["collective"] == "ppermute"]
        check(bool(r1) and r1[0].detail["divergent_axes"] == ["pod"],
              f"R1 did not flag {FIXTURE_NAME} (instrument={instr})")
        fixture[instr] = [f.rule for f in fs]
        print(f"{FIXTURE_NAME} instrument={instr}: {len(r1)} R1 findings "
              f"on its permutes, rules {sorted(set(fixture[instr]))}; "
              f"e.g. {r1[0].message}")
    sched = {"lint_s": lint_s, "combos": len(report["combos"]),
             "kernel_combos": kernel_combos,
             "budget_cases": len(report["budget_cases"]),
             "fixture_rules": fixture,
             "csr": hold_budget(engine, roots, "2D csr session 1x1, "
                                "instrumented"),
             "csr_fast": hold_budget(fast, roots, "2D csr session 1x1, "
                                     "instrument=False"),
             "recorder": recorder_cost(engine, roots)}
    record["schedule"] = sched

    # ---------------------------------------------------------------- 6
    phase("6 kernel times level by level on one 2D search; its kernel-1 "
          "calls under sync debug mode 'error'")
    with recording([(sp_ops, "spmsv_min", "spmsv_csr_min"),
                    (bu_ops, "bottomup_substep", "bottomup_substep")]
                   ) as calls, no_host_reads(sp_ops, "spmsv_min") as guarded:
        engine.search(roots[0])
    # the kernel's launches (the LocalOps entry holds level_epilogue
    # itself; it launches through the module's ``launch``)
    with recording([(ep_ops, "launch", "level_epilogue")],
                   clone=True) as ep_calls, \
            no_host_reads(ep_ops, "launch") as ep_guarded:
        engine.search(roots[0])
    torch.cuda.synchronize()
    check(len(guarded) > 0, "no kernel-1 call in the 2D csr search")
    check(len(ep_guarded) > 0, "no level-epilogue call in the 2D search")
    print(f"one 2D csr search: its {len(ep_guarded)} level-epilogue calls "
          f"ran under torch.cuda.set_sync_debug_mode('error'): no host read")
    print(f"one 2D csr search: its {len(guarded)} kernel-1 calls ran under "
          f"torch.cuda.set_sync_debug_mode('error'): no host read")
    per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "calls": 0} for k in kernels}
    per["spmsv_csr_min"] = kernel1_rows(
        sp_ops, [c for c in calls if c[0] == "spmsv_csr_min"],
        "spmsv_csr_min")
    errs["spmsv_csr_min"] = max(errs["spmsv_csr_min"],
                                per["spmsv_csr_min"]["max_abs_err"])
    for lvl, (kname, a, _) in enumerate(calls):
        if kname != "bottomup_substep":
            continue
        row = per[kname]
        row["calls"] += 1
        rp, uew, fw, cv, coff, ne = a
        k_ms = device_ms(lambda: bu_ops.launch(rp, uew, fw, cv, coff, ne))
        p_ms = cuda_ms(lambda: bu_ops.bottomup_substep_plain(
            rp, uew, fw, cv, coff, ne), reps=3)
        nbytes, n_live, read = bottomup_bytes(rp, uew, fw, cv)
        b_ms = nbytes / HBM_BW * 1e3
        row["ms"] += k_ms
        row["plain_ms"] += p_ms
        row["bound_ms"] += b_ms
        print(f"call {lvl} {kname}: {n_live} live rows, {read} edges read "
              f"to the first hit, on the card alone {k_ms / b_ms:.2f}x its "
              f"bound: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({nbytes} bytes)")
    # the wrapper itself: its host work (salts, two allocations) is
    # microseconds against a launch of milliseconds
    per["rmat_counter"]["ms"] = cuda_ms(lambda: rmat.rmat_edges_counter(
        SCALE, EDGE_FACTOR, seed=SEED, device=dev), reps=5)
    per["rmat_counter"]["plain_ms"] = cuda_ms(
        lambda: rmat.rmat_edges_counter_plain(SCALE, EDGE_FACTOR, seed=SEED,
                                              device=dev), reps=1)
    # the rate of the bound: the larger of phase 2's integer rate on the
    # level body and the kernel's own issue rate in this run (its SASS
    # instructions a level over its time), so that the bound is never
    # slower than what the kernel itself issues
    own_per_s = (record["int_rate"]["rmat_counter_instr_per_level"] * SCALE
                 * m_in / (per["rmat_counter"]["ms"] / 1e3))
    rate = max(instr_per_s, own_per_s)
    rb = 8 * m_in / HBM_BW * 1e3
    ro = RMAT_INSTR_PER_EDGE_LEVEL * SCALE * m_in / rate * 1e3
    per["rmat_counter"]["bound_ms"] = max(rb, ro)
    per["rmat_counter"]["calls"] = 1
    record["int_rate"]["rmat_counter_own_per_s"] = own_per_s
    record["int_rate"]["bound_per_s"] = rate
    print(f"rmat_counter: full stream of {m_in} edges: kernel "
          f"{per['rmat_counter']['ms']:.4f} ms, plain "
          f"{per['rmat_counter']['plain_ms']:.4f} ms; its own issue rate "
          f"{own_per_s / 1e12:.3f} T instructions/s against phase 2's "
          f"{instr_per_s / 1e12:.3f}; bound "
          f"max({rb:.4f} ms bytes, {ro:.4f} ms issuing "
          f"{RMAT_INSTR_PER_EDGE_LEVEL} instructions per edge and level at "
          f"the larger, {rate / 1e12:.3f} T/s): "
          f"{max(rb, ro) / per['rmat_counter']['ms']:.1%} of its bound")
    r = per["bottomup_substep"]
    print(f"bottomup_substep: {r['calls']} launches in one search: kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.5f} ms")
    r = per["level_epilogue"]
    for lvl, (_, a, kw) in enumerate(ep_calls):
        t = epilogue_times(ep_ops, a, kw)
        errs["level_epilogue"] = max(errs["level_epilogue"], t["err"])
        r["calls"] += 1
        for key in ("ms", "plain_ms", "bound_ms"):
            r[key] += t[key]
        print(f"call {lvl} level_epilogue: n_f {t['n_f']}, on the card "
              f"alone {t['ms'] / t['bound_ms']:.2f}x its bound: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.5f} ms ({t['bytes']} bytes), max |kernel - "
              f"plain| = {t['err']}")
    del ep_calls
    print(f"level_epilogue: {r['calls']} launches in one search: kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.5f} ms")
    check(errs["level_epilogue"] == 0, "level_epilogue disagrees with its "
          "plain twin on the search's calls")
    per["spmsv_dcsc_min"] = per_dcsc
    record["kernel_times"] = per
    # the synthetic cases at the 2D path's width (one segment of 2^24
    # rows): rows of 0-1,100 edges with first hits past edge 32, an edge
    # count cutting a row, all rows completed, the frontier in the last
    # word
    for name, (rp, ci, fw, cv, ne) in edge_cases.bottomup_cases(
            1, part.chunk, device=dev, gap=256).items():
        args = (rp[0], ci[0], fw, cv[0], part.nc, int(ne[0]))
        got = bu_ops.launch(*args)
        want = bu_ops.bottomup_substep_plain(*args)
        e = max_err(got, want)
        errs["bottomup_substep"] = max(errs["bottomup_substep"], e)
        print(f"bottomup_substep  case {name:>9} ({part.chunk} rows, "
              f"{int(ne[0])} edges): {int((want != INT_INF).sum())} "
              f"parents found, max |kernel - plain| = {e}")
        del got, want, args, rp, ci, fw, cv, ne
    check(errs["bottomup_substep"] == 0, "bottomup_substep disagrees with "
          "its plain version on the 2D-width cases")

    # ---------------------------------------------------------------- 7
    phase("7 profile of one 2D search, instrumented and not")
    record["profile"] = profile_call(lambda: engine.search(roots[0]))
    print("-- instrument=False")
    record["profile_fast"] = profile_call(lambda: fast.search(roots[0]))

    # ---------------------------------------------------------------- 8
    phase(f"8 1ds path: the same Graph500 graph on {STRIPS} simulated "
          f"strips, local_mode='kernel', storage='dcsc', packed codec, "
          f"expand_chunks {' and '.join(map(str, STRIP_CHUNKS))}")
    levels_2d = levels[:2]
    del engine, fast, eng_dcsc, graph, edges, parents
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
    # with the (p, n+1) strip col_ptr, which the csr strips read (8b)
    graph = build_blocked_1d(edges, STRIPS, with_edge_lists=False,
                             with_col_ptr=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    part = graph.part
    mesh = make_local_mesh_1d(STRIPS, device=dev)
    dense_words = np.float32((STRIPS - 1) * (part.n / 64.0))
    runs = {}
    # the walk of every strip SpMSV call (kernel 3 at C=1, kernel 4 at
    # C=4) of the searches phase 8 runs, by kernel and search kind
    walks_8 = {"spmsv_strip_min": {}, "spmsv_strip_chunk_min": {}}
    near_8 = {"spmsv_strip_min": [], "spmsv_strip_chunk_min": []}

    def tally_walks(eng, roots_, c, kind):
        """The walk of every strip SpMSV call of the searches from
        ``roots_``, run again untimed; the calls within 4x of the
        threshold are timed with each walk forced."""
        cap = strip.list_capacity(graph.cap_nzc, c)
        kname = "spmsv_strip_min" if c == 1 else "spmsv_strip_chunk_min"
        fn = "spmsv_strip_dcsc" if c == 1 else "spmsv_strip_dcsc_chunk"
        with recording([(strip, fn, kname)]) as calls:
            for r in roots_:
                eng.search(r)
        walks = walks_8[kname].setdefault(kind, [])
        for _, a, kw in calls:
            ids = strip.popcount(a[4])
            walks.append(strip.chunk_walk(a[4], cap))
            if ids <= cap // 4:
                continue
            if c == 1:
                timed = [device_ms(lambda: strip.launch(*a, list_cap=lc))
                         for lc in (part.n, 0)]
            else:
                timed = [device_ms(lambda: strip.launch_chunk(
                    *a, kw["n"], kw["k"], c, list_cap=lc))
                    for lc in (part.n // c, 0)]
            near_8[kname].append((kind, ids, cap, walks[-1], *timed))

    for c in STRIP_CHUNKS:
        cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                        frontier_codec="packed", expand_chunks=c)
        eng = plan_bfs(graph, cfg, mesh, local_mode="kernel").compile()
        run = {"engine": eng, "search_ms": [], "levels": [], "modes": [],
               "overflowed": [], "wire_expand": [], "parents": [],
               "stats": []}
        bu_before = kernels["bottomup_substep"].launches
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
            run["stats"].append(out[3].copy())
        run["bu_launches"] = kernels["bottomup_substep"].launches - bu_before
        run["bu_levels"] = sum(m.count(1) for m in run["modes"])
        runs[c] = run
    launches_1ds = {k: kernels[k].launches for k in path_1ds}
    # the same roots uninstrumented at each expand_chunks, right after,
    # on the same shipped graph; the launches are those of the 16 fast
    # searches alone, read before the host-read reruns
    fast_1ds = {k: 0 for k in path_1ds if k != "rmat_counter"}
    for c in STRIP_CHUNKS:
        run = runs[c]
        fast = plan_bfs(graph, BFSConfig(
            decomposition="1ds", storage="dcsc", frontier_codec="packed",
            expand_chunks=c, instrument=False), mesh,
            local_mode="kernel").compile()
        for k in kernels.values():
            k.launches = 0
        ms_f = fast_searches(fast, run["parents"], run["levels"],
                             f"1ds expand_chunks={c}")
        for k in fast_1ds:
            fast_1ds[k] += kernels[k].launches
        run["fast"] = compare_fast(
            f"1ds expand_chunks={c}", run["search_ms"], ms_f,
            host_reads(run["engine"], roots), host_reads(fast, roots))
        run["fast_engine"] = fast
    print(f"launches in the uninstrumented 1ds searches: {fast_1ds}")
    for k, n in fast_1ds.items():
        check(n > 0, f"kernel {k} was never launched on the uninstrumented "
                     f"1ds path")
        launches_fast[k] = launches_fast.get(k, 0) + n
    for c in STRIP_CHUNKS:
        tally_walks(runs[c]["engine"], roots, c, "direction-optimizing")
    # phase 5b's budget hold on the strips' sessions
    for c in STRIP_CHUNKS:
        record["schedule"][f"1ds_c{c}"] = hold_budget(
            runs[c]["engine"], roots, f"1ds expand_chunks={c}, instrumented")
        record["schedule"][f"1ds_c{c}_fast"] = hold_budget(
            runs[c]["fast_engine"], roots,
            f"1ds expand_chunks={c}, instrument=False")
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
            "wire_expand": run["wire_expand"],
            "bu_launches": run["bu_launches"], "fast": run["fast"]}
    print(f"peak device memory of the 1ds path (generation, build and "
          f"both sessions): {peak_1ds:.3f} GiB")
    print(f"launches in the 1ds path: {launches_1ds}")
    for k, n in launches_1ds.items():
        check(n > 0, f"kernel {k} was never launched on the 1ds path")
    for c, run in runs.items():
        print(f"expand_chunks={c}: {run['bu_launches']} bottomup_substep "
              f"launches over the {N_ROOTS} searches' {run['bu_levels']} "
              f"bottom-up levels")
        check(run["bu_launches"] == run["bu_levels"],
              f"expand_chunks={c}: not one bottom-up launch per bottom-up "
              f"level")
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
    # the paper's 1D baseline traverses top-down only: its wide levels
    # are the strip SpMSV calls that walk the columns.  Each strip
    # min-picks the smallest frontier in-neighbour in either direction,
    # so the parents equal the direction-optimizing run's
    td_rec = {}
    for c in STRIP_CHUNKS:
        eng = plan_bfs(graph, BFSConfig(
            decomposition="1ds", storage="dcsc", frontier_codec="packed",
            expand_chunks=c, direction_optimizing=False), mesh,
            local_mode="kernel").compile()
        for i, r in enumerate(roots[:2]):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = eng.search(r)
            torch.cuda.synchronize()
            td_rec[f"{c}/{r}"] = (time.perf_counter() - ts) * 1e3
            check(torch.equal(out[0].reshape(-1)[: part.n_orig],
                              runs[c]["parents"][i]),
                  f"top-down-only parents differ at root {r}, C={c}")
            print(f"top-down only, expand_chunks={c}, root {r}: {out[1]} "
                  f"levels, search {td_rec[f'{c}/{r}']:.3f} ms: parents "
                  f"equal the direction-optimizing run's")
        tally_walks(eng, roots[:2], c, "top-down only")
        del eng
    rec_1ds["topdown_only_ms"] = td_rec

    # --------------------------------------------------------------- 8b
    phase(f"8b the csr strips against the dcsc strips on the same {STRIPS} "
          f"strips and {N_ROOTS} roots: bfs-rmat-1d against bfs-rmat-1d-dcsc, "
          f"bfs-rmat-1ds against its dcsc twin, then bfs-rmat-1ds-pipe and "
          f"bfs-rmat-1d-pipe (kernel 1 on each sub-chunk's partial bitmap)")
    words_1d = {m: graph.storage_words(m) for m in ("csr", "dcsc")}
    peak_8 = torch.cuda.max_memory_allocated() / 2**30
    print(f"storage_words of the strips (int32 words, §5.1): csr "
          f"{words_1d['csr']}, dcsc {words_1d['dcsc']}; the strip col_ptr "
          f"{graph.col_ptr.numel() * 4 / 1e9:.3f} GB; peak device memory "
          f"since phase 8 began {peak_8:.3f} GiB")
    check(peak_8 < 75.0, f"strip peak {peak_8:.2f} GiB >= 75 GiB")
    torch.cuda.reset_peak_memory_stats()
    validator = TreeValidator(edges.n, edges.src, edges.dst)
    c0 = STRIP_CHUNKS[0]
    codec = ("codec_encode", "codec_decode")
    # each arch with the kernels it must launch; the dcsc twin of
    # bfs-rmat-1ds is phase 8's C=1 session, timed again here
    strip_archs = [
        ("bfs-rmat-1d", get_config("bfs-rmat-1d"), path_1d_csr),
        ("bfs-rmat-1d-dcsc", get_config("bfs-rmat-1d-dcsc"),
         ("spmsv_strip_min", "bottomup_substep")),
        ("bfs-rmat-1ds", get_config("bfs-rmat-1ds"), path_1d_csr + codec),
        ("bfs-rmat-1ds/dcsc", replace(get_config("bfs-rmat-1ds"),
                                      storage="dcsc"),
         ("spmsv_strip_min", "bottomup_substep") + codec),
        ("bfs-rmat-1ds-pipe", get_config("bfs-rmat-1ds-pipe"),
         path_1d_csr + codec),
        ("bfs-rmat-1d-pipe", get_config("bfs-rmat-1d-pipe"), path_1d_csr)]
    csr_1d = {}
    stats_1d = []          # bfs-rmat-1d's level stats a root (phase 8d)
    for arch, acfg, path in strip_archs:
        eng = plan_bfs(graph, acfg, mesh, local_mode="kernel").compile()
        for k in kernels.values():
            k.launches = 0
        ms_a = []
        for i, r in enumerate(roots):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = eng.search(r)
            torch.cuda.synchronize()
            ms_a.append((time.perf_counter() - ts) * 1e3)
            par = out[0].reshape(-1)[: part.n_orig]
            check(torch.equal(par, runs[c0]["parents"][i])
                  and out[1] == runs[c0]["levels"][i],
                  f"{arch}: parents or levels differ from the dcsc strips' "
                  f"at root {r}")
            ok, msg = validator.check(r, par)
            check(ok, f"{arch} tree of root {r}: {msg}")
            if arch == "bfs-rmat-1d":
                stats_1d.append(out[3].copy())
        la = {k: kernels[k].launches for k in path}
        for k, n in la.items():
            check(n > 0, f"kernel {k} was never launched by {arch}")
            launches_new[k] = launches_new.get(k, 0) + n
        reads = host_reads(eng, roots[:2])
        print(f"{arch} (storage {acfg.storage}, expand_chunks "
              f"{acfg.expand_chunks}, instrument {acfg.instrument}): search "
              f"ms median {float(np.median(ms_a)):.3f}, min {min(ms_a):.3f}, "
              f"max {max(ms_a):.3f}; host reads a search {reads:.2f}; "
              f"launches {la}; parents and levels equal the dcsc strips' "
              f"(phase 8) on all {N_ROOTS} roots, trees valid")
        csr_1d[arch] = {"storage": acfg.storage, "search_ms": ms_a,
                        "host_reads": reads, "launches": la}
        if arch == "bfs-rmat-1d":
            eng_1d_csr = eng
        del eng, out, par
    for csr, dcsc in (("bfs-rmat-1d", "bfs-rmat-1d-dcsc"),
                      ("bfs-rmat-1ds", "bfs-rmat-1ds/dcsc")):
        d = [x - y for x, y in zip(csr_1d[csr]["search_ms"],
                                   csr_1d[dcsc]["search_ms"])]
        print(f"Fig. 6, {csr} csr - dcsc on the same roots: median "
              f"{float(np.median(d)):.3f} ms, min {min(d):.3f}, max "
              f"{max(d):.3f}; csr faster on {sum(x < 0 for x in d)} of "
              f"{len(d)} roots")
    peak_csr = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory of the strips' sessions (8b alone): "
          f"{peak_csr:.3f} GiB")
    check(peak_csr < 75.0, f"strip peak {peak_csr:.2f} GiB >= 75 GiB")
    rec_1ds["csr_strips"] = {"storage_words": words_1d, "runs": csr_1d,
                             "peak_gib": peak_csr, "peak_phase8_gib": peak_8}
    # phase 8's validation: the C=1 dcsc session and bfs-rmat-1d (kernel
    # 1's strip entry), the peak since 8b's reset
    rec_1ds["validation"] = {
        "1ds": validate_session(runs[c0]["engine"], "1ds C=1 (dcsc, packed)",
                                validator, ("spmsv_strip_min",
                                            "bottomup_substep") + codec,
                                75.0),
        "bfs-rmat-1d": validate_session(eng_1d_csr, "bfs-rmat-1d (csr strips)",
                                        validator, path_1d_csr, 75.0)}

    # --------------------------------------------------------------- 8c
    phase(f"8c phase 8's 1ds dcsc session (expand_chunks {c0}) batched over "
          f"{PODS} pods of the {STRIPS} strips: run_batch on the same "
          f"{N_ROOTS} roots, each pod switching on its own frontier")
    torch.cuda.reset_peak_memory_stats()
    tag = "1ds dcsc batch"
    eng_b = plan_bfs(graph, BFSConfig(
        decomposition="1ds", storage="dcsc", frontier_codec="packed",
        expand_chunks=c0), make_local_mesh_1d(STRIPS, device=dev, pods=PODS),
        local_mode="kernel").compile()
    path_8c = ("spmsv_strip_min", "bottomup_substep") + codec
    for k in kernels.values():
        k.launches = 0
    ts = time.perf_counter()
    b = eng_b.run_batch(roots)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - ts
    lb = {k: kernels[k].launches for k in path_8c}
    for k, n in lb.items():
        check(n > 0, f"kernel {k} was never launched by the {tag}")
        launches_new[k] = launches_new.get(k, 0) + n
    run = runs[c0]
    n_diff = check_batch(b, run["parents"], run["levels"], run["stats"], tag,
                         3, validator)
    check(n_diff == 0, f"{tag}: a pod's modes differ from its single run")
    peak_8c = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag}: n_levels {b.n_levels.tolist()} (the single runs' "
          f"{run['levels']}); parents equal phase 8's on all {N_ROOTS} "
          f"roots, every tree valid, stats columns 0-2 equal on each root's "
          f"own levels; launches {lb}; first batch {first_s:.4f} s; peak "
          f"device memory {peak_8c:.3f} GiB")
    check(peak_8c < 75.0, f"8c peak {peak_8c:.2f} GiB >= 75 GiB")
    rec_1ds["batch"] = {"n_levels": b.n_levels.tolist(), "launches": lb,
                        "peak_gib": peak_8c, "first_batch_s": first_s,
                        **batch_beside_many(eng_b, tag)}
    del eng_b, b

    # --------------------------------------------------------------- 8d
    phase("8d the cap_f bound of kernel 1's strip entry: bfs-rmat-1d with "
          "cap_f below a top-down frontier raises; at the widest frontier "
          "of these searches, 8b's parents")

    def td_sizes(st):
        return [int(x) for x in st[(st[:, 2] == 0) & (st[:, 0] > 0), 0]]

    cfg_1d = get_config("bfs-rmat-1d")
    hub = int(torch.argmax(graph.deg_A.reshape(-1)))
    below = max(max(td_sizes(st), default=0) for st in stats_1d) - 1
    check(below >= 1, "no top-down frontier of two ids or more")
    raised = None
    try:
        eng = plan_bfs(graph, cfg_1d, mesh, local_mode="kernel",
                       cap_f=below).compile()
        for r in roots:
            eng.search(r)
    except ValueError as exc:
        raised = str(exc)
    check(raised is not None and f"exceeds cap_f={below}" in raised,
          f"bfs-rmat-1d with cap_f={below} did not raise: {raised}")
    widest = max([below + 1, *td_sizes(eng_1d_csr.search(hub)[3])])
    eng = plan_bfs(graph, cfg_1d, mesh, local_mode="kernel",
                   cap_f=widest).compile()
    for k in kernels.values():
        k.launches = 0
    for i, r in enumerate(roots):
        out = eng.search(r)
        check(torch.equal(out[0].reshape(-1)[: part.n_orig],
                          run["parents"][i]),
              f"bfs-rmat-1d with cap_f={widest}: parents differ at root {r}")
    n = kernels["spmsv_strips_csr_min"].launches
    check(n > 0, "no spmsv_strips_csr_min launch under cap_f")
    launches_new["spmsv_strips_csr_min"] += n
    print(f"bfs-rmat-1d, cap_f={below} (the roots' widest top-down "
          f"frontier less one): raised \"{raised}\"; cap_f="
          f"{widest} (the widest top-down frontier of the {N_ROOTS} roots "
          f"and the warm-up hub): parents equal 8b's on all {N_ROOTS} "
          f"roots, {n} strip-kernel launches")
    rec_1ds["cap_f"] = {"below": below, "raised": raised,
                        "widest": widest, "launches": n}
    del eng, out, validator, stats_1d

    name = {strip.WALK_FRONTIER: "frontier", strip.WALK_COLUMNS: "column"}
    for kname, by_kind in walks_8.items():
        for kind, ws in by_kind.items():
            print(f"{kname}: {len(ws)} launches on the "
                  f"{N_ROOTS if kind[0] == 'd' else 2} {kind} searches "
                  f"({ws.count(1)} frontier walks, {ws.count(2)} column "
                  f"walks): each call's frontier count against "
                  f"strip.list_capacity (phase 9 reads the kernel's own "
                  f"report)")
        for kind, ids, cap, w, f_ms, c_ms in near_8[kname]:
            print(f"  {kind}: a call of {ids} ids (threshold {cap}) takes "
                  f"the {name[w]} walk; forced, on the card alone: frontier "
                  f"walk {f_ms:.4f} ms, column walk {c_ms:.4f} ms")
    rec_1ds["walks"] = walks_8
    rec_1ds["near_threshold"] = near_8

    # --------------------------------------------------------------- 8e
    phase(f"8e heal: run_bfs_healed on the {STRIPS} strips (1ds, dcsc, "
          f"packed, instrumented, top-down only as the JAX package's fault "
          f"matrix heals it) from cap_x = undersize_cap(planned cap_x, "
          f"seed=0)")
    cfg_h = BFSConfig(decomposition="1ds", storage="dcsc",
                      frontier_codec="packed", direction_optimizing=False)
    squeezed = undersize_cap(cap_x, 0)
    path_8e = ("spmsv_strip_min",) + codec
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ts = time.perf_counter()
    healed = run_bfs_healed(graph, cfg_h, mesh, roots[0], cap_x=squeezed,
                            max_attempts=HEAL_ATTEMPTS, validate=True,
                            local_mode="kernel")
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - ts
    log = healed.retry_log
    check(len(log) > 1 and log[-1]["outcome"] == "ok"
          and all(a["outcome"] == "overflow" for a in log[:-1]),
          f"8e: cap_x={squeezed} did not overflow and heal: {log}")
    for a in log:
        print(f"attempt {a['attempt']}: cap_x={a['cap_value']} -> "
              f"{a['outcome']}, overflowed levels "
              f"{a['detail'].get('levels', [])}")
    lh = {k: kernels[k].launches for k in path_8e}
    for k, n in lh.items():
        check(n > 0, f"kernel {k} was never launched by the healed run")
        launches_new[k] = launches_new.get(k, 0) + n
    heal_ms = []
    for i, r in enumerate(roots):
        ts = time.perf_counter()
        res = healed.engine.run(r, validate=True)
        heal_ms.append((time.perf_counter() - ts) * 1e3)
        check(torch.equal(torch.from_numpy(res.parents).to(dev),
                          runs[c0]["parents"][i].to(torch.int64)),
              f"8e: the healed session's parents differ from phase 8's at "
              f"root {r}")
    exhausted = None
    try:
        run_bfs_healed(graph, cfg_h, mesh, roots[0], cap_x=squeezed,
                       max_attempts=1, local_mode="kernel")
    except CapacityOverflow as exc:
        exhausted = exc
    check(exhausted is not None and len(exhausted.history) == 1,
          "8e: max_attempts=1 did not raise CapacityOverflow")
    peak_8e = torch.cuda.max_memory_allocated() / 2**30
    print(f"healed from cap_x={squeezed} (planned {cap_x}) to "
          f"{healed.plan.statics.cap_x} in {len(log)} attempts, "
          f"{heal_s:.3f} s (each attempt a session built and one validated "
          f"search from root {roots[0]}); the healed session on all "
          f"{N_ROOTS} roots, validate=True: parents equal phase 8's, "
          f"run ms a root median {float(np.median(heal_ms)):.3f} (search, "
          f"validation and host copy); launches {lh}; peak device memory "
          f"{peak_8e:.3f} GiB; {smi_line()}")
    print(f"max_attempts=1: CapacityOverflow: {exhausted}; history "
          f"{exhausted.history_json()}")
    check(peak_8e < 75.0, f"8e peak {peak_8e:.2f} GiB >= 75 GiB")
    rec_1ds["heal"] = {"cap_x0": squeezed, "cap_x_planned": cap_x,
                       "retry_log": log, "heal_s": heal_s,
                       "run_ms": heal_ms, "launches": lh,
                       "peak_gib": peak_8e,
                       "exhausted": str(exhausted),
                       "exhausted_history": exhausted.history_json()}
    del healed, res

    # --------------------------------------------------------------- 8f
    phase("8f kill: the five PARENT_FAULTS on one root of each scale-"
          f"{SCALE} session (2d 1x1 in phase 3; 1d and 1ds on {STRIPS} "
          f"strips): validate_parents flags every one")
    validator = TreeValidator(edges.n, edges.src, edges.dst)
    kills += kill_cases(eng_1d_csr, "1d (bfs-rmat-1d)", validator,
                        roots[0], runs[c0]["parents"][0])
    kills += kill_cases(runs[c0]["engine"], "1ds C=1", validator, roots[0],
                        runs[c0]["parents"][0])
    del validator
    torch.cuda.empty_cache()
    check(len(kills) == 3 * len(PARENT_FAULTS),
          f"8f: {len(kills)} kill cases")
    inject_s = sum(c["inject_s"] + c.get("setup_s", 0.0) for c in kills)
    val_ms = [c["validate_ms"] for c in kills]
    print(f"8f: all {len(kills)} kill cases flagged by the validator and by "
          f"TreeValidator; host cost of the injections {inject_s:.3f} s in "
          f"all; validate_parents on the card median "
          f"{float(np.median(val_ms)):.3f} ms, min {min(val_ms):.3f}, max "
          f"{max(val_ms):.3f}; {smi_line()}")
    rec_1ds["kill"] = kills
    # phase 8g's reference: the C=1 session's trees, on the host
    born_ref = {"roots": roots, "levels": runs[c0]["levels"],
                "parents": torch.stack(runs[c0]["parents"]).cpu()}
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
               (bu_ops, "bottomup_substep_strips", "bottomup_substep")]
    per_1ds = {c: {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                       "library_ms": 0.0, "device_ms": 0.0, "floor_ms": 0.0,
                       "calls": 0}
                   for _, _, k in targets} for c in STRIP_CHUNKS}
    nr = part.chunk

    # the walks of the recorded calls, as the kernels reported them
    walks = {k: {strip.WALK_FRONTIER: 0, strip.WALK_COLUMNS: 0}
             for k in ("spmsv_strip_min", "spmsv_strip_chunk_min")}
    walk_name = {strip.WALK_FRONTIER: "frontier", strip.WALK_COLUMNS:
                 "columns"}

    def strip_call(kname, a, kw, label, row):
        """Compare one strip SpMSV call with its plain version, with the
        walk threshold at its default and forced to each walk (kernel 3),
        and time kernel (on the card alone), plain and the library
        scatter; the walk the call took, as the kernel reports it."""
        jc, cp, nzc, ridx, words = a[:5]
        n_front = strip.popcount(words)
        if kname == "spmsv_strip_min":
            live = strip.live_slots(jc, nzc, words)
            cap = strip.list_capacity(jc.shape[1], 1)

            def run_k(list_cap=None):
                return strip.launch(*a, list_cap=list_cap)

            def run_p():
                return strip.spmsv_strip_dcsc_plain(*a)
        else:
            live = strip.live_slots_chunk(jc, nzc, words, kw["k"],
                                          kw["n_chunks"], part.chunk,
                                          part.n)
            cap = strip.list_capacity(jc.shape[1], kw["n_chunks"])

            def run_k(list_cap=None):
                return strip.launch_chunk(*a, kw["n"], kw["k"],
                                          kw["n_chunks"], list_cap=list_cap)

            def run_p():
                return strip.spmsv_strip_dcsc_chunk_plain(
                    *a, kw["n"], kw["k"], kw["n_chunks"])
        want = run_p()
        e, w = 0, None
        # kernel 3 on every call with each walk forced as well: a
        # threshold of every id and of none
        for lc in ((None, part.n, 0) if kname == "spmsv_strip_min"
                   else (None,)):
            got = run_k(lc)
            e = max(e, max_err(got[0], want[0]),
                    abs(int(got[1]) - int(want[1])))
            check(int(got[2]) == strip.chunk_walk(
                words, cap if lc is None else lc),
                f"{label}: walk {int(got[2])} is not the threshold's")
            if lc is None:
                w = int(got[2])
        if row is not None:
            walks[kname][w] += 1
        rows_, cols_, total = strip.gather_segments_plain(jc, cp, ridx,
                                                          live, nr)

        def run_lib():
            torch.full((jc.shape[0] * nr,), INT_INF, dtype=torch.int32,
                       device=dev).scatter_reduce_(0, rows_, cols_, "amin")
        k_ms = device_ms(run_k)
        p_ms = cuda_ms(run_p, reps=1)
        lib_ms = cuda_ms(run_lib, reps=5)
        nbytes = strip_bytes(nzc, jc.shape[1], live, total, words.numel(),
                             n_front, nr)
        if row is not None:
            row["library_ms"] += lib_ms
        forced = " (each walk forced too)" if kname == "spmsv_strip_min" \
            else ""
        print(f"  {label}: {n_front} frontier vertices, {int(live.sum())} "
              f"live columns, {total} edges, {walk_name[w]} walk{forced}"
              f": max |kernel - plain| = {e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{nbytes / HBM_BW * 1e3:.5f} ms ({nbytes} bytes)")
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
                d_ms = device_ms(lambda: codec_ops.launch_encode(*a))
                # the floor: a zero-fill of the same (p, 1 + W) words
                words = torch.empty(off.shape[0] * (1 + codec_packed_words(
                    off.shape[1], codec_bits(chunk))), dtype=torch.int32,
                    device=dev)
                f_ms = device_ms(words.zero_)
                p_ms = cuda_ms(lambda: codec_ref.encode_offsets(*a), reps=1)
                nbytes = encode_bytes(count, off.shape[1], got.numel())
                row["device_ms"] += d_ms
                row["floor_ms"] += f_ms
                print(f"  {label}: {off.shape[0]} buckets of {off.shape[1]} "
                      f"slots, {int(count.sum())} ids: max |kernel - plain| "
                      f"= {e}; kernel {k_ms:.4f} ms ({d_ms:.5f} on the card "
                      f"alone; the zero-fill of its {words.numel()} words "
                      f"{f_ms:.5f}), plain {p_ms:.4f} ms, bound "
                      f"{nbytes / HBM_BW * 1e3:.5f} ms ({nbytes} "
                      f"bytes)")
                del words
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
                      f"{nbytes / HBM_BW * 1e3:.5f} ms ({nbytes} "
                      f"bytes)")
            else:
                rp, ci, fw, cv, ne = a
                if big_fw is None:
                    big_fw = fw
                got = bu_ops.launch_strips(*a)
                want = bu_ops.bottomup_substep_strips_plain(*a)
                e = max_err(got, want)
                del got, want
                k_ms = device_ms(lambda: bu_ops.launch_strips(*a))
                p_ms = cuda_ms(lambda: bu_ops.bottomup_substep_strips_plain(
                    *a), reps=1)
                # bottomup_bytes strip by strip, the frontier read once,
                # plus the p edge counts
                nbytes, n_live, read = 4 * ne.numel(), 0, 0
                for j in range(rp.shape[0]):
                    b, lv, rd = bottomup_bytes(rp[j], ci[j], fw, cv[j])
                    nbytes += b - (4 * fw.numel() if j else 0)
                    n_live, read = n_live + lv, read + rd
                b_ms = nbytes / HBM_BW * 1e3
                print(f"  {label} (all {rp.shape[0]} strips, one launch): "
                      f"{n_live} live rows, {read} edges read to the first "
                      f"hit: max |kernel - plain| = {e}; kernel {k_ms:.4f} "
                      f"ms on the card alone ({k_ms / b_ms:.2f}x its bound), "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms")
            errs[kname] = max(errs[kname], e)
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bound_ms"] += nbytes / HBM_BW * 1e3
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
    for kname, ws in walks.items():
        print(f"walks of the recorded {kname} calls, as the kernel "
              f"reported them: {ws[strip.WALK_FRONTIER]} frontier, "
              f"{ws[strip.WALK_COLUMNS]} columns")
    record["strip_walks_phase9"] = {
        k: {walk_name[w]: n for w, n in ws.items()} for k, ws in walks.items()}
    # both walks of each strip kernel ran on the path's calls: kernel 4
    # on phase 8's searches, kernel 3 on phase 8's or on phase 9's
    # unforced calls
    seen = {k: {w for ws in by_kind.values() for w in ws}
            for k, by_kind in walks_8.items()}
    seen["spmsv_strip_min"] |= {w for w, n in walks["spmsv_strip_min"].items()
                                if n}
    for k, ws in seen.items():
        check(ws == {strip.WALK_FRONTIER, strip.WALK_COLUMNS},
              f"a walk of {k} was not taken on the 1ds path's calls")
    # the synthetic cases at the path's widths (16 strips of 2^20 rows):
    # kernel 2's stacked launch on rows of 0-1,100 edges, a cut row,
    # completed rows and a last-word frontier; kernel 4 on an empty
    # strip, a 10^4-edge column, sub-range ends, the last word and the
    # empty frontier, each step with its own threshold and both walks
    # forced (a threshold of 0 ids and of every id)
    for name, a in edge_cases.bottomup_cases(part.p, part.chunk, device=dev,
                                             gap=256).items():
        got = bu_ops.launch_strips(*a)
        want = bu_ops.bottomup_substep_strips_plain(*a)
        e = max_err(got, want)
        errs["bottomup_substep"] = max(errs["bottomup_substep"], e)
        print(f"bottomup_substep case {name:>9}, {part.p} strips: "
              f"{int((want != INT_INF).sum())} parents found, max |kernel "
              f"- plain| = {e}")
        del got, want, a
    sg, hub, empty = edge_cases.strip_graph(part.p, part.chunk, device=dev,
                                            edge_factor=1)
    c = STRIP_CHUNKS[-1]
    for name, fw in edge_cases.strip_frontiers(part.p, part.chunk, hub,
                                               device=dev).items():
        args = (sg.jc, sg.cp, sg.nzc, sg.row_idx, fw, nr)
        want = strip.spmsv_strip_dcsc_plain(*args)
        e_case, seen = 0, set()
        for cap in (None, 0, part.n):
            got = strip.launch(*args, list_cap=cap)
            e_case = max(e_case, max_err(got[0], want[0]),
                         abs(int(got[1]) - int(want[1])))
            seen.add(walk_name[int(got[2])])
        errs["spmsv_strip_min"] = max(errs["spmsv_strip_min"], e_case)
        print(f"spmsv_strip_min case {name:>14} (strip {empty} empty, a "
              f"{edge_cases.HUB_EDGES}-edge column): walks {sorted(seen)}, "
              f"max |kernel - plain| = {e_case}")
        e_case, seen = 0, set()
        for k in range(c):
            sub = fw.reshape(part.p, c, -1)[:, k].reshape(-1).contiguous()
            args = (sg.jc, sg.cp, sg.nzc, sg.row_idx, sub, nr)
            want = strip.spmsv_strip_dcsc_chunk_plain(*args, part.n, k, c)
            for cap in (None, 0, part.n // c):
                got = strip.launch_chunk(*args, part.n, k, c, list_cap=cap)
                e_case = max(e_case, max_err(got[0], want[0]),
                             abs(int(got[1]) - int(want[1])))
                seen.add(walk_name[int(got[2])])
        errs["spmsv_strip_chunk_min"] = max(errs["spmsv_strip_chunk_min"],
                                            e_case)
        print(f"spmsv_strip_chunk_min case {name:>14}, {c} steps (strip "
              f"{empty} empty, a {edge_cases.HUB_EDGES}-edge column): walks "
              f"{sorted(seen)}, max |kernel - plain| = {e_case}")
    del sg
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
                         if k.startswith("spmsv") else "")
                      + (f"; on the card alone {r['device_ms']:.5f} ms, the "
                         f"zero-fill of its words {r['floor_ms']:.5f} ms"
                         if k == "codec_encode" else ""))
    print(encode_sass_line(record["encode_sass"]))
    for k in ("spmsv_strip_min", "codec_encode", "codec_decode"):
        per[k] = per_1ds[STRIP_CHUNKS[0]][k]
    per["spmsv_strip_chunk_min"] = per_1ds[STRIP_CHUNKS[-1]][
        "spmsv_strip_chunk_min"]
    record["kernel_times_1ds"] = per_1ds

    # --------------------------------------------------------------- 9b
    phase("9b kernel 1 over the strip col_ptr on the frontiers of one "
          "bfs-rmat-1d search against its plain version and kernel 3 (the "
          "strip DCSC) on the same frontiers (tolerance 0), each entry "
          "timed whole; the search's kernel-1 calls under sync debug mode "
          "'error'")
    with recording([(sp_ops, "spmsv_min", "spmsv_strips_csr_min")]
                   ) as calls, no_host_reads(sp_ops, "spmsv_min") as guarded:
        eng_1d_csr.search(roots[0])
    torch.cuda.synchronize()
    del eng_1d_csr
    check(len(guarded) > 0, "no kernel-1 call in the bfs-rmat-1d search")
    print(f"one bfs-rmat-1d search: its {len(guarded)} kernel-1 calls ran "
          f"under torch.cuda.set_sync_debug_mode('error'): no host read")

    def dcsc_beside(seg, words, nr, coff):
        """Kernel 3 on the same frontier: equal, and on the card alone."""
        e = max_err(sp_ops.launch(seg, words, nr)[0],
                    strip.launch(jc, cp, nzc, seg.row_idx, words, nr)[0])
        return [("dcsc_ms", device_ms(lambda: strip.launch(
            jc, cp, nzc, seg.row_idx, words, nr)), e)]
    row = kernel1_rows(sp_ops, calls, "spmsv_strips_csr_min", dcsc_beside)
    errs["spmsv_strips_csr_min"] = max(errs["spmsv_strips_csr_min"],
                                       row["max_abs_err"])
    per["spmsv_strips_csr_min"] = row
    del calls

    # --------------------------------------------------------------- 10
    phase("10 profile of one 1ds search per expand_chunks, instrumented "
          "and not")
    record["profile_1ds"] = {}
    for c in STRIP_CHUNKS:
        for key, label in (("engine", ""), ("fast_engine", "fast ")):
            print(f"-- expand_chunks={c}, {label or 'instrumented '}"
                  f"root {roots[0]}")
            eng = runs[c][key]
            record["profile_1ds"][f"{label}{c}"] = profile_call(
                lambda: eng.search(roots[0]))
    # phase 8g builds the strips again from the stream; the two graphs do
    # not fit together, so phase 8's is kept as digests of the fields both
    # carry (phase 8's has no edge lists, the born one no col_ptr)
    born_ref.update(
        digests={k: digest(v) for k, v in graph.device_arrays().items()
                 if k != "col_ptr"},
        **{c: getattr(graph, c) for c in ("m", "m_input", "cap", "cap_nzc",
                                          "maxdeg_col")})
    return (launches, launches_1ds, launches_fast, launches_new, errs, per,
            ro > rb, born_ref)


def born_strips(dev, kernels, ref, launches_new) -> dict:
    """Phase 8g: the born 16-strip build at scale 24 against phase 8's
    host-built strips (their digests and scalars in ``ref``), its 1ds
    dcsc C=1 session on phase 8's roots, and a squeezed ``route_slack``
    that must heal.  Its launches join ``launches_new``."""
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.engine import plan_bfs
    from repro_torch.graph.dist_build import BuildSpec, dist_build
    from repro_torch.launch.mesh import make_local_mesh_1d
    from repro_torch.runtime.faultinject import undersize_route_slack

    spec = BuildSpec(SCALE, EDGE_FACTOR, SEED)
    mesh = make_local_mesh_1d(STRIPS, device=dev)

    def build(tag, **kw):
        """The born strips, each kernel-7 launch a slice, checked against
        phase 8's scalars and digests; (graph, info, launches, peak)."""
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g, info = dist_build(spec, "1ds", mesh, STRIPS, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = kernels["rmat_counter"].launches
        check(n >= STRIPS, f"8g {tag}: {n} counter launches")
        launches_new["rmat_counter"] = launches_new.get("rmat_counter",
                                                        0) + n
        for c in ("m", "m_input", "cap", "cap_nzc", "maxdeg_col"):
            check(getattr(g, c) == ref[c], f"8g {tag}: {c} {getattr(g, c)} "
                                           f"against phase 8's {ref[c]}")
        arrays = g.device_arrays()
        for k, d in ref["digests"].items():
            check(digest(arrays[k]) == d, f"8g {tag}: field {k} differs "
                                          f"from phase 8's")
        return g, info, n, peak

    g, info, n_gen, peak = build("route_slack 1.5")
    print(f"born strips: m={g.m} cap={g.cap} cap_nzc={g.cap_nzc} maxdeg_col="
          f"{g.maxdeg_col} and the {len(ref['digests'])} fields both graphs "
          f"carry ({', '.join(ref['digests'])}) equal phase 8's digests; "
          f"dist_build {info['build_s']:.3f} s (generate and route "
          f"{info['gen_route_s']:.3f} s, {n_gen} counter launches; dedup and "
          f"formats {info['format_s']:.3f} s); cap_route {info['cap_route']};"
          f" route words measured {info['route_words_measured']} against "
          f"build_route_1d_words {info['route_words_expected']} and the "
          f"padded exchange's route_words_padded "
          f"{info['route_words_padded']}; peak device memory {peak:.3f} GiB "
          f"(limit 75); {smi_line()}")
    check(peak < 75.0, f"8g peak {peak:.2f} GiB >= 75 GiB")
    eng = plan_bfs(g, BFSConfig(decomposition="1ds", storage="dcsc",
                                frontier_codec="packed"), mesh,
                   local_mode="kernel").compile()
    path = ("spmsv_strip_min", "bottomup_substep", "codec_encode",
            "codec_decode")
    for k in kernels.values():
        k.launches = 0
    for r, lv, par in zip(ref["roots"], ref["levels"], ref["parents"]):
        out = eng.search(r)
        check(out[1] == lv and torch.equal(
            out[0].reshape(-1)[: par.numel()].cpu(), par),
            f"8g root {r}: the born strips' parents or levels differ from "
            f"phase 8's")
    lb = {k: kernels[k].launches for k in path}
    for k, nl in lb.items():
        check(nl > 0, f"kernel {k} was never launched on the born strips")
        launches_new[k] = launches_new.get(k, 0) + nl
    print(f"1ds dcsc C=1 kernel session over the born strips: parents and "
          f"levels equal phase 8's on all {len(ref['roots'])} roots; "
          f"launches {lb}")
    rec = {"build_s": info["build_s"], "gen_route_s": info["gen_route_s"],
           "format_s": info["format_s"], "peak_gib": peak,
           "launches": {"rmat_counter": n_gen, **lb},
           **{k: info[k] for k in ("cap_route", "route_words_measured",
                                   "route_words_expected",
                                   "route_words_padded")}}
    del eng, g, out
    torch.cuda.empty_cache()
    slack = undersize_route_slack(0)
    g, info, n_gen, peak = build(f"route_slack {slack}", route_slack=slack)
    log = info["retry_log"]
    check(len(log) > 1 and log[-1]["outcome"] == "ok",
          f"8g: route_slack {slack} did not overflow and heal: {log}")
    for a in log:
        print(f"attempt {a['attempt']}: route_slack={a['cap_value']} -> "
              f"{a['outcome']} {a['detail'].get('error', '')}")
    print(f"route_slack {slack} (undersize_route_slack(0)) healed in "
          f"{len(log)} attempts of at most 3, {info['build_s']:.3f} s for the "
          f"last; the same digests; {n_gen} counter launches; peak "
          f"{peak:.3f} GiB")
    rec["heal"] = {"route_slack0": slack, "retry_log": log,
                   "launches": n_gen, "peak_gib": peak}
    del g
    torch.cuda.empty_cache()
    return rec


def store_phase(dev, kernels, launches_new) -> dict:
    """Phase 10c: a born scale-STORE_SCALE graph on a simulated 2x2 grid
    through the store on the card: saved, loaded into a kernel session
    (``plan_bfs_from_store(...).compile(store=)``) whose parents equal
    the born graph's on 16 roots, then a flipped and a truncated shard,
    each quarantined and regenerated on the card to the stored CRC; the
    bytes on disk and the save, load and regeneration seconds.  The
    store lives under ``build/`` and is removed at the end.  Then
    ``run_fault_matrix`` on the card at its defaults on 1 and 4
    simulated devices, all 22 cases ok.  The counter launches join
    ``launches_new``."""
    import shutil
    import tempfile

    from repro_torch.ckpt.graph_store import (GraphStore, plan_bfs_from_store,
                                              shard_crc32)
    from repro_torch.configs.base import BFSConfig
    from repro_torch.core.engine import plan_bfs
    from repro_torch.graph.dist_build import BuildSpec, dist_build, regen_shard
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.faultinject import corrupt_shard, run_fault_matrix

    gen = kernels["rmat_counter"]
    gen.launches = 0
    spec = BuildSpec(STORE_SCALE, EDGE_FACTOR, SEED)
    mesh = make_local_mesh(2, 2, device=dev)
    g, info = dist_build(spec, "2d", mesh, (2, 2))
    rng = np.random.default_rng(0)
    deg = np.flatnonzero(g.deg_A.reshape(-1).cpu().numpy() > 0)
    roots = [int(rng.choice(deg)) for _ in range(N_ROOTS)]
    eng = plan_bfs(g, BFSConfig(), mesh, local_mode="kernel").compile()
    want = [eng.search(r)[0].cpu() for r in roots]
    del eng
    rec = {"build_s": info["build_s"], "cap": g.cap, "cap_seg": g.cap_seg}
    name = f"g500-s{STORE_SCALE}-2d"
    (ROOT / "build").mkdir(exist_ok=True)
    root_dir = tempfile.mkdtemp(prefix="graph_store_", dir=ROOT / "build")
    try:
        store = GraphStore(root_dir, device=dev)
        ts = time.perf_counter()
        sdir = Path(store.save_graph(name, g, spec=spec))
        rec["save_s"] = time.perf_counter() - ts
        rec["bytes"] = sum(f.stat().st_size for f in sdir.glob("*.npz"))
        meta = json.loads((sdir / "meta.json").read_text())
        torch.cuda.synchronize()
        ts = time.perf_counter()
        plan = plan_bfs_from_store(store, name, BFSConfig(), mesh,
                                   expect_spec=spec, local_mode="kernel")
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - ts
        eng = plan.compile(store=store)
        check(not eng.exec_from_store and eng.exec_load_s == 0.0,
              "10c: a session came from the store")
        for r, par in zip(roots, want):
            check(torch.equal(eng.search(r)[0].cpu(), par),
                  f"10c root {r}: the stored graph's parents differ from "
                  f"the born graph's")
        del eng, plan
        print(f"born scale-{STORE_SCALE} 2x2 graph (m={g.m}, cap={g.cap}, "
              f"cap_seg={g.cap_seg}) in {info['build_s']:.3f} s; saved as "
              f"{meta['shards']} shards, {rec['bytes']} bytes of npz, in "
              f"{rec['save_s']:.3f} s; loaded onto the mesh in "
              f"{rec['load_s']:.3f} s (every shard's CRC checked); its "
              f"kernel session's parents equal the born graph's on "
              f"{N_ROOTS} roots; exec_from_store False")
        rec["repairs"] = []
        for mode in ("flip", "truncate"):
            path = corrupt_shard(store, name, 0, mode=mode)
            k = int(Path(path).name[6:11])
            torch.cuda.synchronize()
            ts = time.perf_counter()
            loaded = store.load_graph(name, mesh=mesh, expect_spec=spec)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - ts
            report = store.last_load_report
            check([x["shard"] for x in report["repaired"]] == [k]
                  and Path(path + ".quarantined").exists(),
                  f"10c {mode}: {report}")
            same_graph(loaded, g, f"10c {mode}")
            del loaded
            with np.load(path) as z:
                crc = shard_crc32(dict(z))
            check(crc == meta["shard_crc32"][k],
                  f"10c {mode}: the repaired shard's CRC {crc:#010x}")
            ts = time.perf_counter()
            again = regen_shard(spec, meta["graph_kind"], g.part, k,
                                json.loads(meta["scalars"]),
                                json.loads(meta["fields"]), device=dev)
            regen_s = time.perf_counter() - ts
            check(shard_crc32(again) == crc, f"10c {mode}: regeneration")
            print(f"{mode}: shard {k} quarantined and regenerated on the "
                  f"card to the stored CRC {crc:#010x}; last_load_report "
                  f"{report}; the repairing load {load_s:.3f} s, the "
                  f"regeneration alone {regen_s:.3f} s")
            rec["repairs"].append({"mode": mode, "shard": k,
                                   "load_s": load_s, "regen_s": regen_s,
                                   "report": report})
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)
    del g
    torch.cuda.empty_cache()
    rec["launches"] = gen.launches
    launches_new["rmat_counter"] = launches_new.get("rmat_counter",
                                                    0) + gen.launches
    rec["fault_matrix"] = {}
    for devices in (1, 4):
        gen.launches = 0
        ts = time.perf_counter()
        rep = run_fault_matrix(devices=devices, device=dev)
        wall = time.perf_counter() - ts
        bad = [c for c in rep["cases"] if not c["ok"]]
        check(rep["ok"] and len(rep["cases"]) == 22 and not bad,
              f"10c fault matrix on {devices} devices: {bad}")
        launches_new["rmat_counter"] += gen.launches
        print(f"run_fault_matrix(devices={devices}) on the card: "
              f"{len(rep['cases'])}/22 cases ok in {wall:.3f} s "
              f"({gen.launches} counter launches)")
        rec["fault_matrix"][devices] = {"wall_s": wall, "cases": [
            (c["name"], c["ok"]) for c in rep["cases"]]}
    print(f"device memory {torch.cuda.memory_allocated() / 2**30:.3f} GiB; "
          f"{smi_line()}")
    return rec


# the drivers as users start them: (label, module, arguments, the line
# that must come out); then graph500_bfs --born --store, twice each
DRIVERS = [
    ("graph500_bfs 2d", "graph500_bfs",
     ["--scale", "20", "--roots", "16", "--local-mode", "kernel"],
     "harmonic-mean TEPS over 16 roots"),
    ("graph500_bfs 2d --fast", "graph500_bfs",
     ["--scale", "20", "--roots", "16", "--local-mode", "kernel", "--fast"],
     "harmonic-mean TEPS over 16 roots"),
    ("graph500_bfs 1ds 16x1 dcsc", "graph500_bfs",
     ["--scale", "20", "--roots", "16", "--local-mode", "kernel",
      "--decomposition", "1ds", "--grid", "16x1", "--storage", "dcsc"],
     "harmonic-mean TEPS over 16 roots"),
    ("quickstart", "quickstart", [], "valid tree: True"),
    ("serve_lm", "serve_lm", [], "served 6 requests")]
BORN = [("2d 1x1", []),
        ("1ds 16x1 dcsc", ["--decomposition", "1ds", "--grid", "16x1",
                           "--storage", "dcsc"])]


DRIVER_LANES = 4     # driver processes on the card at once (8 host cores)


def run_lanes(chains, lanes: int = DRIVER_LANES) -> list:
    """Run each chain of commands in its order, the chains side by side
    in ``lanes`` threads, each command a process of its own on the card
    (``PYTHONPATH`` the checkout's ``src``, at most 600 s): for each
    chain, in the chains' order, its ``(CompletedProcess, wall seconds)``
    pairs.  Every process has ended when it returns."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run_chain(chain):
        out = []
        for cmd in chain:
            ts = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            out.append((r, time.perf_counter() - ts))
        return out
    gc.collect()
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(lanes) as ex:
        return list(ex.map(run_chain, chains))


def run_drivers() -> dict:
    """Phase 10b: each driver of ``repro_torch.examples`` in a process of
    its own, as ``python -m repro_torch.examples.<name>`` (on the card by
    default); each must exit 0 and print its TEPS or served line.  The
    kernels it needs are already built (``build/``).  Then
    ``graph500_bfs --scale 20 --born --store DIR --local-mode kernel``
    twice in each layout of ``BORN``: the first run prints its born build
    and its store save, the second its store load; every run's roots and
    level counts are the same.  Each layout's store lives under
    ``build/`` and is removed at the end.  The drivers run
    ``DRIVER_LANES`` at a time (a layout's two runs in turn), so their
    walls and TEPS are those of a shared card."""
    import re
    import shutil
    import tempfile

    def cmd(module, args):
        return [sys.executable, "-m", f"repro_torch.examples.{module}",
                *args]

    rec = {}
    (ROOT / "build").mkdir(exist_ok=True)
    stores = [tempfile.mkdtemp(prefix="driver_store_", dir=ROOT / "build")
              for _ in BORN]
    born = []
    for (layout, extra), store in zip(BORN, stores):
        args = ["--scale", "20", "--roots", "16", "--local-mode", "kernel",
                "--born", "--store", store, *extra]
        born.append([cmd("graph500_bfs", args)] * 2)
    ts = time.perf_counter()
    try:
        results = run_lanes(born + [[cmd(module, args)]
                                    for _, module, args, _ in DRIVERS])
    finally:
        for store in stores:
            shutil.rmtree(store, ignore_errors=True)
    print(f"{len(DRIVERS) + 2 * len(BORN)} driver runs, {DRIVER_LANES} at a "
          f"time: {time.perf_counter() - ts:.1f} s")
    for (label, module, args, want), [(r, wall)] in zip(
            DRIVERS, results[len(BORN):]):
        check(r.returncode == 0, f"{label} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        lines = r.stdout.splitlines()
        hit = [x for x in lines if want in x]
        check(bool(hit), f"{label} printed no '{want}' line")
        print(f"-- {label} (python -m repro_torch.examples.{module} "
              f"{' '.join(args)}): exit 0 in {wall:.1f} s")
        for x in lines:
            if x.startswith(("compile", "root ", "useful", "BFS from",
                             "R-MAT")) or want in x:
                print(f"   {x}")
        rec[label] = {"wall_s": wall, "line": hit[0],
                      "stdout": r.stdout[-20000:]}
    levels = re.compile(r"^root\s+(\d+): (\d+) levels")
    trees = []
    for (layout, _), runs in zip(BORN, results):
        for first, (r, wall) in zip((True, False), runs):
            label = (f"graph500_bfs {layout} --born --store "
                     f"({'build and save' if first else 'load'})")
            check(r.returncode == 0, f"{label} exited {r.returncode}:\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
            out = r.stdout
            for line, want in (("born-sharded build", first),
                               ("store save", first),
                               ("store load", not first)):
                check((line in out) == want,
                      f"{label}: '{line}' printed {line in out}")
            roots = [m.groups() for m in map(levels.match,
                                             out.splitlines()) if m]
            check(len(roots) == 16, f"{label}: {len(roots)} root lines")
            trees.append(roots)
            print(f"-- {label}: exit 0 in {wall:.1f} s")
            for x in out.splitlines():
                if x.startswith(("born-sharded", "store ", "compile",
                                 "harmonic")):
                    print(f"   {x}")
            rec[label] = {"wall_s": wall, "stdout": out[-20000:]}
    check(all(t == trees[0] for t in trees),
          "the born drivers' roots or level counts differ between runs")
    print(f"the {len(trees)} born runs drew the same 16 roots with the same "
          f"level counts: {[int(lv) for _, lv in trees[0]]}")
    return rec


def kernel_times(tree: Path) -> int:
    """Kernels 1-9 and the 2D level epilogue (k10) of the checkout at
    ``tree`` on the card alone, at their real calls or shapes.  Kernel 1's entry as the level steps call it
    (``spmsv_min``, or a tree from before it the three public names, each
    with its prep), on the card alone and host-timed, on one 2D csr,
    bfs-rmat, bfs-rmat-pipe (the split ring) and bfs-rmat-1d search (and
    bfs-rmat-1d-dcsc's for the reads), each search's synchronizing calls
    counted and each timed whole, and the 2D csr
    session's median search ms over the 16 roots of phase 3.  Kernels 2,
    3, 4, 5 and 6 at the scale-24 paths' calls, from the first root: one
    2D search (grid 1x1), one 1ds search on 16 strips per expand_chunks
    (1 and 4) and one 1ds search top-down only per expand_chunks (the
    paper's 1D baseline, where kernels 3 and 4 take their column walks);
    the level epilogue's calls of one more search (``epilogue_times``).
    Each recorded call is launched again through its public wrapper and
    timed with ``device_ms``, and kernels 5 and 6 also host-timed
    (``cuda_ms``, the public entry's host call included), kernel 5 beside
    the zero-fill of its p * (1 + W) words and kernel 6 beside ``fill_``
    of its p * cap ids (the floor of writing them alone); the sums are
    per search.  Kernel 5's static SASS over the words a thread writes
    (``encode_sass``).  Each search is also timed whole on the host
    clock (median of 5).  Kernel 7: the full scale-24 stream, on the card
    alone and host-timed.  Kernel 8 at the AutoInt path's three shapes
    (bags of one into the registered 11,238,400 x 16 float32 table): on
    the card alone, and host-timed through its public entry beside
    ``F.embedding`` on the same rows.  Kernel 9 on the card alone at dh 64, 80 and 128 on each
    path's shape of ``K9_DIM_SHAPES``.  Prints the card's name and power
    limit, then one JSON line."""
    # ahead of this checkout's src, so that ``tree``'s port is imported
    sys.path.insert(0, str(tree.resolve() / "src"))
    import warnings

    from repro_torch.configs.base import BFSConfig, get_config
    from repro_torch.core.comm_model import codec_bits, codec_packed_words
    from repro_torch.core.engine import plan_bfs
    from repro_torch.graph import rmat
    from repro_torch.graph.formats import build_blocked, build_blocked_1d
    from repro_torch.kernels import build
    from repro_torch.kernels.bottomup import ops as bu
    from repro_torch.kernels.frontier_codec import ops as codec
    from repro_torch.kernels.spmsv import ops as sp
    from repro_torch.kernels.spmsv import strip
    from repro_torch.launch.mesh import make_local_mesh, make_local_mesh_1d
    try:                 # the 2D level epilogue; a tree from before it lacks it
        from repro_torch.kernels.epilogue import ops as ep
    except ImportError:
        ep = None
    dev = torch.device("cuda")
    out = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
           "smi": smi_line()}
    # kernel 2's public entries; a tree from before the stacked entry
    # launches the single-segment one once per strip
    k2_targets = [(bu, nm, nm) for nm in ("bottomup_substep",
                                          "bottomup_substep_strips")
                  if hasattr(bu, nm)]
    strip_targets = [(strip, "spmsv_strip_dcsc", "k3"),
                     (strip, "spmsv_strip_dcsc_chunk", "k4"),
                     (codec, "encode_offsets", "k5"),
                     (codec, "decode_buckets", "k6")]
    # kernel 1's entry as the level steps call it: the folded body, or a
    # tree from before it the three public names, each with its prep
    k1_targets = [(sp, nm, nm) for nm in (
        ("spmsv_min",) if hasattr(sp, "spmsv_min") else
        ("spmsv_csr_min", "spmsv_dcsc_min", "spmsv_strips_csr_min"))]

    def syncs_of(eng, root) -> tuple:
        """(synchronizing calls, top-down levels) of one search: the
        warnings of sync debug mode "warn", each a host read or a wait on
        the card, and the levels whose mode is top-down."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out_ = eng.search(root)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        modes_ = out_[3][:out_[1], 2]
        return (sum("synchroniz" in str(w.message) for w in caught),
                int((modes_ == 0).sum()))

    def timed_search(eng, root):
        with recording(k1_targets + k2_targets + strip_targets) as calls:
            eng.search(root)
        torch.cuda.synchronize()
        fns = {"k3": strip.spmsv_strip_dcsc,
               "k4": strip.spmsv_strip_dcsc_chunk,
               "k5": codec.encode_offsets, "k6": codec.decode_buckets}
        fns.update({nm: getattr(sp, nm) for _, nm, _ in k1_targets})
        t = {"k1": [], "k2": [], "k3": [], "k4": [], "k5": [], "k6": []}
        host = {"k1": [], "k5": [], "k6": []}
        ids = {"k3": [], "k4": []}
        fill, fill5 = [], []
        for nm, a, kw in calls:
            fn = fns.get(nm) or getattr(bu, nm)
            if nm.startswith("spmsv_"):
                t["k1"].append(device_ms(lambda: fn(*a, **kw)))
                host["k1"].append(cuda_ms(lambda: fn(*a, **kw)))
                continue
            t[nm if nm in fns else "k2"].append(
                device_ms(lambda: fn(*a, **kw)))
            if nm in host:
                host[nm].append(cuda_ms(lambda: fn(*a, **kw), reps=100))
            if nm in ids:
                ids[nm].append(strip.popcount(a[4]))
            if nm == "k6":
                # the floor of a decode: its p * cap ids written alone
                ids_out = torch.empty(a[4] * a[2], dtype=torch.int32,
                                      device=dev)
                fill.append(device_ms(lambda: ids_out.fill_(a[3])))
            if nm == "k5":
                # the floor of an encode: its (p, 1 + W) words zeroed
                words = torch.empty(a[0].shape[0] * (1 + codec_packed_words(
                    a[0].shape[1], codec_bits(a[2]))), dtype=torch.int32,
                    device=dev)
                fill5.append(device_ms(words.zero_))
        del calls
        # the 2D level epilogue's calls of one more search, their inputs
        # cloned (the kernel writes pi), each launched again
        k10 = []
        if ep is not None:
            with recording([(ep, "launch", "k10")],
                           clone=True) as ep_calls:
                eng.search(root)
            torch.cuda.synchronize()
            k10 = [epilogue_times(ep, a, kw) for _, a, kw in ep_calls]
            del ep_calls
        wall = []
        for _ in range(5):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            eng.search(root)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - ts) * 1e3)
        res = {"search_ms": float(np.median(wall))}
        res["syncs"], res["td_levels"] = syncs_of(eng, root)
        for k, ts_ in t.items():
            res[k] = {"launches": len(ts_), "ms": sum(ts_)}
        for k in t:
            res[k]["per_launch_ms"] = t[k]
        for k in ids:
            res[k]["ids"] = ids[k]
        for k in host:
            res[k]["host_ms"] = sum(host[k])
            res[k]["per_launch_host_ms"] = host[k]
        res["k6"]["per_launch_fill_ms"] = fill
        res["k5"]["per_launch_fill_ms"] = fill5
        res["k10"] = {"launches": len(k10),
                      **{k: sum(t_[k] for t_ in k10)
                         for k in ("ms", "plain_ms", "bound_ms")},
                      "per_launch_ms": [t_["ms"] for t_ in k10],
                      "max_abs_err": max([t_["err"] for t_ in k10],
                                         default=0)}
        return res

    out["k5_sass"] = encode_sass(
        build.build_libraries(["codec_encode"])["codec_encode"], codec)
    print(encode_sass_line(out["k5_sass"]))

    def k7():
        return rmat.rmat_edges_counter(SCALE, EDGE_FACTOR, seed=SEED,
                                       device=dev)
    out["k7"] = {"edges": EDGE_FACTOR << SCALE,
                 "device_ms": device_ms(k7, reps=5),
                 "host_ms": cuda_ms(k7, reps=5)}
    torch.cuda.empty_cache()

    edges = rmat.rmat_graph(SCALE, EDGE_FACTOR, seed=SEED,
                            generator="counter", device=dev)
    rng = np.random.default_rng(0)
    roots = [rmat.random_source(edges, rng) for _ in range(N_ROOTS)]
    root = roots[0]
    graph = build_blocked(edges, 1, 1)
    mesh = make_local_mesh(1, 1, device=dev)
    eng = plan_bfs(graph, BFSConfig(), mesh, local_mode="kernel").compile()
    out["2d"] = timed_search(eng, root)
    # g500-s24-1x1's searches as phase 3 runs them: each root twice, the
    # median of each root's two, then the median over the roots
    per_root = {r: [] for r in roots}
    for _ in range(2):
        for r in roots:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            eng.search(r)
            torch.cuda.synchronize()
            per_root[r].append((time.perf_counter() - ts) * 1e3)
    out["2d"]["roots_search_ms"] = float(np.median(
        [np.median(v) for v in per_root.values()]))
    del eng
    eng = plan_bfs(graph, get_config("bfs-rmat"), mesh,
                   local_mode="kernel").compile()
    out["2d_bfs_rmat"] = timed_search(eng, root)
    del eng
    # the R/G split ring (expand_chunks 2) of the same grid
    eng = plan_bfs(graph, get_config("bfs-rmat-pipe"), mesh,
                   local_mode="kernel").compile()
    out["2d_bfs_rmat_pipe"] = timed_search(eng, root)
    del eng, graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    graph = build_blocked_1d(edges, STRIPS, with_edge_lists=False,
                             with_col_ptr=True)
    mesh = make_local_mesh_1d(STRIPS, device=dev)
    eng = plan_bfs(graph, get_config("bfs-rmat-1d"), mesh,
                   local_mode="kernel").compile()
    out["1d_bfs_rmat_1d"] = timed_search(eng, root)
    eng = plan_bfs(graph, get_config("bfs-rmat-1d-dcsc"), mesh,
                   local_mode="kernel").compile()
    out["1d_bfs_rmat_1d_dcsc"] = timed_search(eng, root)
    del eng
    for label, c, diro in (("1ds_c1", 1, True), ("1ds_c4", 4, True),
                           ("1ds_c1_topdown", 1, False),
                           ("1ds_c4_topdown", 4, False)):
        cfg = BFSConfig(decomposition="1ds", storage="dcsc",
                        frontier_codec="packed", expand_chunks=c,
                        direction_optimizing=diro)
        eng = plan_bfs(graph, cfg, mesh, local_mode="kernel").compile()
        out[label] = timed_search(eng, root)
        del eng
        torch.cuda.empty_cache()
    del graph, mesh, edges
    gc.collect()
    torch.cuda.empty_cache()
    out["k8"] = kernel8_times(dev)
    out["k9"] = kernel9_times(dev)
    print(out["smi"])
    print(json.dumps(out))
    return 0


def kernel8_times(dev) -> dict:
    """Kernel 8 of the imported port at the AutoInt path's shapes, bags
    of one: per shape, the card-alone time of a launch (``device_ms``,
    cycling through the batches) and the host-timed call of the public
    entry ``embedding_bag`` beside ``F.embedding`` (``cuda_ms``, both
    under inference_mode, in turns)."""
    import itertools

    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.models import embedding
    cfg = get_config("autoint")
    shp = {s.name: s for s in cfg.shapes}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tab = embedding.init_table(cfg, gen, dev)
    res = {}
    for label, n_batches, step0 in (("serve_p99", 64, 0),
                                    ("serve_bulk", 1, AI_P99),
                                    ("retrieval_cand", AI_QUERIES, 10_000)):
        rows = [embedding.flat_indices(cfg, torch.from_numpy(recsys_batch(
            cfg, shp[label].batch, step0 + i)["idx"]).to(dev))
            .reshape(-1, 1).to(torch.int32).contiguous()
            for i in range(n_batches)]
        longs = [r[:, 0].long() for r in rows]
        cyc = itertools.cycle(range(n_batches))
        with torch.inference_mode():
            kd = device_ms(lambda: eb_ops.embedding_bag(tab, rows[next(cyc)]))
            ld = device_ms(lambda: F.embedding(longs[next(cyc)], tab))
            host = {"kernel": [], "library": []}
            for _ in range(2):
                host["kernel"].append(cuda_ms(lambda: eb_ops.embedding_bag(
                    tab, rows[next(cyc)]), reps=100))
                host["library"].append(cuda_ms(lambda: F.embedding(
                    longs[next(cyc)], tab), reps=100))
        res[label] = {"bags": rows[0].shape[0], "device_ms": kd,
                      "device_library_ms": ld, "host_ms": host}
        del rows, longs
    return res


def kernel9_times(dev) -> dict:
    """Kernel 9 of the imported port on the card alone (``device_ms``) at
    dh 64, 80 and 128, 32 heads, on each path's shape of
    ``K9_DIM_SHAPES``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    res = {}
    for label, (b, sq, sk, q_off, dt), _ in K9_DIM_SHAPES:
        res[label] = {}
        for dh in (64, 80, 128):
            q = torch.randn(b, sq, 32, dh, generator=g, device=dev).to(dt)
            k, v = (torch.randn(b, sk, 32, dh, generator=g, device=dev)
                    .to(dt) for _ in range(2))
            res[label][str(dh)] = device_ms(
                lambda: fa_ops.launch(q, k, v, True, None, q_off))
    return res


# ------------------------------------------------------ the GNN side
# phase 21: the four GNN archs trained at the registered widths through
# launch.train's gnn_setup (kernel 7 making the large graphs on the
# card), the 2D SpMM on the ogb_products graph, and each arch's first
# step against the CPU path
GNN_STEPS = TRAIN_STEPS            # 20, checkpointed at TRAIN_RESUME_AT
GIN_PEAK_GIB = 72.0                # PERF.md section 2 (reckoned ~52 GB)
GNN_PEAK_GIB = 40.0                # the other three cells
GNN_FWD, GNN_GRAD = 1e-5, 1e-4     # 21e: the CPU tests' tolerances
K7_SLICE = 1 << 20                 # kernel 7's checked head and tail
SPMM_D = 64
SPMM_GRIDS = ((1, 1), (4, 4))
# (label, arch, shape): the cells of 21a-21c
GNN_CELLS = (("21a", "gin-tu", "ogb_products"),
             ("21b", "gat-cora", "full_graph_sm"),
             ("21b", "meshgraphnet", "minibatch_lg"),
             ("21c", "mace", "molecule"))
GNN_DRIVERS = [
    ("launch.train gin-tu", "repro_torch.launch.train",
     ["--arch", "gin-tu", "--steps", "20"], "gin-tu: 20 steps"),
    ("examples.gnn_full_graph", "repro_torch.examples.gnn_full_graph", [],
     "over 30 steps")]
TRAIN_DRIVERS += GNN_DRIVERS       # phase 18 runs them; --gnn at its end
# the profile's kernels by what they do (21a's step, PERF.md section 5)
GNN_KERNEL_GROUPS = (
    ("gather", ("gather_kernel", "indexSelect", "index_select")),
    ("segment-sum", ("index_put", "indexing_backward", "indexFunc",
                     "index_add", "RadixSort", "radix", "scatter")),
    ("GEMM", ("gemm", "xmma", "cutlass", "Kernel2", "gemv", "nvjet")))


@contextlib.contextmanager
def rmat_plain_tripwire():
    """Count calls of kernel 7's plain version while the block runs."""
    from repro_torch.graph import rmat
    calls = {"rmat_edges_counter_plain": 0}
    fn = rmat.rmat_edges_counter_plain

    def counted(*a, **kw):
        calls["rmat_edges_counter_plain"] += 1
        return fn(*a, **kw)
    rmat.rmat_edges_counter_plain = counted
    try:
        yield calls
    finally:
        rmat.rmat_edges_counter_plain = fn


def check_gnn_stream(shape, dev, senders, receivers) -> int:
    """Kernel 7's stream under ``_edges_for`` at ``shape``'s size: the
    kernel's head and tail slices against its plain version on the card
    (launches that compare, not counted), and the ids ``_edges_for``
    returns (folded into n_nodes and tiled to n_edges on the card)
    against the plain stream folded on the host, at both ends.  Returns
    the largest difference (0 when equal)."""
    from repro_torch.graph import datasets, rmat
    N, E = shape.n_nodes, shape.n_edges
    scale = max(int(np.ceil(np.log2(N))), 2)
    ef = max(1, E // (1 << scale))
    count = min(E, ef << scale)
    err = 0
    for start in (0, count - K7_SLICE):
        ks, kd = rmat.rmat_edges_counter(scale, ef, seed=0, start=start,
                                         count=K7_SLICE, device=dev)
        ps, pd = rmat.rmat_edges_counter_plain(scale, ef, seed=0,
                                               start=start, count=K7_SLICE,
                                               device=dev)
        err = max(err, max_err(ks, ps), max_err(kd, pd))
    # output position i holds stream edge i % count, folded on the host
    for lo in (0, E - K7_SLICE):
        pos = np.arange(lo, lo + K7_SLICE) % count
        first = int(pos[0])
        span = min(K7_SLICE, count - first)
        hs, hd = rmat.rmat_edges_counter_plain(scale, ef, seed=0,
                                               start=first, count=span)
        if span < K7_SLICE:
            ts, td = rmat.rmat_edges_counter_plain(
                scale, ef, seed=0, start=0, count=K7_SLICE - span)
            hs, hd = torch.cat([hs, ts]), torch.cat([hd, td])
        want_s = (hs.long() % N).to(torch.int32)
        want_d = (hd.long() % N).to(torch.int32)
        err = max(err, max_err(senders[lo:lo + K7_SLICE].cpu(), want_s),
                  max_err(receivers[lo:lo + K7_SLICE].cpu(), want_d))
    print(f"kernel 7 at {shape.name} (scale {scale}, edge factor {ef}, "
          f"{count:,} stream edges tiled to {E:,}): head and tail "
          f"{K7_SLICE}-edge slices against the plain version on the card, "
          f"and _edges_for's first and last {K7_SLICE} ids (folded into "
          f"{N:,} and tiled on the card) against the plain stream folded "
          f"on the host: max difference {err}")
    check(err == 0, f"kernel 7's {shape.name} stream differs from its plain "
                    f"version")
    check(scale > datasets._MAX_HOST_SCALE or ef > datasets._MAX_HOST_EF,
          f"{shape.name} takes the host stream, not kernel 7")
    return err


def gnn_atomic_step(built) -> dict:
    """What ordering the aggregation costs: one segment sum of 21a's
    (61.9 M, 64) messages into the receivers as the port runs it on the
    card (an accumulating ``index_put``, sorted by receiver; the same
    kernels with the deterministic mode on or off) beside the atomic
    ``index_add_``, each timed, and the two sums' largest gap."""
    from repro_torch.models import gnn as gnn_mod
    b = built[2](0)
    n, r = b["x"].shape[0], b["receivers"]
    gen = torch.Generator(r.device).manual_seed(1)
    msg = torch.randn(r.numel(), 64, generator=gen, device=r.device)
    sorted_ms = cuda_ms(lambda: gnn_mod._seg_sum_card(msg, r, n), reps=3)
    atomic_ms = cuda_ms(lambda: torch.zeros(n, 64, device=r.device)
                        .index_add_(0, r, msg), reps=3)
    gap = float((gnn_mod._seg_sum_card(msg, r, n) - torch.zeros(
        n, 64, device=r.device).index_add_(0, r, msg)).abs().max())
    print(f"  one segment sum of ({r.numel():,}, 64) float32 messages into "
          f"{n:,} receivers: sorted accumulating index_put (the port's, "
          f"bit for bit run to run) {sorted_ms:.3f} ms, atomic index_add_ "
          f"{atomic_ms:.3f} ms; largest gap {gap:.3e}")
    del msg
    return {"sorted_segment_sum_ms": sorted_ms,
            "atomic_segment_sum_ms": atomic_ms, "sum_gap": gap}


def gnn_profile(setup) -> dict:
    """``profile_call`` of one training step, its kernels grouped by what
    they do, and AdamW's update timed alone (on gradients of ones)."""
    from repro_torch.optim.adamw import AdamW
    state, step_fn, make_batch = setup()
    batch = make_batch(0)
    prof = profile_call(lambda: step_fn(state, batch), "training step")
    groups = {g: 0.0 for g, _ in GNN_KERNEL_GROUPS}
    groups["other (elementwise, AdamW, norms)"] = 0.0
    for nm, ms in prof["by_name_ms"].items():
        for g, keys in GNN_KERNEL_GROUPS:
            if any(k in nm for k in keys):
                groups[g] += ms
                break
        else:
            groups["other (elementwise, AdamW, norms)"] += ms
    params, ost = state
    opt = AdamW(lr=1e-3, total_steps=GNN_STEPS)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    adamw_ms = cuda_ms(lambda: opt.update(grads, ost, params))
    print("  by what the kernels do: " + ", ".join(
        f"{g} {ms:.3f} ms" for g, ms in groups.items())
        + f"; AdamW's update alone {adamw_ms:.3f} ms "
          f"({len(params)} tensors)")
    prof["groups_ms"] = groups
    prof["adamw_ms"] = adamw_ms
    return prof


def gnn_cell(label, arch, shape_name, dev, kernels, work) -> dict:
    """One cell of 21a-21c: ``gnn_setup`` at the registered width on the
    shape (kernel 7's launches counted around exactly this and the runs),
    20 steps through the Trainer checkpointing at step 10, then a run
    resumed from step 10: losses, parameters and moments bit for bit,
    step ms (median of steps 1-19), edges a second, peak memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import gnn_setup
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    opt = AdamW(lr=1e-3, total_steps=GNN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k7 = kernels["rmat_counter"]
    n0 = k7.launches
    with rmat_plain_tripwire() as plain_calls:
        ts = time.perf_counter()
        built = gnn_setup(cfg, dev, opt, shape_name)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - ts
        launches = k7.launches - n0
        setup = lambda: built                              # noqa: E731
        full, losses, times, _ = train_run(arch, setup, GNN_STEPS,
                                           work / f"{arch}_a", kernels, ())
        resume_point(work / f"{arch}_a", work / f"{arch}_b")
        resumed, losses_b, _, _ = train_run(arch, setup, GNN_STEPS,
                                            work / f"{arch}_b", kernels, (),
                                            resume=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(plain_calls["rmat_edges_counter_plain"] == 0,
          f"{arch}: kernel 7's plain version ran on the main path")
    check(launches > 0 or shape_name not in ("ogb_products", "minibatch_lg"),
          f"{arch} on {shape_name}: kernel 7 made no edges")
    same = (losses_b == losses[TRAIN_RESUME_AT:]
            and all(torch.equal(full[0][k], resumed[0][k]) for k in full[0])
            and all(torch.equal(full[1].mu[k], resumed[1].mu[k])
                    and torch.equal(full[1].nu[k], resumed[1].nu[k])
                    for k in full[1].mu))
    step_s = float(np.median(times[1:]))
    if shape.kind == "sampled":
        from repro_torch.launch.cells import sampled_sizes
        n_sub, edges = sampled_sizes(shape)
        size = (f"{shape.n_nodes:,} nodes, {shape.n_edges:,} edges in the "
                f"CSR; {shape.batch_nodes} seeds at fanout {shape.fanout}: "
                f"{n_sub:,} nodes, {edges:,} edges a step")
    else:
        b = built[2](0)
        edges = int(b["senders"].numel())
        size = (f"{b['x'].shape[0]:,} nodes, {edges:,} edges, d_feat "
                f"{b['x'].shape[1]}")
    n_par = sum(v.numel() for v in built[0][0].values())
    print(f"{label} {arch} ({cfg.n_layers} layers, d_hidden {cfg.d_hidden}, "
          f"{n_par:,} parameters) on {shape_name} ({size}): setup "
          f"{setup_s:.2f} s with {launches} kernel-7 launches; step "
          f"{step_s * 1e3:.3f} ms median (first {times[0] * 1e3:.1f} ms), "
          f"{edges / step_s:,.1f} edges/s; loss step 0 {losses[0]:.4f}, "
          f"step {TRAIN_RESUME_AT} {losses[TRAIN_RESUME_AT]:.4f}, step "
          f"{GNN_STEPS - 1} {losses[-1]:.4f}; peak {peak:.3f} GiB; resumed "
          f"from step {TRAIN_RESUME_AT}: losses, params and AdamW moments "
          f"bit for bit {same}")
    check(same, f"{arch}: the resumed run differs from the uninterrupted one")
    check(all(np.isfinite(losses)), f"{arch}: a loss is not finite: {losses}")
    check(peak < (GIN_PEAK_GIB if arch == "gin-tu" else GNN_PEAK_GIB),
          f"{arch} on {shape_name}: peak {peak:.3f} GiB")
    rec = {"step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
           "edges_per_s": edges / step_s, "edges_a_step": edges,
           "setup_s": setup_s, "losses": losses, "losses_resumed": losses_b,
           "peak_gib": peak, "resume_bit_for_bit": same,
           "rmat_counter_launches": launches, "params": n_par}
    if arch == "gin-tu":
        rec.update(gnn_atomic_step(built))
        print("-- profile of one gin-tu ogb_products step (trained state)")
        rec["profile"] = gnn_profile(lambda: (full, built[1], built[2]))
        batch = built[2](0)
        rec["graph"] = (batch["senders"], batch["receivers"],
                        batch["x"].shape[0])
        rec["batch"] = batch           # phase 22c trains gin-tu-2d on it
        rec["stream_err"] = check_gnn_stream(shape, dev, batch["senders"],
                                             batch["receivers"])
    if shape.kind == "sampled":
        # the CSR holds the edges sorted by sender: regenerate them in
        # _edges_for's order for the check
        from repro_torch.graph.datasets import _edges_for
        rec["stream_err"] = check_gnn_stream(
            shape, dev, *_edges_for(shape.n_nodes, shape.n_edges, 0, dev))
    del full, resumed, built
    return rec


def gnn_first_step_gaps(dev) -> dict:
    """21e: each arch's loss and gradients on the smoke graph on the card
    against the CPU path on the same batch and parameters: the float32
    loss within 1e-5, and loss and gradients in float64 within the CPU
    tests' 1e-5 and 1e-4.  Float32 gradients are printed, not held: a
    pre-activation within rounding of 0 flips a ReLU between the two
    devices' summation orders (one of MeshGraphNet's 15 layers' units did
    on the card), a kink no rounding tolerance covers."""
    from repro_torch.configs.base import get_config
    from repro_torch.graph.datasets import build_gnn_batch
    from repro_torch.launch import cells
    from repro_torch.launch.train import GNN_SMOKE
    out = {}
    for _, arch, _ in GNN_CELLS:
        cfg = get_config(arch)
        rec = {}
        for dt in (torch.float32, torch.float64):
            res = []
            for d in (torch.device("cpu"), dev):
                b = build_gnn_batch(cfg, GNN_SMOKE, seed=0, device=d)
                b["node_mask"] = torch.ones(b["x"].shape[0], device=d)
                b["targets_g"] = torch.zeros(1, device=d)
                b = {k: v.to(dt) if v.is_floating_point() else v
                     for k, v in b.items()}
                init, loss_fn = cells._gnn_loss(
                    cfg, GNN_SMOKE, b["x"].shape[0], 1, b["x"].shape[1])
                p = {k: v.to(dt).requires_grad_(True)
                     for k, v in init(seed=0, device=d).items()}
                with cells.deterministic():
                    loss = loss_fn(p, b)
                    g = torch.autograd.grad(loss, list(p.values()))
                res.append((loss.detach().cpu(),
                            {k: v.cpu() for k, v in zip(p, g)}))
            (lc, gcpu), (lg, gg) = res
            tag = str(dt).split(".")[-1]
            rec[f"loss_gap_{tag}"] = float((lg - lc).abs())
            rec[f"loss_tol_{tag}"] = GNN_FWD * float(lc.abs()) + 1e-6
            rec[f"grad_worst_share_{tag}"] = max(
                float((gg[k] - gcpu[k]).abs().max()
                      / (GNN_GRAD * float(gcpu[k].abs().max()) + 1e-6))
                for k in gcpu)
            print(f"21e {arch} smoke graph, step 0 in {tag}, the card against "
                  f"the CPU: loss {float(lg):.6f} vs {float(lc):.6f} (gap "
                  f"{rec[f'loss_gap_{tag}']:.3e}, tolerance "
                  f"{rec[f'loss_tol_{tag}']:.3e}); gradients at worst "
                  f"{rec[f'grad_worst_share_{tag}']:.4f} of their tolerance"
                  + ("" if dt == torch.float64 else " (printed, not held)"))
            check(rec[f"loss_gap_{tag}"] <= rec[f"loss_tol_{tag}"],
                  f"21e {arch}: the card's {tag} loss differs from the CPU's")
        check(rec["grad_worst_share_float64"] <= 1,
              f"21e {arch}: the card's gradients differ from the CPU's")
        out[arch] = rec
    return out


def gnn_spmm(dev, senders, receivers, n) -> dict:
    """21d: ``spmm_2d`` on the ogb_products graph at d 64 on the simulated
    1x1 and 4x4 grids against one ``index_add_`` of the same edges, within
    1e-4 of each output's sum of |terms| plus 1e-4 (a hub row sums ~10^5
    terms in another order), each call timed and its exchanges
    recorded."""
    from repro_torch.core import collectives
    from repro_torch.core.spmm import make_spmm_fn
    from repro_torch.graph.formats import build_blocked
    from repro_torch.graph.rmat import preprocess
    out = {}
    e = preprocess(senders, receivers, n, symmetrize=False)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(n, SPMM_D, generator=gen, device=dev)
    want = torch.zeros_like(x).index_add_(0, e.dst, x.index_select(0, e.src))
    # float32 sums of up to a hub's in-degree of terms: the error bound
    # scales with the sum of the terms' magnitudes, not with the sum
    scale = torch.zeros_like(x).index_add_(0, e.dst,
                                           x.abs().index_select(0, e.src))
    lib_ms = cuda_ms(lambda: torch.zeros_like(x).index_add_(
        0, e.dst, x.index_select(0, e.src)), reps=5)
    for pr, pc in SPMM_GRIDS:
        ts = time.perf_counter()
        g = build_blocked(e, pr, pc, align=32)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - ts
        part = g.part
        fn = make_spmm_fn(part, dev)
        xb = torch.zeros(part.n, SPMM_D, device=dev)
        xb[:n] = x
        xb = xb.reshape(pr, pc, part.chunk, SPMM_D)
        with collectives.ScheduleRecorder() as rec:
            y = fn(g, xb)
        got = y.reshape(part.n, SPMM_D)[:n]
        gap = float(((got - want).abs() - 1e-4 * scale).max())
        ms = cuda_ms(lambda: fn(g, xb), reps=5)
        counts = rec.counts()
        print(f"21d spmm_2d {pr}x{pc} on ogb_products ({e.m:,} edges after "
              f"dedup, d {SPMM_D}): {ms:.3f} ms a call (build_blocked "
              f"{build_s:.2f} s), one index_add_ of the same edges "
              f"{lib_ms:.3f} ms; |spmm - index_add_| - 1e-4 x (the row's "
              f"sum of |terms|) at most {gap:.3e}; recorded {counts}")
        check(gap <= 1e-4, f"spmm_2d {pr}x{pc} differs from index_add_")
        check(counts == {"collective-permute": 1, "all-gather": 1,
                         "reduce-scatter": 1, "total": 3},
              f"spmm_2d {pr}x{pc} recorded {counts}")
        out[f"{pr}x{pc}"] = {"ms": ms, "build_s": build_s, "gap": gap,
                             "recorded": counts}
        del g, y, got, xb
        gc.collect()
        torch.cuda.empty_cache()
    out["index_add_ms"] = lib_ms
    out["edges"] = e.m
    return out


def gnn_phases(dev, kernels) -> dict:
    """Phase 21 (``main`` and ``--gnn``): the GNN cells trained and
    resumed, the 2D SpMM, the first steps against the CPU, the GNN
    drivers; their records and kernel 7's launches."""
    import shutil
    import tempfile
    rec, secs = {}, {}
    t0 = time.perf_counter()

    def lap(lbl):
        secs[lbl] = time.perf_counter() - t0 - sum(secs.values())
        print(f"({lbl}: {secs[lbl]:.1f} s)")
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="gnn_", dir=ROOT / "build"))
    launches = 0
    for label, arch, shape_name in GNN_CELLS:
        phase(f"{label} {arch} on {shape_name} at the registered width: "
              f"{GNN_STEPS} steps, resumed from step {TRAIN_RESUME_AT}")
        r = rec[arch] = gnn_cell(label, arch, shape_name, dev, kernels, work)
        launches += r["rmat_counter_launches"]
        lap(f"{label} {arch}")
        if arch == "gin-tu":
            senders, receivers, n = r.pop("graph")
            gin_batch = r.pop("batch")
            phase(f"21d spmm_2d on the ogb_products graph at d {SPMM_D} on "
                  f"the simulated 1x1 and 4x4 grids")
            rec["spmm"] = gnn_spmm(dev, senders, receivers, n)
            del senders, receivers
            lap("21d")
    print(f"kernel 7 launches on the GNN path (21a-21c, the graphs' "
          f"generation): {launches}; its plain version called there: 0")
    errs = max(rec[a].get("stream_err", 0) for _, a, _ in GNN_CELLS)
    phase("21e the first step of each cell's arch on the smoke graph: the "
          "card against the CPU path")
    rec["first_steps"] = gnn_first_step_gaps(dev)
    lap("21e")
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = secs
    return {"record": rec, "launches": {"rmat_counter": launches},
            "errs": {"rmat_counter": errs}, "gin_batch": gin_batch}


# phase 22: the dry-run and roofline tooling (launch/{cells,dryrun,
# roofline,report,optimized}.py) on the card
DRYRUN_JOBS = 8                    # 22a's worker processes (8 host cores)
DRYRUN_RECORDS = 40 * 2 + 3 * 2 + 8   # cells x meshes, BFS scales, hill-climb
# 22b: the 1x1 cells the card holds at their registered size
CARD_CELLS = (("smollm-135m", "prefill_32k"), ("autoint", "train_batch"),
              ("autoint", "serve_p99"), ("autoint", "serve_bulk"),
              ("autoint", "retrieval_cand"), ("gat-cora", "full_graph_sm"),
              ("mace", "molecule"), ("meshgraphnet", "minibatch_lg"),
              ("gin-tu", "ogb_products"))
CARD_REPS, CARD_WARM = 5, 2        # timed steps (median) after warm-up ones
PEAK_TOL = (0.10, 512 * 2**20)     # reckoned peak against the card's: the
#                                    larger of 10% and 512 MiB
GIN2D_GRID = (4, 4)
GIN2D_STEPS = 10
GIN2D_LR = 1e-2                    # AdamW, no warm-up, constant: 10 steps
#                                    that move the loss
# the first 2D loss against gin-tu 1x1's: the same float32 sums in another
# order, hub rows of ~1e5 terms (21e holds 1e-5 on the smoke graph)
GIN2D_LOSS_RTOL = 1e-4
# 22c's peak limit: 21a's 1x1 step peaked at 44.343 GiB; the 2D step adds
# the blocks' row strips (p * nr rows = pc * n, 3.9 GB at d 100 in the
# forward and as much in the backward), the blocked edge arrays (16 x cap
# int32, twice) and the live edges' int64 indices (4 x 61.9 M x 8 B): about
# 12 GiB more
GIN2D_PEAK_GIB = 60.0
MACE2D_GRID = (2, 2)
MACE2D_TOL = {"loss": 1e-4, "param": 1e-5}   # card against CPU, float32


def _ints(t, hi, gen):
    t.copy_(torch.randint(0, hi, t.shape, generator=gen, device=t.device,
                          dtype=t.dtype))


def fill_cell(cell, cfg, gen) -> None:
    """Seeded values in a cell's non-parameter arguments, valid for its
    model: token, field and node ids in range, a CSR of even rows, masks
    of ones, normal floats."""
    fam, meta = cell.meta["family"], cell.meta
    dev = gen.device

    def normal(t):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    if fam == "lm":
        _ints(cell.args[1], cfg.vocab, gen)
        for c in cell.args[2].values():
            c.zero_()
    elif fam == "recsys":
        train = meta["kind"] == "train"
        idx = cell.args[2 if train else 1]
        for f, v in enumerate(cfg.vocab_sizes):
            _ints(idx[:, f], v, gen)
        if train:
            cell.args[3].copy_((torch.rand(cell.args[3].shape, generator=gen,
                                           device=dev) < 0.5).float())
        elif meta["kind"] == "retrieval":
            normal(cell.args[2])
    elif meta.get("sampled"):
        row_ptr, col_idx, feats, labels, seeds, key = cell.args[2:]
        n, m = feats.shape[0], col_idx.shape[0]
        row_ptr.copy_(torch.arange(n + 1, device=dev) * m // n)
        for t, hi in ((col_idx, n), (labels, cfg.n_classes), (seeds, n)):
            _ints(t, hi, gen)
        normal(feats)
        key.zero_()
    else:
        b = cell.args[2]
        n = b["graph_ids"].shape[0]
        for k in ("senders", "receivers"):
            _ints(b[k], n, gen)
        n_graphs = b["labels"].shape[0] if b["labels"].shape[0] != n else 1
        b["graph_ids"].copy_(torch.arange(n, device=dev) * n_graphs // n)
        _ints(b["labels"], cfg.n_classes, gen)
        for k in ("edge_mask", "node_mask"):
            b[k].fill_(1.0)
        if "species" in b:
            _ints(b["species"], 16, gen)
        for k in ("x", "pos", "targets_g", "e_feat", "targets"):
            if k in b:
                normal(b[k])


def _counts(c) -> dict:
    s = c.summary()
    return {k: s[k] for k in ("flops", "flops_by_class", "bytes_read",
                              "bytes_written", "kernels")}


def card_cell(arch, shape_name, dev) -> dict:
    """22b: one 1x1 cell counted on meta, then run on the card with seeded
    inputs of the same shapes under the same counter: both counts (equal),
    the reckoned peak (argument bytes plus the trace's peak) against
    ``max_memory_allocated``, the step's median ms, the roofline's bound,
    share and MFU."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import cells, roofline
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config(arch)
    mesh_m = make_mesh(1, 1, device="meta")
    cell_m = cells.build_cell(arch, shape_name, mesh_m)
    t0 = time.perf_counter()
    with roofline.StepCounter() as cm:
        cell_m.fn(*cell_m.args)
    trace_s = time.perf_counter() - t0
    reckoned = cells.per_device_bytes(cell_m.args, cell_m.specs, mesh_m) \
        + cm.peak_bytes
    del cell_m
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cell = cells.build_cell(arch, shape_name, make_mesh(1, 1, device=dev))
    fill_cell(cell, cfg, torch.Generator(device=dev).manual_seed(SEED + 22))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with roofline.StepCounter() as cc:
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    meta_c, card_c = _counts(cm), _counts(cc)
    if meta_c != card_c:
        for k in sorted(set(cm.ops) | set(cc.ops)):
            if cm.ops.get(k) != cc.ops.get(k):
                print(f"   op {k}: meta {cm.ops.get(k)} card {cc.ops.get(k)}")
    fails = [] if meta_c == card_c else [
        f"22b {arch}/{shape_name}: the meta count {meta_c} differs from the "
        f"card's {card_c}"]
    times = []
    for i in range(CARD_WARM + CARD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    step_s = float(np.median(times[CARD_WARM:]))
    rec = {"n_devices": 1, "flops": cc.total_flops,
           "flops_by_class": dict(cc.flops),
           "bytes_accessed": cc.bytes_accessed,
           "collectives": {"total_bytes": 0.0}, "meta": cell.meta}
    roof = roofline.roofline_report(rec)
    share = roof["bound_time_s"] / step_s
    mfu = roof["model_flops"] / (step_s * PEAK_FLOPS)
    gib = 2**30
    tol = max(PEAK_TOL[0] * peak, PEAK_TOL[1])
    print(f"22b {arch}/{shape_name}: meta trace {trace_s:.2f} s; meta "
          f"FLOPs {meta_c['flops']:.6g}, bytes {meta_c['bytes_read']:,} "
          f"read, {meta_c['bytes_written']:,} written; card FLOPs "
          f"{card_c['flops']:.6g} (bf16 {card_c['flops_by_class']['bf16']:.6g}, "
          f"fp32 {card_c['flops_by_class']['fp32']:.6g}), bytes "
          f"{card_c['bytes_read']:,} read, {card_c['bytes_written']:,} "
          f"written: equal {meta_c == card_c}; kernels {card_c['kernels']}; "
          f"reckoned peak "
          f"{reckoned / gib:.3f} GiB, the card's {peak / gib:.3f} GiB; step "
          f"{step_s * 1e3:.3f} ms (median of {CARD_REPS} after "
          f"{CARD_WARM}); bound {roof['bound_time_s'] * 1e3:.3f} ms "
          f"({roof['dominant']}: compute {roof['compute_s'] * 1e3:.3f}, "
          f"memory {roof['memory_s'] * 1e3:.3f} ms); roofline share "
          f"{share:.4f}, MFU {mfu:.4f} (model FLOPs "
          f"{roof['model_flops']:.6g})")
    if abs(reckoned - peak) > tol:
        fails.append(f"22b {arch}/{shape_name}: reckoned peak "
                     f"{reckoned / gib:.3f} GiB against the card's "
                     f"{peak / gib:.3f} GiB")
    if share > 1.0:
        fails.append(f"22b {arch}/{shape_name}: roofline share {share}")
    for f in fails:
        print(f"   {f}")
    del cell
    return {"trace_s": trace_s, "counts": card_c, "reckoned_peak": reckoned,
            "card_peak": peak, "step_ms": step_s * 1e3,
            "step_ms_all": [t * 1e3 for t in times],
            "bound_ms": roof["bound_time_s"] * 1e3,
            "dominant": roof["dominant"], "share": share, "mfu": mfu,
            "model_flops": roof["model_flops"], "fails": fails}


def gin2d_phase(dev, batch) -> dict:
    """22c: gin-tu-2d on ogb_products at full width on the simulated 4x4
    grid (edges blocked without deduplication, so the step sums gin-tu
    1x1's edge multiset), 10 steps; the first loss against gin-tu 1x1's on
    the same edges, parameters and labels; the recorded exchanges a step
    against comm_model's expand and fold volumes."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import collectives
    from repro_torch.core.comm_model import AlphaBeta
    from repro_torch.core.partition import make_partition
    from repro_torch.launch import cells, roofline
    from repro_torch.launch.optimized import (block_edges, gin2d_loss,
                                              node_blocks)
    from repro_torch.models.gnn import init_gin
    from repro_torch.optim.adamw import AdamW
    cfg = get_config("gin-tu")
    shape = next(s for s in cfg.shapes if s.name == "ogb_products")
    x, y = batch["x"], batch["labels"]
    n, d_feat = x.shape
    params = init_gin(cfg, d_feat, cfg.n_classes, seed=0, device=dev)
    _, loss1_fn = cells._gnn_loss(cfg, shape, n, 1, d_feat)
    with torch.no_grad():
        loss1 = float(loss1_fn(params, batch))
    gc.collect()
    torch.cuda.empty_cache()
    pr, pc = GIN2D_GRID
    part = make_partition(n, pr, pc, align=128)
    t0 = time.perf_counter()
    esrc, ridx, nnz = block_edges(part, batch["senders"], batch["receivers"])
    xs, ys = node_blocks(part, x), node_blocks(part, y)
    mask = node_blocks(part, batch["node_mask"])
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    loss_fn = gin2d_loss(part, cfg.n_layers)
    with torch.no_grad():
        first = float(loss_fn(params, esrc, ridx, nnz, xs, ys, mask))
    gap = abs(first - loss1) / abs(loss1)
    print(f"22c gin-tu-2d on ogb_products ({n:,} nodes, "
          f"{int(nnz.sum()):,} edges in {part.p} blocks of up to "
          f"{esrc.shape[-1]:,}, blocked in {block_s:.2f} s): first loss "
          f"{first:.6f} against gin-tu 1x1's {loss1:.6f}: relative gap "
          f"{gap:.3g} (tolerance {GIN2D_LOSS_RTOL})")
    check(int(nnz.sum()) == batch["senders"].numel(),
          "22c: the blocks lost edges")
    check(gap <= GIN2D_LOSS_RTOL, f"22c: first loss {first} against {loss1}")
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    opt = AdamW(lr=GIN2D_LR, warmup_steps=1, schedule="constant",
                total_steps=GIN2D_STEPS)
    step = cells._train_step(loss_fn, opt)
    ost = opt.init(p)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times, recs = [], [], None
    for i in range(GIN2D_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives.ScheduleRecorder() as rec:
            p2, ost, loss = step(p, ost, esrc, ridx, nnz, xs, ys, mask)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        p = {k: v.detach().requires_grad_() for k, v in p2.items()}
        recs = rec.records
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(times[1:])) * 1e3
    # the recorded exchanges of a step against the closed forms: each
    # layer's expand gathers n/pc rows of d floats a device and its fold
    # keeps n/p of them (comm_model.AlphaBeta's volume terms, word = 4d B)
    ab = AlphaBeta(alpha_n=0.0)
    widths = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    by = {}
    for r in recs:
        by.setdefault(r.kind, []).append(r.nbytes)
    want_ag = [round(ab.expand_cost(part.n, pr, pc, 4 * d) * roofline.LINK_BW)
               for d in widths]
    want_rs = [round(ab.fold_cost(part.n, pr, pc, 4 * d) * roofline.LINK_BW)
               for d in widths]
    coll = roofline.collective_bytes_from_records(recs)
    print(f"22c {GIN2D_STEPS} steps on {pr}x{pc}: losses "
          f"{[round(v, 5) for v in losses]}; step {step_ms:.3f} ms median "
          f"of steps 1-{GIN2D_STEPS - 1} (first {times[0] * 1e3:.1f} ms); "
          f"peak {peak:.3f} GiB (limit {GIN2D_PEAK_GIB}); recorded a step: "
          f"{dict(collectives.count_kinds(recs))}, bytes a device {coll}; "
          f"all-gathers {by.get('all-gather')} against the expand's "
          f"{want_ag}, reduce-scatters {by.get('reduce-scatter')} against "
          f"the fold's {want_rs}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"22c: the loss does not fall: {losses}")
    check(peak < GIN2D_PEAK_GIB, f"22c: peak {peak:.3f} GiB")
    check(by.get("all-gather") == want_ag
          and by.get("reduce-scatter") == want_rs
          and len(by.get("collective-permute", ())) == cfg.n_layers,
          "22c: the recorded exchanges differ from the closed forms")
    del esrc, ridx, xs, ys, mask, p, p2, ost
    return {"first_loss": first, "loss_1x1": loss1, "gap": gap,
            "losses": losses, "step_ms": step_ms,
            "first_step_ms": times[0] * 1e3, "peak_gib": peak,
            "block_s": block_s, "collectives": coll,
            "edges": int(batch["senders"].numel())}


def mace2d_phase(dev) -> dict:
    """22d: mace-2d at full_graph_sm on the simulated 2x2 grid, one step
    on the card against the CPU on the same seeded inputs: the loss and
    the updated parameters; the step's ms on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.optimized import (_part_and_cap, block_edges,
                                              build_mace2d_cell, node_blocks)
    from repro_torch.models.mace import init_mace
    from repro_torch.optim.adamw import AdamW
    cfg = get_config("mace")
    shape = next(s for s in cfg.shapes if s.name == "full_graph_sm")
    part, cap = _part_and_cap(shape, make_mesh(*MACE2D_GRID, device="meta"))
    rng = np.random.default_rng(SEED + 22)
    n, e = shape.n_nodes, shape.n_edges
    s = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    sp = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32))
    pos = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    args = [*block_edges(part, s, r, cap), node_blocks(part, sp),
            node_blocks(part, pos), torch.tensor([1.5])]
    params = init_mace(cfg, seed=SEED)
    out = {}
    for where in ("cpu", dev):
        cell = build_mace2d_cell("full_graph_sm",
                                 make_mesh(*MACE2D_GRID, device=where))
        p = {k: v.to(where).requires_grad_() for k, v in params.items()}
        a = [t.to(where) for t in args]
        times = []
        for i in range(3 if where != "cpu" else 1):
            if where != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            p2, _, loss = cell.fn(p, AdamW().init(p), *a)
            if where != "cpu":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[str(where)] = (float(loss), {k: v.detach().cpu()
                                         for k, v in p2.items()}, times)
    (l_cpu, p_cpu, _), (l_card, p_card, t_card) = out["cpu"], out[str(dev)]
    gap = abs(l_card - l_cpu) / abs(l_cpu)
    pgap = max(float((p_card[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    print(f"22d mace-2d on full_graph_sm, {MACE2D_GRID[0]}x{MACE2D_GRID[1]}: "
          f"loss card {l_card:.6f}, CPU {l_cpu:.6f} (relative gap {gap:.3g}, "
          f"tolerance {MACE2D_TOL['loss']}); updated parameters max |card - "
          f"CPU| {pgap:.3g} (tolerance {MACE2D_TOL['param']}); a step "
          f"{float(np.median(t_card[1:])) * 1e3:.3f} ms on the card")
    check(gap <= MACE2D_TOL["loss"] and pgap <= MACE2D_TOL["param"],
          "22d: mace-2d on the card differs from the CPU")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "gap": gap,
            "param_gap": pgap, "step_ms": float(np.median(t_card[1:])) * 1e3}


def dryrun_phases(dev, gin_batch=None) -> dict:
    """Phase 22 (``main`` and ``--dryrun``): the dry-run of every cell on
    the host (22a), the 1x1 cells on the card against their meta counts
    (22b), gin-tu-2d at full width (22c) and mace-2d against the CPU
    (22d); their records."""
    import shutil
    import tempfile
    from repro_torch.launch import report
    rec = {}
    phase(f"22a the dry-run: every cell on meta, both meshes, "
          f"{DRYRUN_JOBS} worker processes")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--cells", "all", "--mesh", "both", "--results",
                        str(results), "--jobs", str(DRYRUN_JOBS)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    dry_s = time.perf_counter() - t0
    (out_dir / "dryrun.log").write_text(r.stdout + r.stderr)
    n_rec = len(list(results.glob("*.json")))
    print(f"22a dry-run: exit {r.returncode}, {n_rec} records (want "
          f"{DRYRUN_RECORDS}) in {dry_s:.1f} s; the log in "
          f"chiprun_out/dryrun.log")
    if r.returncode:
        print(r.stdout[-4000:] + r.stderr[-4000:])
    check(r.returncode == 0 and n_rec == DRYRUN_RECORDS,
          "22a: the dry-run failed")
    recs = report.load_all(str(results))
    tables = (report.dryrun_table(recs) + "\n\n"
              + report.roofline_table(recs))
    (out_dir / "dryrun_report.md").write_text(tables + "\n")
    (out_dir / "dryrun_records.json").write_text(json.dumps(recs))
    print(tables)
    rec["dryrun"] = {"seconds": dry_s, "records": n_rec}
    shutil.rmtree(results, ignore_errors=True)

    phase("22b the 1x1 cells at their registered size: counted on meta, "
          "run on the card under the same counter")
    rec["cells"] = {f"{a}/{s}": card_cell(a, s, dev) for a, s in CARD_CELLS}
    fails = [f for r in rec["cells"].values() for f in r["fails"]]
    check(not fails, "; ".join(fails))
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"22c gin-tu-2d on ogb_products at full width on the simulated "
          f"{GIN2D_GRID[0]}x{GIN2D_GRID[1]} grid, {GIN2D_STEPS} steps")
    if gin_batch is None:
        from repro_torch.configs.base import get_config
        from repro_torch.graph.datasets import build_gnn_batch
        cfg = get_config("gin-tu")
        shape = next(s for s in cfg.shapes if s.name == "ogb_products")
        gin_batch = build_gnn_batch(cfg, shape, seed=0, device=dev)
        gin_batch["node_mask"] = torch.ones(gin_batch["x"].shape[0],
                                            device=dev)
    rec["gin2d"] = gin2d_phase(dev, gin_batch)
    del gin_batch
    gc.collect()
    torch.cuda.empty_cache()

    phase("22d mace-2d on full_graph_sm on the simulated 2x2 grid: the card "
          "against the CPU")
    rec["mace2d"] = mace2d_phase(dev)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time kernels 1-9 (see kernel_times)")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --kernel-times: the checkout to time")
    ap.add_argument("--backward", action="store_true",
                    help="only phase 17: kernels 8b and 9b checked and "
                         "timed")
    ap.add_argument("--moe", action="store_true",
                    help="only phases 19-20: the new LM configs served, "
                         "the simulated mesh, MoE training")
    ap.add_argument("--dryrun", action="store_true",
                    help="only phase 22: the dry-run of every cell, the 1x1 "
                         "cells on the card against their meta counts, "
                         "gin-tu-2d at full width, mace-2d")
    ap.add_argument("--gnn", action="store_true",
                    help="only phase 21: the GNN archs trained at the "
                         "registered widths, the 2D SpMM, the GNN drivers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script runs "
              "the port on a CUDA card", flush=True)
        return 2
    if args.kernel_times:
        return kernel_times(args.tree)
    if args.backward:
        print(smi_line())
        check_kernel8b(torch.device("cuda"))
        check_kernel9b(torch.device("cuda"))
        return 0
    if args.moe:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        print(smi_line())
        new_lm_phases(torch.device("cuda"), {
            "flash_attention": fa_ops.KERNEL,
            "flash_attention_bwd": fa_ops.KERNEL_BWD})
        return 0
    if args.dryrun:
        print(smi_line())
        dryrun_phases(torch.device("cuda"))
        return 0
    if args.gnn:
        from repro_torch.graph import rmat
        print(smi_line())
        gnn_phases(torch.device("cuda"), {"rmat_counter": rmat.RMAT_COUNTER})
        phase("21 drivers: launch.train --arch gin-tu and "
              "examples.gnn_full_graph on the card")
        run_train_drivers(GNN_DRIVERS)
        return 0

    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.bottomup import ops as bu_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.epilogue import ops as ep_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.frontier_codec import ops as codec_ops
    from repro_torch.kernels.spmsv import ops as sp_ops
    from repro_torch.kernels.spmsv import strip

    kernels = {"spmsv_csr_min": sp_ops.KERNEL,
               "spmsv_dcsc_min": sp_ops.KERNEL_DCSC,
               "spmsv_strips_csr_min": sp_ops.KERNEL_STRIPS,
               "bottomup_substep": bu_ops.KERNEL,
               "rmat_counter": rmat.RMAT_COUNTER,
               "spmsv_strip_min": strip.KERNEL,
               "spmsv_strip_chunk_min": strip.KERNEL_CHUNK,
               "codec_encode": codec_ops.ENCODE,
               "codec_decode": codec_ops.DECODE,
               "embedding_bag": eb_ops.KERNEL,
               "flash_attention": fa_ops.KERNEL,
               "embedding_bag_bwd_keys": eb_ops.KERNEL_BWD_KEYS,
               "embedding_bag_bwd_sort": eb_ops.KERNEL_BWD_SORT,
               "embedding_bag_bwd_tiles": eb_ops.KERNEL_BWD_TILES,
               "embedding_bag_bwd": eb_ops.KERNEL_BWD,
               "flash_attention_bwd": fa_ops.KERNEL_BWD,
               "level_epilogue": ep_ops.KERNEL}
    replaces = {
        "spmsv_csr_min": "src/repro/kernels/spmsv/spmsv.py:56",
        "spmsv_dcsc_min": "src/repro/kernels/spmsv/spmsv.py:56",
        "spmsv_strips_csr_min": "src/repro/kernels/spmsv/spmsv.py:56",
        "bottomup_substep": "src/repro/kernels/bottomup/bottomup.py:89",
        "rmat_counter": "src/repro/graph/rmat.py:225",
        "spmsv_strip_min": "src/repro/kernels/spmsv/strip.py:66",
        "spmsv_strip_chunk_min": "src/repro/kernels/spmsv/strip.py:139",
        "codec_encode":
            "src/repro/kernels/frontier_codec/frontier_codec.py:58",
        "codec_decode":
            "src/repro/kernels/frontier_codec/frontier_codec.py:93",
        "embedding_bag":
            "src/repro/kernels/embedding_bag/embedding_bag.py:41",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:79",
        # the gradients of kernels 8 and 9, which the JAX package takes
        # with XLA (jax.grad) around those Pallas kernels' functions
        "embedding_bag_bwd_keys":
            "src/repro/kernels/embedding_bag/embedding_bag.py:41",
        "embedding_bag_bwd_sort":
            "src/repro/kernels/embedding_bag/embedding_bag.py:41",
        "embedding_bag_bwd_tiles":
            "src/repro/kernels/embedding_bag/embedding_bag.py:41",
        "embedding_bag_bwd":
            "src/repro/kernels/embedding_bag/embedding_bag.py:41",
        "flash_attention_bwd":
            "src/repro/kernels/flash_attention/flash_attention.py:79",
        # no Pallas call: XLA fuses the level's update and masses
        "level_epilogue": "src/repro/core/steps.py:241 (XLA-fused)"}
    path_2d = ("spmsv_csr_min", "bottomup_substep", "rmat_counter",
               "level_epilogue")
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
    print(f"bounds use {HBM_BW / 1e12} TB/s (published H100 SXM "
          f"peak); the integer rate's peak is {INSTR_PER_CLOCK_PER_SM} x "
          f"{n_sm} SMs x {sm_mhz} MHz max SM clock = "
          f"{instr_per_s / 1e12:.3f} T instructions/s (phase 2 measures "
          f"the rate kernel 7's bound uses)")
    record["device"] = {"name": name, "smi": smi_nl, "sms": n_sm,
                        "sm_mhz_max": sm_mhz, "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # ---------------------------------------------------------------- 2
    phase("2 build")
    t0 = time.perf_counter()
    stems = sorted({kn.stem for kn in kernels.values()})
    libs = build.build_libraries([*stems, "int_rate"])
    record["build_s"] = time.perf_counter() - t0
    for stem in stems:
        print(f"{stem}: {libs[stem].name}")
        for line in build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    for kn in kernels.values():
        kn.load()
    print(f"nvcc for sm_90a, all {len(stems)} sources ({len(kernels)} C "
          f"entries) and the integer-rate benchmark in parallel: "
          f"{record['build_s']:.2f} s")
    # kernel 9's bf16 prefill runs on the tensor cores: its SASS holds
    # warpgroup MMAs
    record["flash_attention_hgmma"] = sass(libs["flash_attention"]).count(
        "HGMMA")
    print(f"flash_attention SASS: {record['flash_attention_hgmma']} HGMMA "
          f"instructions")
    check(record["flash_attention_hgmma"] > 0, "no HGMMA in kernel 9")
    # kernel 7's instructions per level: the SASS of its scale-SCALE
    # instantiation less that of scale SCALE-8, over 8 (its levels are
    # unrolled and interleaved, so the marginal count is a level's); and
    # the integer rate the card reaches on that level body
    k7_sass = sass(libs["rmat_counter"])
    k7_n = {sc: sass_instructions(sass_function(
        k7_sass, f"rmat_counter_kernelILi{sc}E")) for sc in (SCALE - 8, SCALE)}
    check(len(sass_addresses(sass_function(
        k7_sass, f"rmat_counter_kernelILi{SCALE}E"), "0x7feb352d")) == SCALE,
        f"the scale-{SCALE} kernel does not multiply once a level")
    rmat_per_level = (k7_n[SCALE] - k7_n[SCALE - 8]) / 8
    ir = measure_int_rate(libs["int_rate"], n_sm)
    ir["rmat_counter_instr_per_level"] = rmat_per_level
    record["int_rate"] = ir
    rmat_instr_per_s = ir["per_clock_per_sm"] * n_sm * sm_mhz * 1e6
    print(f"rmat_counter SASS: {k7_n[SCALE]} instructions at scale "
          f"{SCALE}, {k7_n[SCALE - 8]} at scale {SCALE - 8}: "
          f"{rmat_per_level:.2f} a level (its bound counts the least, "
          f"{RMAT_INSTR_PER_EDGE_LEVEL})")
    print(f"integer rate on rmat_counter's level body (int_rate.cu, "
          f"{ir['instr_per_iter']} SASS instructions an iteration of "
          f"{ir['levels']} levels, {ir['instr_per_level']:.2f} a level): "
          f"{ir['ms']:.4f} ms a launch at {ir['sm_mhz_under_load']} MHz "
          f"(nvidia-smi under load): {ir['per_clock_per_sm']:.2f} thread "
          f"instructions per clock per SM ("
          f"{ir['per_clock_per_sm_at_max_clock']:.2f} at the {sm_mhz} MHz "
          f"maximum; the table's peak {INSTR_PER_CLOCK_PER_SM}): "
          f"{ir['per_clock_per_sm']:.2f} x {n_sm} SMs x {sm_mhz} MHz = "
          f"{rmat_instr_per_s / 1e12:.3f} T instructions/s")
    # kernel 5 computes its words without a division on the card
    record["encode_sass"] = encode_sass(libs["codec_encode"], codec_ops)
    print(encode_sass_line(record["encode_sass"]))
    check(record["encode_sass"]["mufu_rcp"] == 0
          and record["encode_sass"]["calls"] == 0,
          "codec_encode_kernel's SASS holds a division sequence")
    launches, launches_1ds, launches_fast, launches_new, errs, per, \
        rmat_by_ops, born_ref = graph_paths(dev, kernels, record,
                                            rmat_instr_per_s, path_2d,
                                            path_1ds)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"\ndevice memory still allocated after the graph paths: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    # --------------------------------------------------------------- 8g
    phase(f"8g the born strips: dist_build(BuildSpec({SCALE}, {EDGE_FACTOR}, "
          f"{SEED}), '1ds') on {STRIPS} strips against phase 8's strips "
          f"(digests), its 1ds dcsc session on phase 8's roots, and a "
          f"squeezed route_slack that heals")
    record["born_strips"] = born_strips(dev, kernels, born_ref, launches_new)
    del born_ref

    # --------------------------------------------------------------- 10c
    phase(f"10c the graph store on the card: a born scale-{STORE_SCALE} 2x2 "
          f"graph saved, loaded into a session, a flipped and a truncated "
          f"shard regenerated; then run_fault_matrix on 1 and 4 simulated "
          f"devices")
    record["store"] = store_phase(dev, kernels, launches_new)

    # -------------------------------------------------------------- 10b
    phase("10b the drivers as users run them: graph500_bfs at scale 20 "
          "(2d, 2d --fast, 1ds on 16 strips), quickstart and serve_lm on "
          "the card; then graph500_bfs --born --store twice in 2d and in "
          "1ds on 16 strips")
    record["drivers"] = run_drivers()

    # --------------------------------------------------------------- 11
    phase("11 AutoInt serving at the registered width: serve_p99, "
          "serve_bulk, retrieval_cand, lookup through kernel 8")
    ai = serve_autoint(dev, kernels)
    record["autoint"] = ai["record"]

    # --------------------------------------------------------------- 12
    phase("12 kernel 8 (embedding_bag) against its plain version at the "
          "AutoInt path's shapes and multi-hot, tolerance 0, and timed")
    per["embedding_bag"] = check_kernel8(ai, dev)

    # --------------------------------------------------------------- 13
    phase("13 smollm-135m serving at the registered width: 8 requests, "
          "prefill and decode, attention through kernel 9")
    lm = serve_lm(dev, kernels)
    record["smollm"] = lm["record"]

    # --------------------------------------------------------------- 14
    phase("14 kernel 9 (flash_attention) against its plain version at the "
          "LM path's calls and over the sweep, and timed")
    per["flash_attention"] = check_kernel9(lm, dev)

    # --------------------------------------------------------------- 15
    phase("15 profiles of one serve_p99 batch, one serve_bulk batch and "
          "one decode step")
    record["profile_nn"] = {}
    for label, x in (("serve_p99 batch", ai["p99"][1]),
                     ("serve_bulk batch", ai["bulk"][1])):
        print(f"-- {label}")
        record["profile_nn"][label] = profile_call(
            lambda: ai["score"](x), label)
    print("-- decode step (4 rows at position 1500)")
    tok = torch.ones(LM_MAX_BATCH, 1, dtype=torch.int32, device=dev)

    def decode_once():
        with torch.inference_mode():
            lm["decode"](lm["cache"], tok, 1500)
    record["profile_nn"]["decode step"] = profile_call(decode_once,
                                                       "decode step")
    launches_nn = {"embedding_bag": ai["launches"],
                   "flash_attention": lm["launches"]}
    errs.update({k: per[k]["max_abs_err"] for k in launches_nn})

    # --------------------------------------------------------------- 16
    phase("16 smollm-135m prefill_32k: 32 x 32,768 tokens, attention "
          "through kernel 9")
    params = lm["params"]
    del ai, lm, tok, decode_once
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory still allocated: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    record["prefill_32k"] = p32 = prefill_32k(dev, kernels, params)
    launches_nn["flash_attention"] += p32["launches"]
    errs["flash_attention"] = max(errs["flash_attention"], p32["slice_err"])
    # the kernels line covers all of kernel 9's launches: the LM path's
    # and prefill_32k's
    fa = per["flash_attention"]
    for key in ("ms", "plain_ms", "bound_ms", "library_ms", "flops",
                "bytes"):
        fa[key] += p32[key]
    fa["bound_by"] = "operations" if fa["flops"] / PEAK_FLOPS \
        >= fa["bytes"] / HBM_BW else "bytes"
    print(f"kernel 9 over its {launches_nn['flash_attention']} launches "
          f"(LM path and prefill_32k): {fa['ms']:.4f} ms, plain "
          f"{fa['plain_ms']:.4f} ms, library {fa['library_ms']:.4f} ms, "
          f"bound {fa['bound_ms']:.4f} ms ({fa['bound_by']})")

    del params, p32
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 17
    phase("17 kernels 8b and 9b (the backward kernels) against their plain "
          "versions at the training paths' shapes, and timed")
    record["kernel8b"] = per["embedding_bag_bwd"] = check_kernel8b(dev)
    per["embedding_bag_bwd_keys"] = per["embedding_bag_bwd"]["keys"]
    per["embedding_bag_bwd_sort"] = per["embedding_bag_bwd"]["sort"]
    per["embedding_bag_bwd_tiles"] = per["embedding_bag_bwd"]["tiles"]
    record["kernel9b"] = per["flash_attention_bwd"] = check_kernel9b(dev)
    errs["embedding_bag_bwd"] = per["embedding_bag_bwd"]["max_abs_err"]
    for k in ("embedding_bag_bwd_keys", "embedding_bag_bwd_sort",
              "embedding_bag_bwd_tiles"):
        errs[k] = per[k]["max_abs_err"]
    errs["flash_attention_bwd"] = per["flash_attention_bwd"]["max_abs_err"]
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 18
    phase(f"18 training at the registered widths: smollm-135m B "
          f"{LM_TRAIN_BATCH} x S {LM_TRAIN_SEQ} for {TRAIN_STEPS} steps, "
          f"resumed from step {TRAIN_RESUME_AT}; autoint {AI_TRAIN_ROWS:,} "
          f"rows for {TRAIN_STEPS} steps; the training drivers")
    record["train"] = tr = train_phase(dev, kernels)
    for k, n in tr["launches"].items():
        launches_nn[k] = launches_nn.get(k, 0) + n
    for k, tag in (("embedding_bag_bwd_keys", "8b's keys"),
                   ("embedding_bag_bwd_sort", "8b's sort"),
                   ("embedding_bag_bwd_tiles", "8b's tiles"),
                   ("embedding_bag_bwd", "8b"), ("flash_attention_bwd", "9b")):
        r = per[k]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"kernel {tag} ({k}): {launches_nn[k]} launches on the "
              f"training path; at phase 17's first shape {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del tr
    new = new_lm_phases(dev, kernels)
    record["new_lm"] = new["record"]
    for k, n in new["launches"].items():
        launches_nn[k] = launches_nn.get(k, 0) + n
    errs["flash_attention"] = max(errs["flash_attention"],
                                  new["errs"]["flash_attention"])
    print(f"kernels 9 and 9b on the new configs' paths (phases 19-20): "
          f"{new['launches']}")
    del new
    gc.collect()
    torch.cuda.empty_cache()
    gnn = gnn_phases(dev, kernels)
    record["gnn"] = gnn["record"]
    launches_new["rmat_counter"] = (launches_new.get("rmat_counter", 0)
                                    + gnn["launches"]["rmat_counter"])
    errs["rmat_counter"] = max(errs["rmat_counter"],
                               gnn["errs"]["rmat_counter"])
    gin_batch = gnn.pop("gin_batch")
    del gnn
    gc.collect()
    torch.cuda.empty_cache()

    # phase 22 drives the dry-run's cells on the card: its kernels' counts
    # are set to 0 just before it and read just after
    for k in kernels.values():
        k.launches = 0
    record["dryrun"] = dryrun_phases(dev, gin_batch)
    del gin_batch
    launches_22 = {k: kn.launches for k, kn in kernels.items()
                   if kn.launches}
    print(f"kernel launches in phase 22 (its 1x1 cells on the card): "
          f"{launches_22}")
    for k in ("flash_attention", "embedding_bag", "embedding_bag_bwd"):
        check(launches_22.get(k, 0) > 0, f"phase 22 launched no {k}")
    for k, n in launches_22.items():
        launches_nn[k] = launches_nn.get(k, 0) + n

    record["total_s"] = time.perf_counter() - t_start
    close_phase(time.perf_counter())
    record["phase_s"] = PHASE_S
    print("seconds a phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in PHASE_S.items()))
    print(f"total {record['total_s']:.1f} s")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    line = {"kernels": [{
        "name": k, "route": "cuda",
        "source": str(kernels[k].source.relative_to(ROOT)),
        "replaces": replaces[k],
        "launches": (launches.get(k, 0) + launches_1ds.get(k, 0)
                     + launches_fast.get(k, 0) + launches_new.get(k, 0)
                     + launches_nn.get(k, 0)),
        "max_abs_err": errs[k], "ms": per[k]["ms"],
        **({"host_ms": per[k]["host_ms"]} if "host_ms" in per[k] else {}),
        "plain_ms": per[k]["plain_ms"], "bound_ms": per[k]["bound_ms"],
        "bound_by": per[k].get("bound_by", (
            "operations" if k == "rmat_counter" and rmat_by_ops
            else "bytes")),
        "library_ms": (per[k]["library_ms"] if k.startswith("spmsv")
                       or k in launches_nn else None),
    } for k in kernels]}
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
