// Blocked online-softmax (flash) attention with a causal mask, a sliding
// window and a query offset, over strided (batch, seq, head, dh) views:
// query head h reads kv head h / rep (grouped-query attention without
// repeating the cache).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (pl.pallas_call at :79, _kernel at :23).  As there, the keys are walked
// in tiles from the window's lower edge to the causal frontier, a tile
// outside them is skipped, and inside a tile the masks are _kernel:44-49's
// (k < Sk, k <= q under causality, q - k < window).  A row that no key
// reaches gets zeros (the jnp ref.py's answer).  The TPU kernel fed
// 128 x 128 tiles to the matrix unit with (m, l, acc) in VMEM, one grid
// step after another.  On Hopper one C call takes one of three paths:
//
// * Prefill, bf16 (rep * Sq > 16 rows): bound by operations (4 dh flops a
//   live (query, key) pair against the tensor cores' dense bf16 rate).
//   One warpgroup owns 64 query rows of one (batch, head).  TMA brings
//   the Q tile once and K and V tiles of 128 keys (64 at dh 128) through
//   a ring of two stages (an mbarrier each), straight from the strided
//   4-D views (the tensor maps are encoded per call; each view's strides
//   must be multiples of 16 bytes).  The tiles land swizzled in rows of
//   min(dh, 64) elements (32, 64 or 128 bytes), the width the wgmma
//   descriptors name.
//   S = Q K^T is wgmma m64nNk16 (N the tile's keys) with both operands
//   K-major in shared memory; the online softmax runs on S's float32
//   fragments in registers (a row's scores sit on a quad of threads: max
//   and sum go through two shuffles; exp2 on the special-function unit
//   alone); P is rounded to bf16 in registers and is the register A
//   operand of O += P V, V the MN-major B operand; O stays in float32
//   registers and is divided by l at the end.  Tiles wholly inside the
//   masks take no per-element mask.  Blocks start from the last query
//   tile, the longest under causality.  Where the caller asks (training),
//   the epilogue also stores each row's base-2 log-sum-exp m + log2(l),
//   from which kernel 9b forms P.
// * Decode and short queries, bf16 (rep * Sq <= 16 rows): bound by bytes
//   (K and V read once).  A 64-row wgmma tile would be mostly empty, and
//   a block per query head gave 36 blocks for 132 SMs.  Here a block
//   takes the rep query heads of one kv head and all Sq rows over one
//   contiguous range of keys, so each K/V row is read once, with 16-byte
//   loads, and the grid is (batch * kv heads, n_split).  Each block
//   writes float32 partials (m, l, acc) to scratch; a second kernel on
//   the stream, launched as its programmatic dependent so that its launch
//   overlaps the splits, merges them (a split whose keys are all masked
//   carries m = -inf and weight 0).  The wrapper picks n_split
//   (ops.py::plan) and allocates the scratch.
// * float32 (no serving path; the tests and the sweep): the CUDA cores,
//   64 thread groups a block, each holding 16 dims of one query row; a
//   short query tile splits each row's keys over 64 / bq groups, merged
//   through shared memory.
//
// q_offset and the window are launch arguments, so decode reuses one
// build at every position.
#include <math.h>

#include "hopper_mma.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

// ------------------------------------------------------------ float32

constexpr int kGroups = 64;   // query-row groups per block
constexpr int kDims = 16;     // dims of q and acc per thread
constexpr int kChunk = 8;     // keys scored per online-softmax update

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t st[12];  // strides in elements: (batch, head, seq) of q, k, v, o
  int hq, rep, sq, sk, q_offset, window, causal, bq;  // window <= 0: none
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(kGroups * DH / kDims)
    float32_kernel(const Args a) {
  constexpr int TPG = DH / kDims;       // threads per group
  constexpr int BK = 4096 / DH;         // keys per shared tile
  constexpr int TILE = BK * DH;
  constexpr int MERGE = kGroups * (DH + 2);
  constexpr int SMEM = 2 * TILE > MERGE ? 2 * TILE : MERGE;
  __shared__ __align__(16) float smem[SMEM];
  float* ks = smem;
  float* vs = smem + TILE;

  const int tid = threadIdx.x;
  const int g = tid / TPG, t = tid % TPG;
  const int bq = a.bq, nsplit = kGroups / bq;
  const int r = g % bq, split = g / bq;
  const int bh = blockIdx.x;
  const int b = bh / a.hq, h = bh % a.hq, hk = h / a.rep;
  const int row = blockIdx.y * bq + r;
  const bool live = row < a.sq;
  const int q0 = a.q_offset + blockIdx.y * bq;
  const int qpos = a.q_offset + row;
  const float* qp = (const float*)a.q + b * a.st[0] + h * a.st[1];
  const float* kp = (const float*)a.k + b * a.st[3] + hk * a.st[4];
  const float* vp = (const float*)a.v + b * a.st[6] + hk * a.st[7];
  float* op = (float*)a.o + b * a.st[9] + h * a.st[10];
  const unsigned lane = tid & 31;
  const unsigned gmask =
      TPG == 32 ? 0xffffffffu : ((1u << TPG) - 1u) << (lane & ~(TPG - 1));

  float q[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    q[i] = live ? qp[row * a.st[2] + t * kDims + i] * a.scale : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  const int hi = a.causal ? min(a.sk, q0 + bq) : a.sk;
  const int lo = a.window > 0 ? max(0, q0 - (a.window - 1)) : 0;
  const int lo_blk = lo / BK, hi_blk = (hi + BK - 1) / BK;
  for (int kb = lo_blk; kb < hi_blk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    for (int i = tid; i < TILE; i += blockDim.x) {
      const int j = i / DH, d = i % DH, kpos = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kpos < a.sk) {
        kx = kp[kpos * a.st[5] + d];
        vx = vp[kpos * a.st[8] + d];
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    // this group's keys of the tile: split, split + nsplit, ...
    for (int j0 = split; j0 < BK; j0 += kChunk * nsplit) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c * nsplit, kpos = k0 + j;
        float part = 0.0f;
        if (j < BK) {
          const float* kr = ks + j * DH + t * kDims;
#pragma unroll
          for (int i = 0; i < kDims; ++i) part = fmaf(q[i], kr[i], part);
        }
#pragma unroll
        for (int off = TPG / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(gmask, part, off);
        bool ok = live && j < BK && kpos < a.sk;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && qpos - kpos < a.window;
        s[c] = ok ? part : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      if (cmax == -INFINITY) continue;  // the same in the whole group
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (s[c] == -INFINITY) continue;
        const float p = expf(s[c] - m_new);
        l += p;
        const float* vr = vs + (j0 + c * nsplit) * DH + t * kDims;
#pragma unroll
        for (int i = 0; i < kDims; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
      m = m_new;
    }
  }

  if (nsplit == 1) {
    if (live) {
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        op[row * a.st[11] + t * kDims + i] = acc[i] / den;
    }
    return;
  }
  // merge the nsplit partial states of each row
  __syncthreads();
  float* mm = smem;
  float* ll = smem + kGroups;
  float* aa = smem + 2 * kGroups;
  if (t == 0) {
    mm[g] = m;
    ll[g] = l;
  }
#pragma unroll
  for (int i = 0; i < kDims; ++i) aa[g * DH + t * kDims + i] = acc[i];
  __syncthreads();
  for (int e = tid; e < bq * DH; e += blockDim.x) {
    const int rr = e / DH, d = e % DH, orow = blockIdx.y * bq + rr;
    if (orow >= a.sq) continue;
    float mx = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, mm[sp * bq + rr]);
    float lsum = 0.0f, asum = 0.0f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < nsplit; ++sp) {
        const int gg = sp * bq + rr;
        const float f = expf(mm[gg] - mx);
        lsum += ll[gg] * f;
        asum += aa[gg * DH + d] * f;
      }
    }
    op[orow * a.st[11] + d] = asum / fmaxf(lsum, 1e-30f);
  }
}


// ------------------------------------------------- bf16 prefill (wgmma)
constexpr int kRows = 64;     // query rows of a block: one warpgroup
constexpr int kStages = 2;    // K/V tiles in flight (3 and 4 measured
                              // slower: fewer blocks fit an SM)

struct PrefillArgs {
  __nv_bfloat16* o;
  float* lse;       // (batch, hq, sq) or null: each row's log-sum-exp
  int64_t o_st[3];  // (batch, head, seq) strides of o in elements
  int hq, rep, sq, sk, q_offset, window, causal;
  float scale_log2;  // dh^-0.5 * log2(e): the scores in base 2
};

// The shared-memory layout of a dh: Q, K and V tiles in the panels of
// hopper_mma.cuh.
template <int DH>
struct Tiles {
  static constexpr int kPanelCols = Panel<DH>::kCols;
  static constexpr int kPanelBytes = Panel<DH>::kBytes;
  static constexpr int kPanels = Panel<DH>::kCount;
  static constexpr int kQBytes = kPanels * kRows * kPanelBytes;
  // keys of a K/V tile: 128 where the registers allow (128 keys
  // measured 1-10% faster at dh 64; tools/flash_attention_ab.py)
  static constexpr int kKeys = DH <= 64 ? 128 : 64;
  static constexpr int kKVBytes = kPanels * kKeys * kPanelBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static constexpr uint64_t kLayout = Panel<DH>::kLayout;
};

// K and V tile i (keys k0..k0 + 63 of kv head hk) into stage i % kStages
template <int DH>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t ks,
                                        uint32_t vs, uint32_t kbar,
                                        uint32_t vbar, int i, int k0, int hk,
                                        int b) {
  using L = Tiles<DH>;
  const int s = i % kStages;
  mbar_expect(kbar + 8 * s, L::kKVBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(ks + s * L::kKVBytes + p * L::kKeys * L::kPanelBytes, kmap,
             kbar + 8 * s, p * L::kPanelCols, hk, k0, b);
  mbar_expect(vbar + 8 * s, L::kKVBytes);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(vs + s * L::kKVBytes + p * L::kKeys * L::kPanelBytes, vmap,
             vbar + 8 * s, p * L::kPanelCols, hk, k0, b);
}

template <int DH>
__global__ void __launch_bounds__(128)
    prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const PrefillArgs a) {
  using L = Tiles<DH>;
  constexpr int PB = L::kPanelBytes, PC = L::kPanelCols, kKeys = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + L::kQBytes;
  const uint32_t vs = ks + kStages * L::kKVBytes;
  const uint32_t qbar = vs + kStages * L::kKVBytes;
  const uint32_t kbar = qbar + 8, vbar = kbar + 8 * kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / a.hq, h = bh % a.hq, hk = h / a.rep;
  const int rows = min(kRows, a.sq - q0);
  const int qlo = a.q_offset + q0, qhi = qlo + rows - 1;  // live rows
  const int hi = a.causal ? min(a.sk, qhi + 1) : a.sk;
  const int lo = a.window > 0 ? max(0, qlo - (a.window - 1)) : 0;
  const int t0 = lo / kKeys;
  const int n_tiles = hi > lo ? (hi + kKeys - 1) / kKeys - t0 : 0;

  if (tid == 0) {
    mbar_init(qbar);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kbar + 8 * s);
      mbar_init(vbar + 8 * s);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(qbar, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(qs + p * kRows * PB, &qmap, qbar, p * PC, h, q0, b);
    for (int i = 0; i < min(kStages, n_tiles); ++i)
      load_kv<DH>(&kmap, &vmap, ks, vs, kbar, vbar, i, (t0 + i) * kKeys, hk,
                  b);
  }

  // this thread's rows of the tile: r0 and r0 + 8; its columns of each
  // group of 8: c0 and c0 + 1 (the wgmma accumulator layout)
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, k0 = (t0 + i) * kKeys;
    const uint32_t parity = (i / kStages) & 1;
    mbar_wait(kbar + 8 * s, parity);
    float sc[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // 16 dims: a 32-byte step inside a panel, or the next panel
      const uint32_t off = (kk * 16 % PC) * 2;
      const uint32_t pq = (kk * 16 / PC) * kRows * PB;
      const uint32_t pk = (kk * 16 / PC) * kKeys * PB;
      wgmma_ss<kKeys>(sc, smem_desc(qs + pq + off, 16, 8 * PB, L::kLayout),
                   smem_desc(ks + s * L::kKVBytes + pk + off, 16, 8 * PB,
                             L::kLayout),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs<kKeys / 2>(sc);

    // sc[4j + 2i + c]: row r0 + 8i, key k0 + 8j + c0 + c
    const bool edge = k0 + kKeys > a.sk ||
                      (a.causal && k0 + kKeys - 1 > qlo) ||
                      (a.window > 0 && qhi - k0 >= a.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qlo + r0 + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          bool ok = kpos < a.sk;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && qpos - kpos < a.window;
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * a.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = fast_exp2(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * j + 2 * r + c];
          x = fast_exp2(fmaf(x, a.scale_log2, -m_use));
          sum += x;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 2 * r] *= corr;
        o[4 * j + 2 * r + 1] *= corr;
      }
    }
    // P in bf16 as wgmma's A fragments: keys 16kk.. of rows r0, r0 + 8
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

    mbar_wait(vbar + 8 * s, parity);
    fence_regs<DH / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      // 16 keys: 16 rows of the panels further; the panels DH / 64 apart
      wgmma_rs<DH>(o, pa[kk],
                   smem_desc(vs + s * L::kKVBytes + kk * 16 * PB,
                             kKeys * PB, 8 * PB, L::kLayout));
    wgmma_commit();
    wgmma_wait();
    fence_regs<DH / 2>(o);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + kStages < n_tiles)
      load_kv<DH>(&kmap, &vmap, ks, vs, kbar, vbar, i + kStages,
                  k0 + kStages * kKeys, hk, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.0f ? 1.0f / sum : 0.0f;
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    // the row's base-2 log-sum-exp of its scaled scores, for kernel 9b
    if (a.lse != nullptr && (lane & 3) == 0)
      a.lse[((int64_t)b * a.hq + h) * a.sq + q0 + row] =
          sum > 0.0f ? m[r] + log2f(sum) : INFINITY;
    __nv_bfloat16* op =
        a.o + b * a.o_st[0] + h * a.o_st[1] + (q0 + row) * a.o_st[2] + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// ------------------------------------------- bf16 decode (key splits)
constexpr int kSplitRows = 16;  // the most rows (rep * Sq) a block takes
constexpr int kSplitKeys = 64;  // keys of a shared tile

struct SplitArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* part;     // (batch * kv heads, n_split, rep * Sq, dh + 2): acc, m, l
  int64_t st[12];  // strides in elements: (batch, head, seq) of q, k, v, o
  int hkv, rep, sq, q_offset, window, causal;
  int lo, hi, span, n_split;  // split s takes keys [lo + s span, ..) < hi
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(128) split_kernel(const SplitArgs a) {
  constexpr int G = DH / 8;       // lanes per key row, 16 bytes each
  constexpr int KPW = 32 / G;     // key rows a warp scores at once
  constexpr int NACC = kSplitRows * DH / 128;
  constexpr int LOADS = kSplitKeys * G / 128;  // 16-byte loads a thread
  __shared__ __align__(16) float qs[kSplitRows][DH];
  __shared__ __align__(16) __nv_bfloat16 ks[kSplitKeys][DH];
  __shared__ __align__(16) __nv_bfloat16 vs[kSplitKeys][DH];
  __shared__ float ps[kSplitRows][kSplitKeys];
  __shared__ float ms[kSplitRows], ls[kSplitRows], cs[kSplitRows];

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / a.hkv, hk = bk % a.hkv;
  const int nr = a.rep * a.sq;  // row r: head hk * rep + r / Sq, query r % Sq
  const int k_begin = a.lo + split * a.span;
  const int k_end = min(a.hi, k_begin + a.span);
  const __nv_bfloat16* kp = a.k + b * a.st[3] + hk * a.st[4];
  const __nv_bfloat16* vp = a.v + b * a.st[6] + hk * a.st[7];

  if (tid < nr) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  float acc[NACC], qv[NACC];  // element tid + 128 i of the (rows, DH) tile
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + 128 * i, r = e / DH;
    acc[i] = 0.0f;
    qv[i] = r < nr ? __bfloat162float(
                         a.q[b * a.st[0] + (hk * a.rep + r / a.sq) * a.st[1] +
                             (r % a.sq) * a.st[2] + e % DH]) *
                         a.scale
                   : 0.0f;
  }

  for (int kt = k_begin; kt < k_end; kt += kSplitKeys) {
    __syncthreads();
    uint4 kx[LOADS], vx[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + 128 * i, j = c / G, t = c % G, kpos = kt + j;
      kx[i] = vx[i] = make_uint4(0, 0, 0, 0);
      if (kpos < k_end) {
        kx[i] = *reinterpret_cast<const uint4*>(kp + kpos * a.st[5] + 8 * t);
        vx[i] = *reinterpret_cast<const uint4*>(vp + kpos * a.st[8] + 8 * t);
      }
    }
    if (kt == k_begin) {  // q's loads went out with the first tile's
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int e = tid + 128 * i;
        if (e < nr * DH) qs[e / DH][e % DH] = qv[i];
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + 128 * i, j = c / G, t = c % G;
      *reinterpret_cast<uint4*>(&ks[j][8 * t]) = kx[i];
      *reinterpret_cast<uint4*>(&vs[j][8 * t]) = vx[i];
    }
    __syncthreads();
    // scores: G lanes a key row, 8 dims each, summed by shuffles
    for (int j0 = warp * KPW; j0 < kSplitKeys; j0 += 4 * KPW) {
      const int j = j0 + lane / G, t = lane % G, kpos = kt + j;
      const uint4 raw = *reinterpret_cast<const uint4*>(&ks[j][8 * t]);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(k2[i]);
        kf[2 * i] = f.x;
        kf[2 * i + 1] = f.y;
      }
      for (int r = 0; r < nr; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qs[r][8 * t + i], kf[i], part);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (t == 0) {
          const int qpos = a.q_offset + r % a.sq;
          bool ok = kpos < k_end;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && qpos - kpos < a.window;
          ps[r][j] = ok ? part : -INFINITY;
        }
      }
    }
    __syncthreads();
    // the online softmax of each row: a warp a row, two keys a lane
    for (int r = warp; r < nr; r += 4) {
      const float s0 = ps[r][lane], s1 = ps[r][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r], m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      ps[r][lane] = p0;
      ps[r][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_use);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + 128 * i, r = e / DH, d = e % DH;
      if (r < nr) {
        float x = acc[i] * cs[r];
#pragma unroll 8
        for (int j = 0; j < kSplitKeys; ++j)
          x = fmaf(ps[r][j], __bfloat162float(vs[j][d]), x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();
  float* out = a.part + ((int64_t)bk * a.n_split + split) * nr * (DH + 2);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + 128 * i, r = e / DH, d = e % DH;
    if (r < nr) out[r * (DH + 2) + d] = acc[i];
  }
  if (tid < nr) {
    out[tid * (DH + 2) + DH] = ms[tid];
    out[tid * (DH + 2) + DH + 1] = ls[tid];
  }
}

// The splits' partials merged into one output row of one (batch, kv
// head): a block a row, a thread a dim, the splits taken 16 at a time
// (their loads in flight together) into a running (max, l, acc).
// Launched as a programmatic dependent of split_kernel, so its launch
// overlaps the splits' and it waits for their writes here.
template <int DH>
__global__ void __launch_bounds__(DH) merge_kernel(const SplitArgs a) {
  constexpr int kBatch = 16;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bk = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int b = bk / a.hkv, hk = bk % a.hkv, nr = a.rep * a.sq;
  const float* part =
      a.part + ((int64_t)bk * a.n_split * nr + r) * (DH + 2);
  const int step = nr * (DH + 2);  // from one split's row to the next's
  float mx = -INFINITY, lsum = 0.0f, x = 0.0f;
  for (int s0 = 0; s0 < a.n_split; s0 += kBatch) {
    float mv[kBatch], lv[kBatch], av[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float* p = part + (s0 + j) * step;
      const bool in = s0 + j < a.n_split;
      mv[j] = in ? p[DH] : -INFINITY;
      lv[j] = in ? p[DH + 1] : 0.0f;
      av[j] = in ? p[d] : 0.0f;
    }
    float m_new = mx;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) m_new = fmaxf(m_new, mv[j]);
    if (m_new == -INFINITY) continue;  // no split so far reached a key
    const float c = expf(mx - m_new);
    lsum *= c;
    x *= c;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float f = expf(mv[j] - m_new);  // 0 for a split with no key
      lsum = fmaf(lv[j], f, lsum);
      x = fmaf(av[j], f, x);
    }
    mx = m_new;
  }
  a.o[b * a.st[9] + (hk * a.rep + r / a.sq) * a.st[10] +
      (r % a.sq) * a.st[11] + d] =
      __float2bfloat16_rn(lsum > 0.0f ? x / lsum : 0.0f);
}

// ------------------------------------------- any head dim past 128 (wide)
// One block of kWideThreads a (batch, query head, query tile of bq rows),
// the head dim a runtime argument.  The q tile (scaled) and the running
// output accumulator sit in shared memory in float32, rows padded to
// wide_ld(dh) floats (a multiple of 32 plus 4, so that the 16-byte loads
// of 8 rows fall in 8 distinct bank groups); K and V stream through
// shared memory in tiles of bk keys, converted to float32.  Per tile:
// scores as dot products over dh (ts threads a (row, key) pair, summed
// by shuffles), the masks, the online softmax (a warp a row), then
// acc = acc * corr + P V (a thread a row and 4 columns).  q, k, v may be
// float32 or bf16; every sum is float32.  The wrapper picks bq and bk
// (ops.py::wide_tiles) so that the layout fits the 227 KB a block may
// have.
constexpr int kWideThreads = 256;
constexpr int kWideSmemMax = 232448;

struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t st[12];  // strides in elements: (batch, head, seq) of q, k, v, o
  int hq, rep, sq, sk, dh, q_offset, window, causal, bq, bk;
  float scale;
};

__host__ __device__ inline int wide_ld(int dh) { return (dh + 31) / 32 * 32 + 4; }

// bytes: q and acc (bq rows), K and V (bk rows), P (bq x bk), m, l, corr
__host__ __device__ inline int64_t wide_smem(int dh, int bq, int bk) {
  return 4ll * ((int64_t)wide_ld(dh) * (2 * bq + 2 * bk) + bq * bk + 3 * bq);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads) wide_kernel(const WideArgs a) {
  extern __shared__ __align__(16) float wsm[];
  const int ld = wide_ld(a.dh), dv = (a.dh + 3) / 4, dpad = 4 * dv;
  const int bq = a.bq, bk = a.bk;
  float* qs = wsm;            // [bq][ld]
  float* acc = qs + bq * ld;  // [bq][ld]
  float* ks = acc + bq * ld;  // [bk][ld]
  float* vs = ks + bk * ld;   // [bk][ld]
  float* ps = vs + bk * ld;   // [bq][bk]: scores, then P
  float* ms = ps + bq * bk;   // [bq]
  float* ls = ms + bq;        // [bq]
  float* cs = ls + bq;        // [bq]
  constexpr int kWarps = kWideThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.hq, h = bh % a.hq, hk = h / a.rep;
  const int row0 = blockIdx.y * bq, q0 = a.q_offset + row0;
  const T* qp = (const T*)a.q + b * a.st[0] + h * a.st[1];
  const T* kp = (const T*)a.k + b * a.st[3] + hk * a.st[4];
  const T* vp = (const T*)a.v + b * a.st[6] + hk * a.st[7];
  T* op = (T*)a.o + b * a.st[9] + h * a.st[10];

  // a warp a row, its lanes along dh; columns dh..dpad-1 are zeros
  for (int r = warp; r < bq; r += kWarps) {
    const int row = row0 + r;
    for (int d = lane; d < dpad; d += 32) {
      qs[r * ld + d] = row < a.sq && d < a.dh
                           ? to_f32(qp[row * a.st[2] + d]) * a.scale
                           : 0.0f;
      acc[r * ld + d] = 0.0f;
    }
  }
  if (tid < bq) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  // threads a score: bq * bk * ts is a multiple of the block (both tiles
  // are powers of two, bk >= 8), so every lane of a warp shuffles
  const int pairs = bq * bk;
  const int ts = pairs >= kWideThreads ? 1 : min(32, kWideThreads / pairs);
  const int hi = a.causal ? min(a.sk, q0 + bq) : a.sk;
  const int lo = a.window > 0 ? max(0, q0 - (a.window - 1)) : 0;
  for (int k0 = lo / bk * bk; k0 < hi; k0 += bk) {
    __syncthreads();  // the last tile's P V is done with ks, vs, ps
    for (int j = warp; j < bk; j += kWarps) {
      const int kpos = k0 + j;
      for (int d = lane; d < dpad; d += 32) {
        const bool in = kpos < a.sk && d < a.dh;
        ks[j * ld + d] = in ? to_f32(kp[kpos * a.st[5] + d]) : 0.0f;
        vs[j * ld + d] = in ? to_f32(vp[kpos * a.st[8] + d]) : 0.0f;
      }
    }
    __syncthreads();
    for (int e = tid; e < pairs * ts; e += kWideThreads) {
      const int pr = e / ts, sub = e % ts, r = pr / bk, j = pr % bk;
      const float4* q4 = reinterpret_cast<const float4*>(qs + r * ld);
      const float4* k4 = reinterpret_cast<const float4*>(ks + j * ld);
      float part = 0.0f;
      for (int c = sub; c < dv; c += ts) {
        const float4 x = q4[c], y = k4[c];
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
      for (int off = ts / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (sub == 0) {
        const int qpos = q0 + r, kpos = k0 + j;
        bool ok = row0 + r < a.sq && kpos < a.sk;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && qpos - kpos < a.window;
        ps[r * bk + j] = ok ? part : -INFINITY;
      }
    }
    __syncthreads();
    for (int r = warp; r < bq; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, ps[r * bk + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        const float sc = ps[r * bk + j];
        const float pv = sc == -INFINITY ? 0.0f : expf(sc - m_new);
        ps[r * bk + j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        // no key of this row so far: nothing to rescale
        const float c = m_new == -INFINITY ? 1.0f : expf(m_old - m_new);
        cs[r] = c;
        ls[r] = ls[r] * c + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < bq * dv; e += kWideThreads) {
      const int r = e / dv, c4 = e % dv;
      float4* a4 = reinterpret_cast<float4*>(acc + r * ld) + c4;
      float4 x = *a4;
      const float c = cs[r];
      x.x *= c;
      x.y *= c;
      x.z *= c;
      x.w *= c;
      const float* pr = ps + r * bk;
      for (int j = 0; j < bk; ++j) {
        const float pv = pr[j];
        const float4 y = reinterpret_cast<const float4*>(vs + j * ld)[c4];
        x.x = fmaf(pv, y.x, x.x);
        x.y = fmaf(pv, y.y, x.y);
        x.z = fmaf(pv, y.z, x.z);
        x.w = fmaf(pv, y.w, x.w);
      }
      *a4 = x;
    }
  }
  __syncthreads();
  for (int r = warp; r < bq; r += kWarps) {
    const int row = row0 + r;
    if (row >= a.sq) continue;
    const float l = ls[r];
    for (int d = lane; d < a.dh; d += 32)
      store_f32(op + row * a.st[11] + d, l > 0.0f ? acc[r * ld + d] / l : 0.0f);
  }
}

// ------------------------------------------------------------- host

template <int DH>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int64_t* st, int batch, int hq, int rep,
                   int sq, int sk, int q_offset, int window, int causal,
                   float scale, cudaStream_t stream) {
  using L = Tiles<DH>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap qmap, kmap, vmap;
  const int hkv = hq / rep;
  int err = encode<DH>(&qmap, q, batch, sq, hq, st, kRows);
  if (!err) err = encode<DH>(&kmap, k, batch, sk, hkv, st + 3, L::kKeys);
  if (!err) err = encode<DH>(&vmap, v, batch, sk, hkv, st + 6, L::kKeys);
  if (err) return err;
  PrefillArgs a;
  a.o = (__nv_bfloat16*)o;
  a.lse = lse;
  for (int i = 0; i < 3; ++i) a.o_st[i] = st[9 + i];
  a.hq = hq;
  a.rep = rep;
  a.sq = sq;
  a.sk = sk;
  a.q_offset = q_offset;
  a.window = window;
  a.causal = causal;
  a.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((sq + kRows - 1) / kRows, batch * hq);
  prefill_kernel<DH><<<grid, 128, L::kSmem, stream>>>(qmap, kmap, vmap, a);
  return 0;
}

template <int DH>
int launch_split(const SplitArgs& a, int batch, cudaStream_t stream) {
  split_kernel<DH><<<dim3(batch * a.hkv, a.n_split), 128, 0, stream>>>(a);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * a.hkv, a.rep * a.sq);
  cfg.blockDim = dim3(DH);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<DH>, a);
}

template <int DH>
void launch_cuda_cores(const Args& a, int n_bh, cudaStream_t stream) {
  const dim3 grid(n_bh, (a.sq + a.bq - 1) / a.bq);
  float32_kernel<DH><<<grid, kGroups * DH / kDims, 0, stream>>>(a);
}

template <typename T>
int launch_wide(const WideArgs& a, int batch, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWideSmemMax);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int64_t smem = wide_smem(a.dh, a.bq, a.bk);
  if (smem > kWideSmemMax) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * a.hq, (a.sq + a.bq - 1) / a.bq);
  wide_kernel<T><<<grid, kWideThreads, (size_t)smem, stream>>>(a);
  return 0;
}

}  // namespace

// path 0: float32 on the CUDA cores (bq rows a query tile); 1: bf16
// prefill on the tensor cores; 2: bf16 key splits (n_split blocks a kv
// head, split s over keys [lo + s span, ..) < hi, partials in `part`);
// 3: any dh (the wide kernel; float32, or bf16 where `bf16`), query
// tiles of bq rows and key tiles of bk, both powers of two, bk >= 8.
// Paths 0-2 take dh 16, 32, 64 or 128.  `lse`, where not null, takes
// path 1's (batch, hq, sq) float32 base-2 log-sum-exp of each row's
// scaled scores (+inf for a row that no key reaches), which kernel 9b
// reads; the other paths write none.  One call launches the path's
// kernels on `stream`.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* part, void* lse,
                               const long long* strides,
                               int batch, int hq, int rep, int sq, int sk,
                               int dh, int q_offset, int window, int causal,
                               int path, int bq, int n_split, int lo, int hi,
                               int span, int bf16, int bk, float scale,
                               void* stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int64_t st[12];
  for (int i = 0; i < 12; ++i) st[i] = strides[i];
  int err = 0;
  if (path == 0) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    for (int i = 0; i < 12; ++i) a.st[i] = st[i];
    a.hq = hq;
    a.rep = rep;
    a.sq = sq;
    a.sk = sk;
    a.q_offset = q_offset;
    a.window = window;
    a.causal = causal;
    a.bq = bq;
    a.scale = scale;
    switch (dh) {
      case 16: launch_cuda_cores<16>(a, batch * hq, s); break;
      case 32: launch_cuda_cores<32>(a, batch * hq, s); break;
      case 64: launch_cuda_cores<64>(a, batch * hq, s); break;
      case 128: launch_cuda_cores<128>(a, batch * hq, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (path == 1) {
    switch (dh) {
#define PREFILL(D)                                                      \
  case D:                                                               \
    err = launch_prefill<D>(q, k, v, o, (float*)lse, st, batch, hq, rep, \
                            sq, sk, q_offset, window, causal, scale, s); \
    break;
      PREFILL(16)
      PREFILL(32)
      PREFILL(64)
      PREFILL(128)
#undef PREFILL
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (path == 2) {
    if (rep * sq > kSplitRows) return (int)cudaErrorInvalidValue;
    SplitArgs a;
    a.q = (const __nv_bfloat16*)q;
    a.k = (const __nv_bfloat16*)k;
    a.v = (const __nv_bfloat16*)v;
    a.o = (__nv_bfloat16*)o;
    a.part = (float*)part;
    for (int i = 0; i < 12; ++i) a.st[i] = st[i];
    a.hkv = hq / rep;
    a.rep = rep;
    a.sq = sq;
    a.q_offset = q_offset;
    a.window = window;
    a.causal = causal;
    a.lo = lo;
    a.hi = hi;
    a.span = span;
    a.n_split = n_split;
    a.scale = scale;
    switch (dh) {
      case 16: err = launch_split<16>(a, batch, s); break;
      case 32: err = launch_split<32>(a, batch, s); break;
      case 64: err = launch_split<64>(a, batch, s); break;
      case 128: err = launch_split<128>(a, batch, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (path == 3) {
    if (dh < 1 || bq < 1 || bk < 8 || (bq & (bq - 1)) || (bk & (bk - 1)))
      return (int)cudaErrorInvalidValue;
    WideArgs a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    for (int i = 0; i < 12; ++i) a.st[i] = st[i];
    a.hq = hq;
    a.rep = rep;
    a.sq = sq;
    a.sk = sk;
    a.dh = dh;
    a.q_offset = q_offset;
    a.window = window;
    a.causal = causal;
    a.bq = bq;
    a.bk = bk;
    a.scale = scale;
    err = bf16 ? launch_wide<__nv_bfloat16>(a, batch, s)
               : launch_wide<float>(a, batch, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
