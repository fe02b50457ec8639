// The gradient of kernel 9's attention (causal mask, sliding window, query
// offset, grouped-query heads): given q (B, Sq, Hq, dh), k and v
// (B, Sk, Hkv, dh), the forward's output o and its gradient dout (both
// (B, Sq, Hq, dh)), dq, dk and dv.  With P = softmax(scale Q K^T) under
// the masks,
//   dV = P^T dO,  dS = P * (dO V^T - rowsum(dO * O)),
//   dQ = scale dS K,  dK = scale dS^T Q,
// a kv head's dK and dV summed over the Hq / Hkv query heads that read it.
//
// Replaces no TPU kernel of its own: the JAX package differentiates
// chunked_attention with XLA (src/repro/models/common.py:64, under
// jax.value_and_grad of lm_loss), the function that the forward Pallas
// kernel src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel (pl.pallas_call at :79) computes; the port's
// forward is a hand-written kernel (csrc/flash_attention.cu), so its
// gradient is one too.
//
// Bound on the card: operations.  Per live (query, key) pair the gradient
// needs S, dP, dV, dQ and dK: 10 dh flops.  Both paths take P from each
// row's base-2 log-sum-exp (lse): kernel 9's bf16 prefill stores it
// (flash_attention.cu's `lse` argument); where no caller gives one, the
// first C entry, flash_attention_bwd_lse, computes it (lse_kernel).
//
// bf16, on the tensor cores (wgmma, operands fed by TMA), three kernels:
//   1. rows_kernel, per (batch, query head, query tile): delta =
//      rowsum(dO * O) (bound by bytes: O and dO read once) and the lse,
//      packed a tile at a time (64 lse, then 64 delta; +inf and 0 past Sq)
//      so that one 512-byte bulk copy brings a tile's rows.
//   2. dkdv_wgmma, per (batch, kv head, 64-key tile), one warpgroup: TMA
//      brings the K and V tiles once; a ring of kRing stages (an mbarrier
//      each) brings the Q and dO tiles and rows of every live query tile
//      of the rep query heads, in a fixed order (head, then tile).
//      S^T = K Q^T and dP^T = V dO^T are wgmma with both operands K-major
//      in shared memory; P^T = exp2(c2 S^T - lse) and dS^T = P^T (dP^T -
//      delta) are formed in the accumulator registers and rounded to bf16
//      as the register A operand of dV += P^T dO and dK += dS^T Q, whose
//      B operands are the same dO and Q tiles read MN-major (the transpose
//      bit of the instruction: one tile serves both products).
//   3. dq_wgmma, per (batch, query head, 64-row query tile): Q, dO and the
//      rows come once, K and V through the ring over the live key tiles;
//      S and dP as above, dS in registers the A operand of dQ += dS K,
//      K read MN-major.
// That executes 14 dh flops a live pair (S and dP twice), all on the
// tensor cores.  dK, dV and dQ stay float32 in registers and are scaled
// and stored once.  A tile wholly inside the masks takes no per-element
// mask; a row that no key reaches has lse = +inf and so P = 0; ragged
// Sq and Sk rest on TMA's zero fill and the mask.
//
// float32 (no training path runs it): the three CUDA-core passes of
// 64 x 64 tiles held in shared memory in float32 (rows padded to dh + 4
// floats, so that 16-byte loads of 8 rows hit 8 distinct bank groups): a
// thread owns a 4 x 4 piece of each score tile (rows ty + 16 i, columns
// tx + 16 j; a row's 16 owners are 16 lanes of one warp, whose max and
// sum go through four shuffles) and dh / 16 rows of 4 columns of each
// 64 x dh accumulator.
//   1. lse_kernel, per (batch, query head, query tile): each query row's
//      lse (+inf for a row that no key reaches) and delta.
//   2. dkdv_kernel, per (batch, kv head, key tile): the key and value tiles
//      stay in shared memory while the block walks the live query tiles of
//      its Hq / Hkv query heads in a fixed order (head, then tile),
//      recomputes P^T and dS^T and accumulates dK and dV in registers.
//   3. dq_kernel, per (batch, query head, query tile): walks the live key
//      tiles, recomputes P and dS, accumulates dQ.
// It executes 16 dh flops a live pair (S three times, dP twice).
//
// No atomics on either path: every output element is summed by one thread
// in a fixed order, so the result is deterministic (a resumed training
// run equals the uninterrupted one bit for bit).  Tiles are skipped as the
// forward skips them (ops.live_keys): keys past the causal frontier and
// before the window's lower edge.  Head dims 16, 32, 64 and 128 are built;
// the wrapper zero-pads any other dh up to 128 to the next of them.
#include <math.h>

#include "hopper_mma.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // query rows and keys of a tile
constexpr int kLdP = 68;       // the row stride of a score tile in smem
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;     // (B, Hq, Sq) base-2 log-sum-exp of the scaled scores
  float* delta;   // (B, Hq, Sq) rowsum(dO * O), from the first pass
  float* rows;    // (B, Hq, n_qt, 2, 64) lse and delta by tile; bf16 path
  int B, Sq, Sk, Hq, Hkv, rep, q_offset, window, causal, n_qt;
  float scale, c2;   // dh^-0.5 and dh^-0.5 log2(e)
};

template <int DH>
struct Dims {
  static constexpr int LD = DH + 4;           // smem row stride, floats
  static constexpr int CG = DH / 4;           // 4-column groups a row
  static constexpr int RG = kThreads / CG;    // row groups
  static constexpr int RPT = kTile / RG;      // accumulator rows a thread
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// rows s0 .. s0 + 63 of head h of x (B, S, H, DH) into dst (64 x LD floats),
// zero past S
template <typename T, int DH>
__device__ void load_tile(float* dst, const T* x, int b, int s0, int S, int H,
                          int h) {
  constexpr int LD = Dims<DH>::LD, CG = Dims<DH>::CG;
  for (int c = threadIdx.x; c < kTile * CG; c += kThreads) {
    const int r = c / CG, d = (c % CG) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S)
      val = load4(x + (((int64_t)b * S + s0 + r) * H + h) * DH + d);
    store4(dst + r * LD + d, val);
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over two 64 x DH tiles
template <int DH>
__device__ __forceinline__ void tile_nt(const float* A, const float* B,
                                        float (&c)[4][4]) {
  constexpr int LD = Dims<DH>::LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, bb[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, bb[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, bb[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, bb[j].w, c[i][j]);
      }
  }
}

// acc[i] (row rg + RG i, columns 4 cg ..) += sum_c P[row][c] X[c][4 cg ..]
// over a 64 x 64 score tile P (row stride kLdP) and a 64 x DH tile X
template <int DH>
__device__ __forceinline__ void tile_nn(const float* P, const float* X,
                                        float4 (&acc)[Dims<DH>::RPT]) {
  constexpr int LD = Dims<DH>::LD, CG = Dims<DH>::CG, RG = Dims<DH>::RG;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      x[u] = *reinterpret_cast<const float4*>(X + (c + u) * LD + 4 * cg);
#pragma unroll
    for (int i = 0; i < Dims<DH>::RPT; ++i) {
      const float4 p =
          *reinterpret_cast<const float4*>(P + (rg + RG * i) * kLdP + c);
      const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i].x = fmaf(pp[u], x[u].x, acc[i].x);
        acc[i].y = fmaf(pp[u], x[u].y, acc[i].y);
        acc[i].z = fmaf(pp[u], x[u].z, acc[i].z);
        acc[i].w = fmaf(pp[u], x[u].w, acc[i].w);
      }
    }
  }
}

// the accumulator rows of a thread to rows s0 .. of head h of y
// (B, S, H, DH), times mul
template <typename T, int DH>
__device__ void store_acc(T* y, const float4 (&acc)[Dims<DH>::RPT], int b,
                          int s0, int S, int H, int h, float mul) {
  constexpr int CG = Dims<DH>::CG, RG = Dims<DH>::RG;
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
#pragma unroll
  for (int i = 0; i < Dims<DH>::RPT; ++i) {
    const int s = s0 + rg + RG * i;
    if (s < S)
      store4(y + (((int64_t)b * S + s) * H + h) * DH + 4 * cg,
             make_float4(acc[i].x * mul, acc[i].y * mul, acc[i].z * mul,
                         acc[i].w * mul));
  }
}

__device__ __forceinline__ bool live(const BwdArgs& a, int qi, int kj) {
  const int qpos = a.q_offset + qi;
  return qi < a.Sq && kj < a.Sk && (!a.causal || kj <= qpos) &&
         (a.window == 0 || qpos - kj < a.window);
}

// the key tiles [lo, hi) that query rows q0 .. q0 + 63 may reach
__device__ __forceinline__ void key_range(const BwdArgs& a, int q0, int& lo,
                                          int& hi) {
  const int last = min(q0 + kTile, a.Sq) - 1 + a.q_offset;
  hi = a.causal ? min(a.Sk, last + 1) : a.Sk;
  lo = a.window ? max(0, q0 + a.q_offset - a.window + 1) : 0;
  lo = lo / kTile * kTile;
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ----------------------------------------------------------------- pass 1
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) lse_kernel(const BwdArgs a) {
  constexpr int LD = Dims<DH>::LD;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * LD;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTile;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, DH>(sQ, (const T*)a.q, b, q0, a.Sq, a.Hq, h);
  int lo, hi;
  key_range(a, q0, lo, hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_tile<T, DH>(sK, (const T*)a.k, b, k0, a.Sk, a.Hkv, hk);
    __syncthreads();
    float s[4][4];
    tile_nt<DH>(sQ, sK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live(a, qi, k0 + tx + 16 * j) ? s[i][j] * a.c2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every lane shuffles: a row with no live key yet keeps l = 0
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - m_use);
      l[i] = l[i] * exp2f(m[i] - m_use) + group16_sum(sum);
      m[i] = m_new;
    }
  }
  const T* o = (const T*)a.o;
  const T* dout = (const T*)a.dout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    float part = 0.f;
    if (qi < a.Sq) {
      const int64_t base = (((int64_t)b * a.Sq + qi) * a.Hq + h) * DH;
      for (int d = 4 * tx; d < DH; d += 64) {
        const float4 x = load4(o + base + d), y = load4(dout + base + d);
        part += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    part = group16_sum(part);
    if (tx == 0 && qi < a.Sq) {
      const int64_t r = ((int64_t)b * a.Hq + h) * a.Sq + qi;
      a.lse[r] = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;
      a.delta[r] = part;
    }
  }
}

// the lse and delta of rows q0 .. q0 + 63 of (b, h) into smem (+inf and 0
// past Sq)
__device__ __forceinline__ void load_rows(const BwdArgs& a, float* sL,
                                          float* sD, int b, int h, int q0) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    const int64_t r = ((int64_t)b * a.Hq + h) * a.Sq + qi;
    sL[threadIdx.x] = qi < a.Sq ? a.lse[r] : INFINITY;
    sD[threadIdx.x] = qi < a.Sq ? a.delta[r] : 0.f;
  }
}

// ----------------------------------------------------------------- pass 2
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const BwdArgs a) {
  constexpr int LD = Dims<DH>::LD, RPT = Dims<DH>::RPT;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sO = sQ + kTile * LD;        // the dO tile
  float* sP = sO + kTile * LD;        // P^T: [key][query]
  float* sS = sP + kTile * kLdP;      // dS^T
  float* sL = sS + kTile * kLdP;
  float* sD = sL + kTile;
  const int k0 = blockIdx.x * kTile;  // most live query tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, DH>(sK, (const T*)a.k, b, k0, a.Sk, a.Hkv, hk);
  load_tile<T, DH>(sV, (const T*)a.v, b, k0, a.Sk, a.Hkv, hk);
  float4 accK[RPT], accV[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    accK[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    accV[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the query rows that reach a key of this tile: [q_lo, q_hi)
  const int k_last = min(k0 + kTile, a.Sk) - 1;
  int q_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
  int64_t q_hi = a.Sq;
  if (a.window) {
    const int64_t reach = (int64_t)k_last + a.window - a.q_offset;
    q_hi = reach < q_hi ? reach : q_hi;
  }
  q_lo = q_lo / kTile * kTile;
  for (int hh = 0; hh < a.rep; ++hh) {
    const int h = hk * a.rep + hh;
    for (int q0 = q_lo; q0 < q_hi; q0 += kTile) {
      __syncthreads();
      load_tile<T, DH>(sQ, (const T*)a.q, b, q0, a.Sq, a.Hq, h);
      load_tile<T, DH>(sO, (const T*)a.dout, b, q0, a.Sq, a.Hq, h);
      load_rows(a, sL, sD, b, h, q0);
      __syncthreads();
      float st[4][4], dpt[4][4];
      tile_nt<DH>(sK, sQ, st);     // S^T[key][query]
      tile_nt<DH>(sV, sO, dpt);    // dP^T[key][query]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float x =
              live(a, q0 + c, k0 + r) ? st[i][j] * a.c2 : -INFINITY;
          const float p = exp2f(x - sL[c]);
          sP[r * kLdP + c] = p;
          sS[r * kLdP + c] = p * (dpt[i][j] - sD[c]);
        }
      __syncthreads();
      tile_nn<DH>(sP, sO, accV);
      tile_nn<DH>(sS, sQ, accK);
    }
  }
  store_acc<T, DH>((T*)a.dk, accK, b, k0, a.Sk, a.Hkv, hk, a.scale);
  store_acc<T, DH>((T*)a.dv, accV, b, k0, a.Sk, a.Hkv, hk, 1.f);
}

// ----------------------------------------------------------------- pass 3
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdArgs a) {
  constexpr int LD = Dims<DH>::LD, RPT = Dims<DH>::RPT;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + kTile * LD;        // the dO tile
  float* sK = sO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sS = sV + kTile * LD;        // dS: [query][key]
  float* sL = sS + kTile * kLdP;
  float* sD = sL + kTile;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTile;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, DH>(sQ, (const T*)a.q, b, q0, a.Sq, a.Hq, h);
  load_tile<T, DH>(sO, (const T*)a.dout, b, q0, a.Sq, a.Hq, h);
  load_rows(a, sL, sD, b, h, q0);
  float4 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int lo, hi;
  key_range(a, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    __syncthreads();
    load_tile<T, DH>(sK, (const T*)a.k, b, k0, a.Sk, a.Hkv, hk);
    load_tile<T, DH>(sV, (const T*)a.v, b, k0, a.Sk, a.Hkv, hk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_nt<DH>(sQ, sK, s);
    tile_nt<DH>(sO, sV, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float x = live(a, q0 + r, k0 + c) ? s[i][j] * a.c2 : -INFINITY;
        const float p = exp2f(x - sL[r]);
        sS[r * kLdP + c] = p * (dp[i][j] - sD[r]);
      }
    __syncthreads();
    tile_nn<DH>(sS, sK, acc);
  }
  store_acc<T, DH>((T*)a.dq, acc, b, q0, a.Sq, a.Hq, h, a.scale);
}

// ------------------------------------------- bf16 on the tensor cores
constexpr int kT = 64;     // rows of every bf16 tile: 64 queries or keys
constexpr int kRing = 2;   // stages of the ring of streamed tiles

// The shared memory of either wgmma kernel: two resident tiles, the ring's
// two tiles a stage, the ring's rows of lse and delta, the barriers (one
// for the resident tiles, one a stage).  Tiles are bf16 panels
// (hopper_mma.cuh), aligned to the 1024-byte period of TMA's swizzle.
template <int DH>
struct Wg {
  static constexpr int kPB = Panel<DH>::kBytes;
  static constexpr int kPC = Panel<DH>::kCols;
  static constexpr int kTile = Panel<DH>::kCount * kT * kPB;
  static constexpr int kRowBytes = 2 * kT * 4;
  static constexpr int kSmem =
      1024 + (2 + 2 * kRing) * kTile + kRing * kRowBytes + 8 * (1 + kRing);
};

// rows kT * t .. of head `head` of a (B, S, H, DH) tensor map into dst,
// every panel, completing on bar
template <int DH>
__device__ __forceinline__ void load_tile_tma(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int head, int s0,
                                              int b) {
#pragma unroll
  for (int p = 0; p < Panel<DH>::kCount; ++p)
    tma_load(dst + p * kT * Wg<DH>::kPB, map, bar, p * Wg<DH>::kPC, head, s0,
             b);
}

// the packed lse and delta of query tile q0 / kT of (b, h)
__device__ __forceinline__ const float* tile_rows(const BwdArgs& a, int b,
                                                  int h, int q0) {
  return a.rows + (((int64_t)b * a.Hq + h) * a.n_qt + q0 / kT) * 2 * kT;
}

// acc (64 x N) = A B^T over DH: A and B kT-row tiles, K-major in shared
// memory (the first product overwrites acc)
template <int DH>
__device__ __forceinline__ void product_ss(float* acc, uint32_t a,
                                           uint32_t b) {
  constexpr int PB = Wg<DH>::kPB, PC = Wg<DH>::kPC;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    // 16 dims: a 32-byte step inside a panel, or the next panel
    const uint32_t off = (kk * 16 % PC) * 2 + (kk * 16 / PC) * kT * PB;
    wgmma_ss<kT>(acc, smem_desc(a + off, 16, 8 * PB, Panel<DH>::kLayout),
                 smem_desc(b + off, 16, 8 * PB, Panel<DH>::kLayout), kk > 0);
  }
}

// acc (64 x DH) += A (64 x kT, bf16 fragments) X (kT x DH, the tile at x
// read MN-major)
template <int DH>
__device__ __forceinline__ void product_rs(float* acc,
                                           const uint32_t (&frag)[kT / 16][4],
                                           uint32_t x) {
  constexpr int PB = Wg<DH>::kPB;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
    // 16 rows further; the panels kT rows apart
    wgmma_rs<DH>(acc, frag[kk],
                 smem_desc(x + kk * 16 * PB, kT * PB, 8 * PB,
                           Panel<DH>::kLayout));
}

// accumulator x (64 x kT) as bf16 A fragments: columns 16 kk .. of rows
// r0 and r0 + 8
__device__ __forceinline__ void to_frag(const float* x,
                                        uint32_t (&frag)[kT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      frag[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// rows s0 + r0 and s0 + r0 + 8 of head h of y (B, S, H, DH), the
// accumulator times mul in bf16
template <int DH>
__device__ __forceinline__ void store_wg(__nv_bfloat16* y, const float* acc,
                                         int b, int s0, int S, int H, int h,
                                         float mul) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + r0 + 8 * r;
    if (s >= S) continue;
    __nv_bfloat16* p = y + (((int64_t)b * S + s) * H + h) * DH + c0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// delta = rowsum(dO * O) and the lse of query tile blockIdx.x of (b, h),
// packed; G lanes a row, 16 bytes each
template <int DH>
__global__ void __launch_bounds__(128) rows_kernel(const BwdArgs a) {
  constexpr int G = DH / 8;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* o = (const __nv_bfloat16*)a.o;
  const __nv_bfloat16* dout = (const __nv_bfloat16*)a.dout;
  float* out = a.rows + (((int64_t)b * a.Hq + h) * a.n_qt + t) * 2 * kT;
  // kT * G is a multiple of 128: every lane of a warp takes each step
  for (int c = threadIdx.x; c < kT * G; c += 128) {
    const int r = c / G, qi = t * kT + r;
    float part = 0.f;
    if (qi < a.Sq) {
      const int64_t at =
          (((int64_t)b * a.Sq + qi) * a.Hq + h) * DH + (c % G) * 8;
      const uint4 x = *reinterpret_cast<const uint4*>(o + at);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xf = __bfloat1622float2(x2[i]);
        const float2 yf = __bfloat1622float2(y2[i]);
        part = fmaf(xf.x, yf.x, part);
        part = fmaf(xf.y, yf.y, part);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c % G == 0) {
      out[r] = qi < a.Sq ? a.lse[((int64_t)b * a.Hq + h) * a.Sq + qi]
                         : INFINITY;
      out[kT + r] = part;
    }
  }
}

// whether every (query, key) pair of the tiles at q0 and k0 is live
__device__ __forceinline__ bool inside(const BwdArgs& a, int q0, int k0) {
  return q0 + kT <= a.Sq && k0 + kT <= a.Sk &&
         (!a.causal || k0 + kT - 1 <= q0 + a.q_offset) &&
         (a.window == 0 || q0 + kT - 1 + a.q_offset - k0 < a.window);
}

template <int DH>
__global__ void __launch_bounds__(128)
    dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap omap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const BwdArgs a) {
  using L = Wg<DH>;
  constexpr int TB = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ks = (base + 1023u) & ~1023u;
  const uint32_t vs = ks + TB;
  const uint32_t ring = vs + TB;                 // stage s: Q, then dO
  const uint32_t rs = ring + 2 * kRing * TB;     // stage s: lse, delta
  const uint32_t kvbar = rs + kRing * L::kRowBytes, full = kvbar + 8;
  const float* srow = reinterpret_cast<const float*>(smem_raw + (rs - base));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kT;  // most live query tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  // the query rows that reach a key of this tile: [q_lo, q_hi)
  const int k_last = min(k0 + kT, a.Sk) - 1;
  int q_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
  int64_t q_hi = a.Sq;
  if (a.window) {
    const int64_t reach = (int64_t)k_last + a.window - a.q_offset;
    q_hi = reach < q_hi ? reach : q_hi;
  }
  q_lo = q_lo / kT * kT;
  const int nq = q_hi > q_lo ? (int)((q_hi - q_lo + kT - 1) / kT) : 0;
  const int n_iter = a.rep * nq;
  // step i: query head hk * rep + i / nq, query tile q_lo + kT (i % nq)
  auto load_step = [&](int i) {
    const int s = i % kRing, h = hk * a.rep + i / nq;
    const int q0 = q_lo + (i % nq) * kT;
    const uint32_t bar = full + 8 * s;
    mbar_expect(bar, 2 * TB + L::kRowBytes);
    load_tile_tma<DH>(ring + 2 * s * TB, &qmap, bar, h, q0, b);
    load_tile_tma<DH>(ring + (2 * s + 1) * TB, &omap, bar, h, q0, b);
    bulk_load(rs + s * L::kRowBytes, tile_rows(a, b, h, q0), L::kRowBytes,
              bar);
  };

  // this thread's rows (keys) of the tile: r0 and r0 + 8; its columns of
  // each group of 8: c0 and c0 + 1 (the wgmma accumulator layout)
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_iter > 0) {
    if (tid == 0) {
      mbar_init(kvbar);
      for (int s = 0; s < kRing; ++s) mbar_init(full + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect(kvbar, 2 * TB);
      load_tile_tma<DH>(ks, &kmap, kvbar, hk, k0, b);
      load_tile_tma<DH>(vs, &vmap, kvbar, hk, k0, b);
      for (int i = 0; i < min(kRing, n_iter); ++i) load_step(i);
    }
    mbar_wait(kvbar, 0);
  }
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kRing;
    const int q0 = q_lo + (i % nq) * kT;
    const uint32_t qs = ring + 2 * s * TB, os = qs + TB;
    mbar_wait(full + 8 * s, (i / kRing) & 1);
    // st[4j + 2i + c]: key k0 + r0 + 8i, query q0 + 8j + c0 + c
    float st[kT / 2], dpt[kT / 2];
    wgmma_fence();
    product_ss<DH>(st, ks, qs);    // S^T = K Q^T
    product_ss<DH>(dpt, vs, os);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait();
    fence_regs<kT / 2>(st);
    fence_regs<kT / 2>(dpt);
    if (!inside(a, q0, k0)) {
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + r0 + 8 * (e >> 1);
          const int qi = q0 + 8 * j + c0 + (e & 1), qpos = qi + a.q_offset;
          bool ok = qi < a.Sq && kpos < a.Sk;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          if (!ok) st[4 * j + e] = -INFINITY;
        }
    }
    const float* lse = srow + s * 2 * kT;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + c0);
      const float2 d2 =
          *reinterpret_cast<const float2*>(lse + kT + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            fast_exp2(fmaf(st[4 * j + e], a.c2, -((e & 1) ? l2.y : l2.x)));
        dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        st[4 * j + e] = p;
      }
    }
    uint32_t pf[kT / 16][4], sf[kT / 16][4];
    to_frag(st, pf);
    to_frag(dpt, sf);
    fence_regs<DH / 2>(dv);
    fence_regs<DH / 2>(dk);
    wgmma_fence();
    product_rs<DH>(dv, pf, os);   // dV += P^T dO
    product_rs<DH>(dk, sf, qs);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
    fence_regs<DH / 2>(dv);
    fence_regs<DH / 2>(dk);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + kRing < n_iter) load_step(i + kRing);
  }
  store_wg<DH>((__nv_bfloat16*)a.dk, dk, b, k0, a.Sk, a.Hkv, hk, a.scale);
  store_wg<DH>((__nv_bfloat16*)a.dv, dv, b, k0, a.Sk, a.Hkv, hk, 1.f);
}

template <int DH>
__global__ void __launch_bounds__(128)
    dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap omap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const BwdArgs a) {
  using L = Wg<DH>;
  constexpr int TB = L::kTile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t qs = (base + 1023u) & ~1023u;
  const uint32_t os = qs + TB;
  const uint32_t ring = os + TB;                 // stage s: K, then V
  const uint32_t rs = ring + 2 * kRing * TB;     // lse, delta of the tile
  const uint32_t qbar = rs + kRing * L::kRowBytes, full = qbar + 8;
  const float* srow = reinterpret_cast<const float*>(smem_raw + (rs - base));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (a.n_qt - 1 - (int)blockIdx.x) * kT;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.rep;
  // the key tiles [lo, hi) that query rows q0 .. q0 + kT - 1 may reach
  const int last = min(q0 + kT, a.Sq) - 1 + a.q_offset;
  const int hi = a.causal ? min(a.Sk, last + 1) : a.Sk;
  int lo = a.window ? max(0, q0 + a.q_offset - a.window + 1) : 0;
  lo = lo / kT * kT;
  const int n = hi > lo ? (hi - lo + kT - 1) / kT : 0;
  auto load_step = [&](int i) {
    const int s = i % kRing, k0 = lo + i * kT;
    const uint32_t bar = full + 8 * s;
    mbar_expect(bar, 2 * TB);
    load_tile_tma<DH>(ring + 2 * s * TB, &kmap, bar, hk, k0, b);
    load_tile_tma<DH>(ring + (2 * s + 1) * TB, &vmap, bar, hk, k0, b);
  };

  // this thread's rows (queries): r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (n > 0) {
    if (tid == 0) {
      mbar_init(qbar);
      for (int s = 0; s < kRing; ++s) mbar_init(full + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect(qbar, 2 * TB + L::kRowBytes);
      load_tile_tma<DH>(qs, &qmap, qbar, h, q0, b);
      load_tile_tma<DH>(os, &omap, qbar, h, q0, b);
      bulk_load(rs, tile_rows(a, b, h, q0), L::kRowBytes, qbar);
      for (int i = 0; i < min(kRing, n); ++i) load_step(i);
    }
    mbar_wait(qbar, 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse[r] = srow[r0 + 8 * r];
      delta[r] = srow[kT + r0 + 8 * r];
    }
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % kRing, k0 = lo + i * kT;
    const uint32_t kss = ring + 2 * s * TB, vss = kss + TB;
    mbar_wait(full + 8 * s, (i / kRing) & 1);
    // sc[4j + 2i + c]: query q0 + r0 + 8i, key k0 + 8j + c0 + c
    float sc[kT / 2], dp[kT / 2];
    wgmma_fence();
    product_ss<DH>(sc, qs, kss);   // S = Q K^T
    product_ss<DH>(dp, os, vss);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait();
    fence_regs<kT / 2>(sc);
    fence_regs<kT / 2>(dp);
    if (!inside(a, q0, k0)) {
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + r0 + 8 * (e >> 1), qpos = qi + a.q_offset;
          const int kpos = k0 + 8 * j + c0 + (e & 1);
          bool ok = qi < a.Sq && kpos < a.Sk;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window) ok = ok && qpos - kpos < a.window;
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(sc[4 * j + e], a.c2, -lse[e >> 1]));
        dp[4 * j + e] = p * (dp[4 * j + e] - delta[e >> 1]);
      }
    uint32_t sf[kT / 16][4];
    to_frag(dp, sf);
    fence_regs<DH / 2>(dq);
    wgmma_fence();
    product_rs<DH>(dq, sf, kss);   // dQ += dS K
    wgmma_commit();
    wgmma_wait();
    fence_regs<DH / 2>(dq);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + kRing < n) load_step(i + kRing);
  }
  store_wg<DH>((__nv_bfloat16*)a.dq, dq, b, q0, a.Sq, a.Hq, h, a.scale);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DH>
int run_lse(const BwdArgs& a, cudaStream_t st) {
  constexpr int lse_smem = 2 * kTile * Dims<DH>::LD * 4;
  int err;
  if ((err = set_smem(lse_kernel<T, DH>, lse_smem))) return err;
  const unsigned n_qt = (a.Sq + kTile - 1) / kTile;
  lse_kernel<T, DH><<<dim3(n_qt, a.Hq, a.B), kThreads, lse_smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int run_float32(const BwdArgs& a, cudaStream_t st) {
  constexpr int LD = Dims<DH>::LD;
  const int dq_smem = (4 * kTile * LD + kTile * kLdP + 2 * kTile) * 4;
  const int dkdv_smem = (4 * kTile * LD + 2 * kTile * kLdP + 2 * kTile) * 4;
  int err;
  if ((err = set_smem(dq_kernel<float, DH>, dq_smem)) ||
      (err = set_smem(dkdv_kernel<float, DH>, dkdv_smem)))
    return err;
  const unsigned n_qt = (a.Sq + kTile - 1) / kTile;
  const unsigned n_kt = (a.Sk + kTile - 1) / kTile;
  dkdv_kernel<float, DH>
      <<<dim3(n_kt, a.Hkv, a.B), kThreads, dkdv_smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<float, DH><<<dim3(n_qt, a.Hq, a.B), kThreads, dq_smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int run_wgmma(const BwdArgs& a, cudaStream_t st) {
  constexpr int smem = Wg<DH>::kSmem;
  static bool attr_set = false;
  int err;
  if (!attr_set) {
    if ((err = set_smem(dkdv_wgmma<DH>, smem)) ||
        (err = set_smem(dq_wgmma<DH>, smem)))
      return err;
    attr_set = true;
  }
  // contiguous (B, S, H, DH): element strides (batch, head, seq)
  const int64_t q_st[3] = {(int64_t)a.Sq * a.Hq * DH, DH,
                           (int64_t)a.Hq * DH};
  const int64_t k_st[3] = {(int64_t)a.Sk * a.Hkv * DH, DH,
                           (int64_t)a.Hkv * DH};
  CUtensorMap qmap, omap, kmap, vmap;
  if ((err = encode<DH>(&qmap, a.q, a.B, a.Sq, a.Hq, q_st, kT)) ||
      (err = encode<DH>(&omap, a.dout, a.B, a.Sq, a.Hq, q_st, kT)) ||
      (err = encode<DH>(&kmap, a.k, a.B, a.Sk, a.Hkv, k_st, kT)) ||
      (err = encode<DH>(&vmap, a.v, a.B, a.Sk, a.Hkv, k_st, kT)))
    return err;
  const unsigned n_kt = (a.Sk + kT - 1) / kT;
  rows_kernel<DH><<<dim3(a.n_qt, a.Hq, a.B), 128, 0, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_wgmma<DH><<<dim3(n_kt, a.Hkv, a.B), 128, smem, st>>>(qmap, omap, kmap,
                                                            vmap, a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_wgmma<DH><<<dim3(a.n_qt, a.Hq, a.B), 128, smem, st>>>(qmap, omap, kmap,
                                                           vmap, a);
  return (int)cudaGetLastError();
}

// the arguments of either C entry; false where they are out of range
bool unpack(const long long* a, float scale, BwdArgs& x, int& dh, int& bf16,
            cudaStream_t& st) {
  x.q = (const void*)a[0];
  x.k = (const void*)a[1];
  x.v = (const void*)a[2];
  x.o = (const void*)a[3];
  x.dout = (const void*)a[4];
  x.dq = (void*)a[5];
  x.dk = (void*)a[6];
  x.dv = (void*)a[7];
  x.lse = (float*)a[8];
  x.delta = (float*)a[9];
  x.rows = (float*)a[10];
  x.B = (int)a[11];
  x.Sq = (int)a[12];
  x.Sk = (int)a[13];
  x.Hq = (int)a[14];
  x.Hkv = (int)a[15];
  dh = (int)a[16];
  x.q_offset = (int)a[17];
  x.window = (int)a[18];
  x.causal = (int)a[19];
  bf16 = (int)a[20];
  st = (cudaStream_t)a[21];
  if (x.B < 1 || x.Sq < 1 || x.Sk < 1 || x.Hkv < 1 || x.Hq % x.Hkv ||
      x.Hq > 65535 || x.B > 65535 || x.q_offset < 0 || x.window < 0 ||
      (dh != 16 && dh != 32 && dh != 64 && dh != 128))
    return false;
  x.rep = x.Hq / x.Hkv;
  x.n_qt = (x.Sq + kT - 1) / kT;
  x.scale = scale;
  x.c2 = scale * kLog2e;
  return true;
}

}  // namespace

// a (both entries): 22 values as int64, packed by the wrapper
// (kernels/flash_attention/ops.py::launch_backward): q, k, v, o, dout,
// dq, dk, dv, lse (float32 B * Hq * Sq), delta (float32 B * Hq * Sq, or
// null), rows (float32 B * Hq * n_qt * 128, or null), B, Sq, Sk, Hq, Hkv,
// dh (16, 32, 64 or 128), q_offset, window (0 for none), causal, bf16,
// stream.  Every tensor is contiguous (B, S, H, dh) and 16-byte aligned.
// scale: dh^-0.5 of the real head dim.

// The first pass alone: each query row's lse and delta (lse_kernel), where
// no saved lse is given; the float32 path always runs it.
extern "C" int flash_attention_bwd_lse(const long long* a, float scale) {
  BwdArgs x;
  int dh, bf16;
  cudaStream_t st;
  if (!unpack(a, scale, x, dh, bf16, st) || !x.lse || !x.delta)
    return (int)cudaErrorInvalidValue;
#define LSE(D)                                                        \
  case D:                                                             \
    return bf16 ? run_lse<__nv_bfloat16, D>(x, st) : run_lse<float, D>(x, st);
  switch (dh) {
    LSE(16)
    LSE(32)
    LSE(64)
    LSE(128)
  }
#undef LSE
  return (int)cudaErrorInvalidValue;
}

// The gradient from the lse: float32, dkdv_kernel and dq_kernel (reading
// lse and delta); bf16, rows_kernel, dkdv_wgmma and dq_wgmma (reading lse,
// writing and reading rows).
extern "C" int flash_attention_bwd(const long long* a, float scale) {
  BwdArgs x;
  int dh, bf16;
  cudaStream_t st;
  if (!unpack(a, scale, x, dh, bf16, st) || !x.lse ||
      !(bf16 ? x.rows : x.delta))
    return (int)cudaErrorInvalidValue;
#define GRAD(D)                                                       \
  case D:                                                             \
    return bf16 ? run_wgmma<D>(x, st) : run_float32<D>(x, st);
  switch (dh) {
    GRAD(16)
    GRAD(32)
    GRAD(64)
    GRAD(128)
  }
#undef GRAD
  return (int)cudaErrorInvalidValue;
}
