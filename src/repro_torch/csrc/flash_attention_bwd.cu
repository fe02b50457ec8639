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
// needs S, dP, dV, dQ and dK: 10 dh flops; this kernel recomputes S three
// times and dP twice (below), 16 dh.  Kernel 9's forward returns no
// log-sum-exp, so it is recomputed here rather than changing the forward.
//
// Three passes on the stream, each a grid of 256-thread blocks over 64 x 64
// tiles held in shared memory in float32 (rows padded to dh + 4 floats, so
// that 16-byte loads of 8 rows hit 8 distinct bank groups), the products
// on the CUDA cores: a thread owns a 4 x 4 piece of each score tile
// (rows ty + 16 i, columns tx + 16 j; a row's 16 owners are 16 lanes of one
// warp, whose max and sum go through four shuffles) and dh / 16 rows of
// 4 columns of each 64 x dh accumulator.
//   1. lse_kernel, per (batch, query head, query tile): each query row's
//      base-2 log-sum-exp of its scaled scores (+inf for a row that no key
//      reaches) and delta = rowsum(dO * O).
//   2. dkdv_kernel, per (batch, kv head, key tile): the key and value tiles
//      stay in shared memory while the block walks the live query tiles of
//      its Hq / Hkv query heads in a fixed order (head, then tile),
//      recomputes P^T and dS^T and accumulates dK and dV in registers.
//   3. dq_kernel, per (batch, query head, query tile): walks the live key
//      tiles, recomputes P and dS, accumulates dQ.
// No atomics: every output element is summed by one thread in a fixed
// order, so the result is deterministic.  Tiles are skipped as the forward
// skips them (ops.live_keys): keys past the causal frontier and before the
// window's lower edge.  Head dims 16, 32, 64 and 128 are built; the
// wrapper zero-pads any other dh up to 128 to the next of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  float* delta;   // (B, Hq, Sq) rowsum(dO * O)
  int B, Sq, Sk, Hq, Hkv, rep, q_offset, window, causal;
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

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
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

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DH>
int run(const BwdArgs& a, cudaStream_t st) {
  constexpr int LD = Dims<DH>::LD;
  const int lse_smem = 2 * kTile * LD * 4;
  const int dq_smem = (4 * kTile * LD + kTile * kLdP + 2 * kTile) * 4;
  const int dkdv_smem = (4 * kTile * LD + 2 * kTile * kLdP + 2 * kTile) * 4;
  int err;
  if ((err = set_smem(lse_kernel<T, DH>, lse_smem)) ||
      (err = set_smem(dq_kernel<T, DH>, dq_smem)) ||
      (err = set_smem(dkdv_kernel<T, DH>, dkdv_smem)))
    return err;
  const unsigned n_qt = (a.Sq + kTile - 1) / kTile;
  const unsigned n_kt = (a.Sk + kTile - 1) / kTile;
  lse_kernel<T, DH><<<dim3(n_qt, a.Hq, a.B), kThreads, lse_smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_kernel<T, DH><<<dim3(n_kt, a.Hkv, a.B), kThreads, dkdv_smem, st>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<T, DH><<<dim3(n_qt, a.Hq, a.B), kThreads, dq_smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, int dh, cudaStream_t st) {
  switch (dh) {
    case 16: return run<T, 16>(a, st);
    case 32: return run<T, 32>(a, st);
    case 64: return run<T, 64>(a, st);
    case 128: return run<T, 128>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a: 21 values as int64, packed by the wrapper
// (kernels/flash_attention/ops.py::launch_backward): q, k, v, o, dout, dq,
// dk, dv, lse, delta (float32 scratch of B * Hq * Sq each), B, Sq, Sk, Hq,
// Hkv, dh (16, 32, 64 or 128), q_offset, window (0 for none), causal,
// bf16, stream.  Every tensor is contiguous (B, S, H, dh), 16-byte aligned
// (float32) or 8-byte aligned (bf16).  scale: dh^-0.5 of the real head dim.
extern "C" int flash_attention_bwd(const long long* a, float scale) {
  BwdArgs x;
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
  x.B = (int)a[10];
  x.Sq = (int)a[11];
  x.Sk = (int)a[12];
  x.Hq = (int)a[13];
  x.Hkv = (int)a[14];
  const int dh = (int)a[15];
  x.q_offset = (int)a[16];
  x.window = (int)a[17];
  x.causal = (int)a[18];
  const int bf16 = (int)a[19];
  const auto st = (cudaStream_t)a[20];
  if (x.B < 1 || x.Sq < 1 || x.Sk < 1 || x.Hkv < 1 || x.Hq % x.Hkv ||
      x.Hq > 65535 || x.B > 65535 || x.q_offset < 0 || x.window < 0)
    return (int)cudaErrorInvalidValue;
  x.rep = x.Hq / x.Hkv;
  x.scale = scale;
  x.c2 = scale * kLog2e;
  return bf16 ? dispatch<__nv_bfloat16>(x, dh, st) : dispatch<float>(x, dh, st);
}
