// Blocked online-softmax (flash) attention with a causal mask, a sliding
// window and a query offset, over strided (batch, head, seq, dh) views:
// query head h reads kv head h / rep (grouped-query attention without
// repeating the cache).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (pl.pallas_call at :79, _kernel at :23).  As there, a block owns one
// (batch*head, query tile) and walks the key tiles from the window's
// lower edge to the causal frontier min(Sk, q0 + bq), skipping every
// tile outside them, and masks inside a tile exactly as _kernel:44-49
// does (k < Sk, k <= q under causality, q - k < window).  What differs
// on Hopper: the TPU kernel fed 128x128 tiles to the matrix unit and
// kept (m, l, acc) for the tile in VMEM; here the tile of keys and
// values is staged through shared memory in float32 and the arithmetic
// runs on the CUDA cores.  The block's 64 groups of dh/16 threads each
// hold 16 dims of one query row's q and acc, score 8 keys at a time
// (partial dot products summed over the group by shuffles) and update
// the row's running (m, l, acc) once per 8 keys.  A short query tile
// (decode: Sq = 1) would leave most groups idle, so with bq rows a
// tile's keys are split over 64/bq groups per row and their (m, l, acc)
// are merged through shared memory at the end.  q_offset and the window
// are launch arguments, so decode reuses one build at every position.
// Masked keys are -inf and a row that no key reaches gets zeros (the
// jnp ref.py's answer; the Pallas kernel's finite -1e30 gives such a row
// the mean of the values it visited).
//
// Bound on the card: at the serving shapes, operations (4 dh flops per
// live (query, key) pair against the card's dense bf16 rate) for
// prefill and bytes (K and V read once) for decode.  This first kernel
// runs on the CUDA cores in float32, far below the tensor cores' rate;
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kGroups * DH / kDims)
    flash_attention_kernel(const Args a) {
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
  const T* qp = (const T*)a.q + b * a.st[0] + h * a.st[1];
  const T* kp = (const T*)a.k + b * a.st[3] + hk * a.st[4];
  const T* vp = (const T*)a.v + b * a.st[6] + hk * a.st[7];
  T* op = (T*)a.o + b * a.st[9] + h * a.st[10];
  const unsigned lane = tid & 31;
  const unsigned gmask =
      TPG == 32 ? 0xffffffffu : ((1u << TPG) - 1u) << (lane & ~(TPG - 1));

  float q[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    q[i] = live ? to_float(qp[row * a.st[2] + t * kDims + i]) * a.scale
                : 0.0f;
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
        kx = to_float(kp[kpos * a.st[5] + d]);
        vx = to_float(vp[kpos * a.st[8] + d]);
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
        store(op + row * a.st[11] + t * kDims + i, acc[i] / den);
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
    store(op + orow * a.st[11] + d, asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DH>
void launch(const Args& a, int n_bh, cudaStream_t stream) {
  const dim3 grid(n_bh, (a.sq + a.bq - 1) / a.bq);
  flash_attention_kernel<T, DH><<<grid, kGroups * DH / kDims, 0, stream>>>(a);
}

template <typename T>
int dispatch(const Args& a, int n_bh, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: launch<T, 16>(a, n_bh, stream); break;
    case 32: launch<T, 32>(a, n_bh, stream); break;
    case 64: launch<T, 64>(a, n_bh, stream); break;
    case 128: launch<T, 128>(a, n_bh, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int batch,
                               int hq, int rep, int sq, int sk, int dh,
                               int q_offset, int window, int causal, int bq,
                               float scale, int bf16, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  a.hq = hq;
  a.rep = rep;
  a.sq = sq;
  a.sk = sk;
  a.q_offset = q_offset;
  a.window = window;
  a.causal = causal;
  a.bq = bq;
  a.scale = scale;
  if (batch > 0 && hq > 0 && sq > 0) {
    const int n_bh = batch * hq;
    const int err =
        bf16 ? dispatch<__nv_bfloat16>(a, n_bh, dh, (cudaStream_t)stream)
             : dispatch<float>(a, n_bh, dh, (cudaStream_t)stream);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
