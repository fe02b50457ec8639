// The table gradient of the table-batched EmbeddingBag (kernel 8): for
// each table row r that some bag reads,
//   dtable[r] = sum over the (bag b, slot j) with ids[b,j] -> r of
//               w[b,j] * (dout[b] / den[b] under "mean", else dout[b]),
// the terms taken in their flat order b * L + j, in float32, rounded once
// to the table's dtype.  Rows that no bag reads stay as the wrapper
// allocated them (zero).
//
// Replaces no TPU kernel of its own: the JAX package differentiates the
// lookup with XLA (jax.grad of jnp.take, src/repro/models/embedding.py:55)
// around the forward Pallas kernel
// src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_kernel
// (pl.pallas_call at :41), and the port's forward is a hand-written kernel
// (csrc/embedding_bag.cu), so its gradient is one too.
//
// Bound on the card: bytes.  Each live (bag, slot) term reads its bag
// index, its weight and a D-element row of dout (a gather: bags that read
// one row lie anywhere in the batch); each live row is written once.  The
// dense (V, D) output's zero fill is the wrapper's torch.zeros.
//
// Design: the launch prep (kernels/embedding_bag/ops.py::
// prepare_backward, plain torch) lists the live terms, stable-sorts them
// by row and cuts them into one segment a live row, so no two threads add
// into one row: no atomics, and the sum's order is fixed (deterministic,
// and equal to the plain version's index_add_ in flat order on the CPU).
// ``lanes`` threads own a segment's row (V elements each, 16 bytes where
// the row's bytes allow), 256 / lanes segments side by side a block; a
// thread issues kUnroll terms' loads before it adds any of them, in order.
// The arithmetic is the plain version's, element by element: one rounded
// division under "mean", one rounded multiply and one rounded add a term
// (__fdiv_rn/__fmul_rn/__fadd_rn, no FMA contraction), so the two agree
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;   // terms whose loads are in flight together

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* x) { x[0] = __ldg(p); }
  __device__ static void store(float* p, const float* x) { *p = x[0]; }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    x[0] = __bfloat162float(p[0]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct Args {
  const void* dout;       // (B, D) in T
  const int32_t* bags;    // (n_terms,) bag of each sorted term
  const float* weights;   // (n_terms,) or null (all 1)
  const float* den;       // (B,) under "mean", else null
  const int32_t* seg_rows;  // (n_seg,) the row of each segment
  const int32_t* seg_off;   // (n_seg + 1,) its terms' range
  void* dtable;           // (V, D) in T
  int64_t n_seg;
  int32_t D, n_vec, lanes;
};

template <typename T, int V>
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_kernel(
    const Args a) {
  const int32_t per_pass = kBlock / a.lanes;
  const int32_t slot = threadIdx.x / a.lanes;
  if (slot >= per_pass) return;
  const int32_t vec = blockIdx.y * a.lanes + (threadIdx.x - slot * a.lanes);
  if (vec >= a.n_vec) return;
  const int64_t seg = (int64_t)blockIdx.x * per_pass + slot;
  if (seg >= a.n_seg) return;
  const int32_t d0 = vec * V;
  const T* dout = (const T*)a.dout;
  const int32_t lo = __ldg(a.seg_off + seg), hi = __ldg(a.seg_off + seg + 1);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int32_t p = lo; p < hi; p += kUnroll) {
    float x[kUnroll][V], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t q = p + u < hi ? p + u : lo;
      const int64_t b = __ldg(a.bags + q);
      w[u] = a.weights != nullptr ? __ldg(a.weights + q) : 1.0f;
      Vec<T, V>::load(dout + b * a.D + d0, x[u]);
      if (a.den != nullptr) {
        const float den = __ldg(a.den + b);
#pragma unroll
        for (int v = 0; v < V; ++v) x[u][v] = __fdiv_rn(x[u][v], den);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u < hi) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(w[u], x[u][v]));
      }
    }
  }
  const int64_t row = __ldg(a.seg_rows + seg);
  Vec<T, V>::store((T*)a.dtable + row * a.D + d0, acc);
}

template <typename T, int V>
int launch(const Args& a, long long gx, int gy, cudaStream_t stream) {
  if (gx * (kBlock / a.lanes) < a.n_seg || (long long)gy * a.lanes < a.n_vec
      || gx >= (1ll << 31) || gy > 65535)
    return (int)cudaErrorInvalidValue;
  embedding_bag_bwd_kernel<T, V>
      <<<dim3((unsigned)gx, gy), kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// a: the launch's 15 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py::launch_backward): dout, bags, weights
// (0 for none), den (0 unless "mean"), seg_rows, seg_off, dtable, n_seg,
// D, bf16, vec, lanes, gx, gy, stream.  vec and lanes as for the forward
// entry (ops.layout), with dout and dtable 16-byte aligned for vec > 1.
extern "C" int embedding_bag_bwd(const long long* a) {
  Args args;
  args.dout = (const void*)a[0];
  args.bags = (const int32_t*)a[1];
  args.weights = (const float*)a[2];
  args.den = (const float*)a[3];
  args.seg_rows = (const int32_t*)a[4];
  args.seg_off = (const int32_t*)a[5];
  args.dtable = (void*)a[6];
  args.n_seg = a[7];
  args.D = (int32_t)a[8];
  const int bf16 = (int)a[9], vec = (int)a[10];
  args.lanes = (int32_t)a[11];
  const long long gx = a[12];
  const int gy = (int)a[13];
  const auto st = (cudaStream_t)a[14];
  if (args.n_seg <= 0 || args.D <= 0) return (int)cudaGetLastError();
  if (args.lanes < 1 || args.lanes > kBlock || vec < 1 || args.D % vec)
    return (int)cudaErrorInvalidValue;
  args.n_vec = args.D / vec;
  if (bf16) {
    if (vec == 8) return launch<__nv_bfloat16, 8>(args, gx, gy, st);
    if (vec == 1) return launch<__nv_bfloat16, 1>(args, gx, gy, st);
  } else {
    if (vec == 4) return launch<float, 4>(args, gx, gy, st);
    if (vec == 1) return launch<float, 1>(args, gx, gy, st);
  }
  return (int)cudaErrorInvalidValue;
}
