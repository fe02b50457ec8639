// Table-batched EmbeddingBag: for each bag b, the weighted sum (or mean)
// of the table rows its ids name, out[b] = sum_j w[b,j] * table[ids[b,j]].
// An id below 0 is padding; an id at or past V reads row V-1.
//
// Replaces the TPU kernel
// src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_kernel
// (pl.pallas_call at :41, _kernel at :17), which held the whole table in
// VMEM and gathered a tile of bags' rows per grid step.  Here the table
// stays in device memory.
//
// Bound on the card: bytes.  Each bag reads its L ids (and weights), L
// rows of D elements and writes one row; no arithmetic to speak of.  At
// the serving shapes the rows are random reads of a table that no cache
// holds, so what counts is how many row reads are in flight.
//
// What the first design lost (3.8x its bound at serve_bulk): one thread
// owned one output element, with a 64-bit division by a runtime D, 4-byte
// loads of a row, and one row read in flight a thread.  At the serving
// shapes of a few thousand bags the device work is about a microsecond
// and the host's call is the cost: the wrapper packs the arguments into
// one (embedding_bag below).
//
// This design: ``lanes`` threads own a bag's row (or a slice of 256
// lanes of it, blockIdx.y), each lane V consecutive elements, 16 bytes
// (V = 4 float32 or 8 bf16) where the row's bytes are a multiple of 16
// and the table is 16-byte aligned, else one element (V = 1, any D).
// A block's 256 threads hold 256/lanes bags side by side, and each
// thread carries kBags bags, kBags*256/lanes consecutive bags a block:
// for each j the thread issues the ids, weights and row loads of all
// its bags before it adds any, so kBags row reads are in flight a
// thread.  The bag index is found once a thread; there is no division
// in the loop.
//
// The arithmetic is the plain version's (kernels/embedding_bag/ref.py),
// element by element, which it equals bit for bit: j = 0..L-1 in bag
// order, one rounded multiply and one rounded add (__fmul_rn/__fadd_rn,
// no FMA contraction), the mean one rounded division, in float32,
// rounded to bf16 with round-to-nearest-even at the end.  Row offsets
// are 64-bit (row * D passes 2^31 at about 134M rows of D = 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBags = 4;     // bags a thread carries (rows in flight)

// V elements of T at p as float, and back (16-byte vectors where V*T is)
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
      // a bf16 is the high half of a float32
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

// lanes: threads a bag (<= kBlock); n_vec: V-element vectors a row
template <typename T, int V>
__global__ void __launch_bounds__(kBlock) embedding_bag_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ ids,
    const float* __restrict__ weights, T* __restrict__ out, int64_t n_bags,
    int32_t L, int64_t n_rows, int32_t D, int32_t n_vec, int32_t lanes,
    bool mean) {
  const int32_t per_pass = kBlock / lanes;          // bags side by side
  const int32_t slot = threadIdx.x / lanes;         // once a thread
  if (slot >= per_pass) return;
  const int32_t vec = blockIdx.y * lanes + (threadIdx.x - slot * lanes);
  if (vec >= n_vec) return;
  const int32_t d0 = vec * V;
  const int64_t bag0 = (int64_t)blockIdx.x * per_pass * kBags + slot;
  float acc[kBags][V], wsum[kBags];
#pragma unroll
  for (int i = 0; i < kBags; ++i) {
    wsum[i] = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[i][v] = 0.0f;
  }
  for (int32_t j = 0; j < L; ++j) {
    float w[kBags], x[kBags][V];
#pragma unroll
    for (int i = 0; i < kBags; ++i) {
      const int64_t b = bag0 + (int64_t)i * per_pass;
      int32_t id = -1;
      w[i] = 0.0f;
      if (b < n_bags) {
        id = __ldg(ids + b * L + j);
        w[i] = id >= 0 ? 1.0f : 0.0f;
        if (weights != nullptr)
          w[i] = __fmul_rn(__ldg(weights + b * L + j), w[i]);
      }
      const int64_t row = id < 0 ? 0 : (id < n_rows ? id : n_rows - 1);
      Vec<T, V>::load(table + row * D + d0, x[i]);
    }
#pragma unroll
    for (int i = 0; i < kBags; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[i][v] = __fadd_rn(acc[i][v], __fmul_rn(x[i][v], w[i]));
      wsum[i] = __fadd_rn(wsum[i], w[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kBags; ++i) {
    const int64_t b = bag0 + (int64_t)i * per_pass;
    if (b >= n_bags) break;
    if (mean) {
      // clamp(min=1e-9) of the plain version: a NaN sum stays NaN
      const float den = wsum[i] < 1e-9f ? 1e-9f : wsum[i];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][v] = __fdiv_rn(acc[i][v], den);
    }
    Vec<T, V>::store(out + b * D + d0, acc[i]);
  }
}

template <typename T, int V>
int launch(const void* table, const void* ids, const void* weights,
           void* out, long long n_bags, int L, long long n_rows, int D,
           int lanes, long long gx, int gy, int mean, cudaStream_t stream) {
  // the wrapper's grid must cover every bag and every vector of a row
  const int n_vec = D / V;
  if (gx * (kBlock / lanes) * kBags < n_bags ||
      (long long)gy * lanes < n_vec || gx >= (1ll << 31) || gy > 65535)
    return (int)cudaErrorInvalidValue;
  embedding_bag_kernel<T, V><<<dim3((unsigned)gx, gy), kBlock, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const float*)weights, (T*)out,
      n_bags, L, n_rows, D, n_vec, lanes, mean != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// a: the launch's 15 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py, which also picks vec, lanes and the
// grid: ops.layout and ops.grid): table, ids, weights (0 for none), out,
// n_bags, L, n_rows, D, mean, bf16, vec, lanes, gx, gy, stream.  vec:
// elements a lane, 1 or 16 bytes' worth (4 float32, 8 bf16), which must
// divide D, with table and out 16-byte aligned for the latter; lanes:
// threads a bag, in [1, 256].
extern "C" int embedding_bag(const long long* a) {
  const void* table = (const void*)a[0];
  const void* ids = (const void*)a[1];
  const void* weights = (const void*)a[2];
  void* out = (void*)a[3];
  const long long n_bags = a[4], n_rows = a[6], gx = a[12];
  const int L = (int)a[5], D = (int)a[7], mean = (int)a[8], bf16 = (int)a[9];
  const int vec = (int)a[10], lanes = (int)a[11], gy = (int)a[13];
  const auto st = (cudaStream_t)a[14];
  if (n_bags <= 0 || D <= 0) return (int)cudaGetLastError();
  if (lanes < 1 || lanes > kBlock || vec < 1 || D % vec)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(table, ids, weights, out, n_bags, L,
                                      n_rows, D, lanes, gx, gy, mean, st);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(table, ids, weights, out, n_bags, L,
                                      n_rows, D, lanes, gx, gy, mean, st);
  } else {
    if (vec == 4)
      return launch<float, 4>(table, ids, weights, out, n_bags, L, n_rows, D,
                              lanes, gx, gy, mean, st);
    if (vec == 1)
      return launch<float, 1>(table, ids, weights, out, n_bags, L, n_rows, D,
                              lanes, gx, gy, mean, st);
  }
  return (int)cudaErrorInvalidValue;
}
