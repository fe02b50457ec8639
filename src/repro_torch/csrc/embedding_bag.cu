// Table-batched EmbeddingBag: for each bag b, the weighted sum (or mean)
// of the table rows its ids name, out[b] = sum_j w[b,j] * table[ids[b,j]].
// An id below 0 is padding; an id at or past V reads row V-1.
//
// Replaces the TPU kernel
// src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_kernel
// (pl.pallas_call at :41, _kernel at :17), which held the whole table in
// VMEM and gathered a tile of bags' rows per grid step.  Here the table
// stays in device memory: one thread owns one output element (bag, d)
// and loops j = 0..L-1 in bag order, so the D threads of a bag read each
// row as one contiguous run (a warp covers 32/D bags when D < 32) and
// the bag's ids and weights are shared loads.  The update is one rounded
// multiply and one rounded add (__fmul_rn/__fadd_rn, no FMA contraction)
// and the mean one rounded division, in float32, rounded to bf16 with
// round-to-nearest-even at the end: the arithmetic of the plain version
// (kernels/embedding_bag/ref.py), which it equals bit for bit.  Row
// offsets are 64-bit (row * D passes 2^31 at about 134M rows of D = 16).
//
// Bound on the card: bytes.  Each bag reads its L ids (and weights), L
// rows of D elements and writes one row; no arithmetic to speak of.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int32_t* __restrict__ ids,
                                     const float* __restrict__ weights,
                                     T* __restrict__ out, int64_t n_out,
                                     int32_t L, int64_t V, int32_t D,
                                     bool mean) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int64_t b = e / D;
  const int32_t d = (int32_t)(e - b * D);
  const int32_t* bag = ids + b * L;
  float acc = 0.0f, wsum = 0.0f;
  for (int32_t j = 0; j < L; ++j) {
    const int32_t id = __ldg(bag + j);
    const bool valid = id >= 0;
    const int64_t row = !valid ? 0 : (id < V ? (int64_t)id : V - 1);
    float w = valid ? 1.0f : 0.0f;
    if (weights != nullptr) w = __fmul_rn(__ldg(weights + b * L + j), w);
    const float x = to_float(table[row * D + d]);
    acc = __fadd_rn(acc, __fmul_rn(x, w));
    wsum = __fadd_rn(wsum, w);
  }
  if (mean) {
    // clamp(min=1e-9) of the plain version: a NaN sum stays NaN
    const float den = wsum < 1e-9f ? 1e-9f : wsum;
    acc = __fdiv_rn(acc, den);
  }
  store(out + e, acc);
}

template <typename T>
void launch(const void* table, const void* ids, const void* weights,
            void* out, int64_t n_bags, int L, int64_t V, int D, int mean,
            cudaStream_t stream) {
  const int64_t n_out = n_bags * D;
  const int block = 256;
  const int64_t grid = (n_out + block - 1) / block;
  embedding_bag_kernel<T><<<(unsigned)grid, block, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (const float*)weights, (T*)out,
      n_out, L, V, D, mean != 0);
}

}  // namespace

extern "C" int embedding_bag(const void* table, const void* ids,
                             const void* weights, void* out,
                             long long n_bags, int L, long long V, int D,
                             int mean, int bf16, void* stream) {
  if (n_bags > 0 && D > 0) {
    if (bf16)
      launch<__nv_bfloat16>(table, ids, weights, out, n_bags, L, V, D, mean,
                            (cudaStream_t)stream);
    else
      launch<float>(table, ids, weights, out, n_bags, L, V, D, mean,
                    (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
