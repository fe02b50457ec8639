// A measurement, not a kernel of any path: the integer instruction rate
// an SM reaches on rmat_counter.cu's level body, for the bound of that
// kernel (chip_smoke.py phase 2).
//
// Every thread runs ``iters`` times the kernel's own level body
// (rmat_level.cuh: the folded salts, two multiplies, two xor-shifts, the
// compares chained as predicates and the predicated ORs) over kLevels
// levels (the scale of chip_smoke.py's graph), on an index that changes
// each iteration, and writes one word, so nothing is folded away.  The
// level count is a constant here, as in the kernel, so that the loop's
// SASS is exactly what an iteration issues.  The instructions an
// iteration issues are counted in its SASS (cuobjdump -sass: the loop's
// backward branch) and the launch is timed with CUDA events; their
// ratio over the SM count and clock is the achieved thread instructions
// per clock per SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "rmat_level.cuh"

namespace {

constexpr int kLevels = 24;

struct Salts {
  uint32_t v[kLevels];          // folded: S_l = salt_l ^ (salt_l >> 16)
};

__global__ void int_rate_kernel(uint32_t* __restrict__ out, int iters,
                                const Salts salts, uint32_t t1, uint32_t t2,
                                uint32_t t3) {
  uint32_t idx = (uint32_t)(blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
    const uint32_t h = idx * rmat::kGolden;
    const uint32_t base = h ^ (h >> 16);
    uint32_t s = 0, d = 0;
    rmat::levels(std::make_integer_sequence<int, kLevels>{}, base, salts, t1,
                 t2, t3, s, d);
    acc += s ^ (d << 1);
    idx += stride;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// folded: kLevels folded salts; t1 <= t2 <= t3, as the kernel takes them
extern "C" int int_rate(void* out, int blocks, int threads, int iters,
                        const unsigned* folded, unsigned t1, unsigned t2,
                        unsigned t3, void* stream) {
  if (blocks <= 0 || threads <= 0 || t1 > t2 || t2 > t3)
    return (int)cudaErrorInvalidValue;
  Salts s{};
  for (int l = 0; l < kLevels; ++l) s.v[l] = folded[l];
  int_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, iters, s, t1, t2, t3);
  return (int)cudaGetLastError();
}
