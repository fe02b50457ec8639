// A measurement, not a kernel of any path: the integer instruction rate
// an SM reaches on the level body of rmat_counter.cu, for the bound of
// that kernel (chip_smoke.py phase 6).
//
// Every thread runs ``iters`` times the body of rmat_counter_kernel: the
// per-level loop of its fmix32 hash with the same salts and thresholds,
// over kLevels levels (the scale of chip_smoke.py's graph), on an index
// that changes each iteration, and writes one word, so nothing is
// folded away.  The level count is a constant here, so that the loop's
// SASS is exactly what an iteration issues.  The instructions an
// iteration issues are counted in its SASS (cuobjdump -sass: the loop's
// backward branch) and the launch is timed with CUDA events; their
// ratio over the SM count and clock is the achieved thread instructions
// per clock per SM.  Every instruction of the body is a 32-bit integer
// one (IMAD, SHF, LOP3, ISETP, SEL), which a GH100 SM issues to 64
// INT32 lanes, against its 128 FP32 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 24;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Salts {
  uint32_t v[kLevels];
};

__global__ void int_rate_kernel(uint32_t* __restrict__ out, int iters,
                                Salts salts, uint32_t t1, uint32_t t2,
                                uint32_t t3) {
  uint32_t idx = (uint32_t)(blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t stride = gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (int it = 0; it < iters; ++it) {
    const uint32_t base = idx * kGolden;
    int32_t s = 0, d = 0;
#pragma unroll
    for (int level = 0; level < kLevels; ++level) {
      uint32_t x = base ^ salts.v[level];
      x ^= x >> 16;
      x *= 0x7FEB352Du;
      x ^= x >> 15;
      x *= 0x846CA68Bu;
      x ^= x >> 16;
      const int32_t sb = x >= t2;
      const int32_t db = ((x >= t1) && (x < t2)) || (x >= t3);
      s |= sb << level;
      d |= db << level;
    }
    acc += (uint32_t)s ^ ((uint32_t)d << 1);
    idx += stride;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// salts: kLevels of them
extern "C" int int_rate(void* out, int blocks, int threads, int iters,
                        const unsigned* salts, unsigned t1, unsigned t2,
                        unsigned t3, void* stream) {
  if (blocks <= 0 || threads <= 0) return (int)cudaErrorInvalidValue;
  Salts s{};
  for (int l = 0; l < kLevels; ++l) s.v[l] = salts[l];
  int_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, iters, s, t1, t2, t3);
  return (int)cudaGetLastError();
}
