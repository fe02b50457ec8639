// The stateless counter R-MAT generator: edge e's quadrant at each level
// is a pure function of (seed, e, level) through an fmix32-style hash, so
// any slice [start, start+count) of the edge stream is the same however
// the stream is split.
//
// Replaces the TPU kernel src/repro/graph/rmat.py::rmat_edges_counter_kernel
// (pl.pallas_call at :225), which mixed tile-wide uint32 vectors.  Here
// one thread makes one edge, looping over the levels in uint32
// arithmetic.  The per-level salts are computed on the host (the port's
// copy of level_salt) and passed by value, so nothing is read from memory.
// Bit-identical to the numpy rmat_edges_counter for any (start, count).
//
// Bound on the card: instruction throughput, against 8 bytes written per edge.
// Each edge and level takes at least 9 instructions, however the compiler
// fuses them: the salted first xor-shift folds into one LOP3 (the shift of
// base is loop-invariant, the salt's is uniform), each multiply is one
// IMAD, the two other xor-shifts are an SHF and a LOP3 each, and the two
// output bits need one comparison each at the least.  An SM issues at most
// 128 thread instructions per clock (four schedulers, one warp each).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 31;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Salts {
  uint32_t v[kMaxLevels];
};

__global__ void rmat_counter_kernel(int32_t* __restrict__ src,
                                    int32_t* __restrict__ dst, int64_t count,
                                    uint32_t start, Salts salts, int scale,
                                    uint32_t t1, uint32_t t2, uint32_t t3) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t idx = start + (uint32_t)i;      // counter mod 2**32
  const uint32_t base = idx * kGolden;
  int32_t s = 0, d = 0;
  // unrolled so that salts.v[level] is a constant offset into the kernel
  // parameters (a runtime index would copy them to a local stack frame)
#pragma unroll
  for (int level = 0; level < kMaxLevels; ++level) {
    if (level >= scale) break;
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
  src[i] = s;
  dst[i] = d;
}

}  // namespace

extern "C" int rmat_counter(void* src, void* dst, long long count,
                            unsigned start, const unsigned* salts, int scale,
                            unsigned t1, unsigned t2, unsigned t3,
                            void* stream) {
  if (scale < 0 || scale > kMaxLevels) return (int)cudaErrorInvalidValue;
  Salts s{};
  for (int l = 0; l < scale; ++l) s.v[l] = salts[l];
  if (count > 0) {
    const int block = 256;
    const int64_t grid = ((int64_t)count + block - 1) / block;
    rmat_counter_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (int32_t*)src, (int32_t*)dst, (int64_t)count, (uint32_t)start, s,
        scale, t1, t2, t3);
  }
  return (int)cudaGetLastError();
}
