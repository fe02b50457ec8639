// The stateless counter R-MAT generator: edge e's quadrant at each level
// is a pure function of (seed, e, level) through an fmix32-style hash, so
// any slice [start, start+count) of the edge stream is the same however
// the stream is split.
//
// Replaces the TPU kernel src/repro/graph/rmat.py::rmat_edges_counter_kernel
// (pl.pallas_call at :225), which mixed tile-wide uint32 vectors.  Here
// one thread makes one edge, looping over the levels in uint32
// arithmetic.  Bit-identical to the numpy rmat_edges_counter for any
// (start, count).
//
// Bound on the card: instruction throughput, against 8 bytes written per
// edge.  Each edge and level takes at least 9 instructions, however the
// compiler fuses them: the salted first xor-shift is one LOP3, each
// multiply is one IMAD, the two other xor-shifts are an SHF and a LOP3
// each, and the two output bits need one comparison each at the least.
// The rate those 9 issue at is the larger of two readings of the same
// run (chip_smoke.py): int_rate.cu running this kernel's level body, and
// this kernel's own SASS count over its time.
//
// The level body (rmat_level.cuh), as the hash allows it to be cut:
// * the level count is a template constant (scales 1..30, dispatched in
//   the C entry), so the levels are unrolled with no per-level exit test
//   and each level's salt is a constant offset into the kernel
//   parameters;
// * the first xor-shift folds into the host's salts, so a level starts
//   with one xor;
// * the dst bit is the xor of three compares chained as predicates, and
//   each output bit goes in with an OR predicated on its compare.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "rmat_level.cuh"

namespace {

constexpr int kMaxScale = 30;   // int32 vertex ids (rmat.py::_slice_bounds)
constexpr int kBlock = 256;

struct Salts {
  uint32_t v[kMaxScale];        // folded: S_l = salt_l ^ (salt_l >> 16)
};

template <int SCALE>
__global__ void __launch_bounds__(kBlock)
    rmat_counter_kernel(int32_t* __restrict__ src, int32_t* __restrict__ dst,
                        int64_t count, uint32_t start, const Salts salts,
                        uint32_t t1, uint32_t t2, uint32_t t3) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= count) return;
  // the counter mod 2**32
  const uint32_t h = (start + (uint32_t)i) * rmat::kGolden;
  const uint32_t base = h ^ (h >> 16);
  uint32_t s = 0, d = 0;
  rmat::levels(std::make_integer_sequence<int, SCALE>{}, base, salts, t1, t2,
               t3, s, d);
  src[i] = (int32_t)s;
  dst[i] = (int32_t)d;
}

template <int SCALE>
void launch(int32_t* src, int32_t* dst, int64_t count, uint32_t start,
            const Salts& salts, uint32_t t1, uint32_t t2, uint32_t t3,
            cudaStream_t stream) {
  const int64_t grid = (count + kBlock - 1) / kBlock;
  rmat_counter_kernel<SCALE><<<(unsigned)grid, kBlock, 0, stream>>>(
      src, dst, count, start, salts, t1, t2, t3);
}

typedef void (*Launch)(int32_t*, int32_t*, int64_t, uint32_t, const Salts&,
                       uint32_t, uint32_t, uint32_t, cudaStream_t);

// launch<1> .. launch<kMaxScale>
template <int... S>
Launch pick(int scale, std::integer_sequence<int, S...>) {
  constexpr Launch fns[] = {&launch<S + 1>...};
  return fns[scale - 1];
}

}  // namespace

// folded: kMaxScale >= scale folded salts S_l (see above); the thresholds
// must satisfy t1 <= t2 <= t3 (the wrapper checks)
extern "C" int rmat_counter(void* src, void* dst, long long count,
                            unsigned start, const unsigned* folded, int scale,
                            unsigned t1, unsigned t2, unsigned t3,
                            void* stream) {
  if (scale < 1 || scale > kMaxScale || t1 > t2 || t2 > t3)
    return (int)cudaErrorInvalidValue;
  Salts s{};
  for (int l = 0; l < scale; ++l) s.v[l] = folded[l];
  if (count > 0)
    pick(scale, std::make_integer_sequence<int, kMaxScale>{})(
        (int32_t*)src, (int32_t*)dst, (int64_t)count, (uint32_t)start, s, t1,
        t2, t3, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
