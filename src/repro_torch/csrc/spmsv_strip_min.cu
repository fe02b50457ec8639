// Top-down local discovery of the 1D strips against the whole
// allgathered frontier bitmap (n bits): the strip SpMSV of
// strip_gather.cuh with the full-bitmap test.
//
// Replaces the TPU kernel
// src/repro/kernels/spmsv/strip.py::gather_strip_segments
// (pl.pallas_call at :66) and the scatter-min after it; the design and
// its bound are in strip_gather.cuh.
#include "strip_gather.cuh"

namespace {

__global__ void __launch_bounds__(strip::kBlock) spmsv_strip_min_kernel(
    const int32_t* jc, const int32_t* cp, const int32_t* nzc,
    const int32_t* row_idx, const uint32_t* fw, int32_t* cand,
    unsigned long long* examined, int32_t cap_nzc, int64_t cap,
    int32_t chunk, int32_t n, int32_t blocks_per_strip) {
  strip::gather_min(jc, cp, nzc, row_idx, cand, examined, cap_nzc, cap,
                    chunk, n, blocks_per_strip, strip::FullBitmap{fw});
}

}  // namespace

extern "C" int spmsv_strip_min(const void* jc, const void* cp,
                               const void* nzc, const void* row_idx,
                               const void* fw, void* cand, void* examined,
                               int p, int cap_nzc, long long cap, int chunk,
                               int n, void* stream) {
  int bps;
  unsigned grid;
  if (strip::launch_grid(p, cap_nzc, &bps, &grid)) {
    spmsv_strip_min_kernel<<<grid, strip::kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)jc, (const int32_t*)cp, (const int32_t*)nzc,
        (const int32_t*)row_idx, (const uint32_t*)fw, (int32_t*)cand,
        (unsigned long long*)examined, cap_nzc, (int64_t)cap, chunk, n, bps);
  }
  return (int)cudaGetLastError();
}
