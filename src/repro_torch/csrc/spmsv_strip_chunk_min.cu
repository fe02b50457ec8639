// Top-down local discovery of the 1D strips for one step k of the
// software-pipelined expand: the strip SpMSV of strip_gather.cuh tested
// against the raw owner-major (p * w_sub,) sub-chunk words of step k
// (wpc = chunk/32 words per owner, w_sub = wpc / n_chunks), so no
// full-size frontier bitmap is built.  The caller min-combines the
// candidates of the n_chunks steps, which is exact under the min.
//
// Replaces the TPU kernel
// src/repro/kernels/spmsv/strip.py::gather_strip_segments_chunk
// (pl.pallas_call at :139) and the scatter-min after it; the design and
// its bound are in strip_gather.cuh.
#include "strip_gather.cuh"

namespace {

__global__ void __launch_bounds__(strip::kBlock) spmsv_strip_chunk_min_kernel(
    const int32_t* jc, const int32_t* cp, const int32_t* nzc,
    const int32_t* row_idx, const uint32_t* f_sub, int32_t* cand,
    unsigned long long* examined, int32_t cap_nzc, int64_t cap,
    int32_t chunk, int32_t n, int32_t blocks_per_strip, int32_t wpc,
    int32_t w_sub, int32_t k) {
  strip::gather_min(jc, cp, nzc, row_idx, cand, examined, cap_nzc, cap,
                    chunk, n, blocks_per_strip,
                    strip::SubChunk{f_sub, wpc, w_sub, k});
}

}  // namespace

extern "C" int spmsv_strip_chunk_min(const void* jc, const void* cp,
                                     const void* nzc, const void* row_idx,
                                     const void* f_sub, void* cand,
                                     void* examined, int p, int cap_nzc,
                                     long long cap, int chunk, int n,
                                     int wpc, int w_sub, int k,
                                     void* stream) {
  int bps;
  unsigned grid;
  if (strip::launch_grid(p, cap_nzc, &bps, &grid)) {
    spmsv_strip_chunk_min_kernel<<<grid, strip::kBlock, 0,
                                   (cudaStream_t)stream>>>(
        (const int32_t*)jc, (const int32_t*)cp, (const int32_t*)nzc,
        (const int32_t*)row_idx, (const uint32_t*)f_sub, (int32_t*)cand,
        (unsigned long long*)examined, cap_nzc, (int64_t)cap, chunk, n, bps,
        wpc, w_sub, k);
  }
  return (int)cudaGetLastError();
}
