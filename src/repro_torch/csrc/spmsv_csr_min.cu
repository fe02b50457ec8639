// Top-down local discovery for one 2D block: SpMSV in the
// (select-source, min) semiring over the CSC column segments of the
// frontier columns.
//
// Replaces the TPU kernel src/repro/kernels/spmsv/spmsv.py::gather_segments
// (pl.pallas_call at :56) together with the scatter-min that follows it
// (src/repro/kernels/spmsv/ops.py::_scatter_min).  The TPU kernel wrote a
// (cap_f, maxdeg) scratch of gathered destinations; here each edge of a
// frontier column does its atomicMin straight into the (nr,) candidate
// vector, so nothing but the candidates is written.  A min is order
// independent, so the result is bit-identical whatever order the atomics
// land in.
//
// Work balance: the wrapper gives the frontier column ids and the
// exclusive prefix sum of their segment lengths.  One thread per frontier
// EDGE finds its column by binary search in that prefix sum, so a column
// of 10^5 edges is spread over the whole grid instead of one thread or
// one warp.  The grid is sized from the live frontier's edge count.
//
// Bound on the card: bytes.  Each frontier edge reads one row id and does
// one atomic on a candidate word; the candidate vector is written once.
// The reads of row_idx are contiguous within a segment (coalesced); the
// atomics are scattered.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void spmsv_csr_min_kernel(const int32_t* __restrict__ ids,
                                     const int64_t* __restrict__ offs,
                                     const int32_t* __restrict__ col_ptr,
                                     const int32_t* __restrict__ row_idx,
                                     int32_t* __restrict__ cand,
                                     int32_t n_ids, int64_t total,
                                     int32_t col_offset) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    // largest k with offs[k] <= e: the column whose segment holds edge e
    // (empty columns share their offset with the next one and lose)
    int32_t lo = 0, hi = n_ids - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (__ldg(offs + mid) <= e) lo = mid; else hi = mid - 1;
    }
    const int32_t u = __ldg(ids + lo);
    const int64_t pos = (int64_t)__ldg(col_ptr + u) + (e - __ldg(offs + lo));
    const int32_t v = __ldg(row_idx + pos);
    atomicMin(cand + v, col_offset + u);
  }
}

}  // namespace

extern "C" int spmsv_csr_min(const void* ids, const void* offs,
                             const void* col_ptr, const void* row_idx,
                             void* cand, int n_ids, long long total,
                             int col_offset, int grid, void* stream) {
  if (total > 0 && n_ids > 0) {
    spmsv_csr_min_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const int64_t*)offs, (const int32_t*)col_ptr,
        (const int32_t*)row_idx, (int32_t*)cand, n_ids, (int64_t)total,
        col_offset);
  }
  return (int)cudaGetLastError();
}
