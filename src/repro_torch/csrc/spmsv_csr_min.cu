// Top-down local discovery: SpMSV in the (select-source, min) semiring
// over the CSC column segments of the frontier columns.  One body, three
// ways of addressing a segment, three C entries:
//
//   spmsv_csr_min         a 2D block through its uncompressed col_ptr[u]
//   spmsv_dcsc_min        a 2D block through the DCSC (jc, cp): the
//                         wrapper's binary search of each frontier id in
//                         jc gives its slot, and the segment starts at
//                         cp[slot]
//   spmsv_strips_csr_min  all p 1D strips at once through the (p, n+1)
//                         strip col_ptr: one item per (strip, frontier
//                         id), strip-major
//
// Replaces the TPU kernel src/repro/kernels/spmsv/spmsv.py::gather_segments
// (pl.pallas_call at :56) together with the scatter-min that follows it
// (src/repro/kernels/spmsv/ops.py::_scatter_min), as spmsv_block_csr,
// spmsv_block_dcsc (ops.py:77-89) and the 1D _td_kernel_csr reach it.  The
// TPU kernel wrote a (cap_f, maxdeg) scratch of gathered destinations; here
// each edge of a frontier segment does its atomicMin straight into the
// candidate vector, so nothing but the candidates is written.  A min is
// order independent, so the result is bit-identical whatever order the
// atomics land in.
//
// Work balance: the wrapper gives the items (frontier ids, or (strip, id)
// pairs) and the int64 exclusive prefix sum of their segment lengths.  One
// thread per frontier EDGE finds its item by binary search in that prefix
// sum, so a column of 10^5 edges is spread over the whole grid instead of
// one thread or one warp.  The grid is sized from the live frontier's edge
// count.
//
// Bound on the card: bytes.  Each frontier edge reads one row id and does
// one atomic on a candidate word; the candidate vector is written once.
// The reads of row_idx are contiguous within a segment (coalesced); the
// atomics are scattered.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Addressing { kCsr = 0, kDcsc = 1, kStripsCsr = 2 };

template <int MODE>
__global__ void spmsv_min_kernel(const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ slot,
                                 const int64_t* __restrict__ offs,
                                 const int32_t* __restrict__ ptr,
                                 const int32_t* __restrict__ row_idx,
                                 int32_t* __restrict__ cand,
                                 int32_t n_items, int64_t total,
                                 int32_t col_offset, int32_t n_ids,
                                 int64_t ptr_stride, int64_t ridx_stride,
                                 int32_t nr) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    // largest k with offs[k] <= e: the item whose segment holds edge e
    // (empty segments share their offset with the next one and lose)
    int32_t lo = 0, hi = n_items - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (__ldg(offs + mid) <= e) lo = mid; else hi = mid - 1;
    }
    const int64_t within = e - __ldg(offs + lo);
    if (MODE == kStripsCsr) {
      const int32_t s = lo / n_ids;
      const int32_t u = __ldg(ids + (lo - s * n_ids));
      const int64_t pos = (int64_t)__ldg(ptr + s * ptr_stride + u) + within;
      const int32_t v = __ldg(row_idx + s * ridx_stride + pos);
      atomicMin(cand + (int64_t)s * nr + v, u);
    } else {
      const int32_t u = __ldg(ids + lo);
      const int32_t at = MODE == kDcsc ? __ldg(slot + lo) : u;
      const int64_t pos = (int64_t)__ldg(ptr + at) + within;
      const int32_t v = __ldg(row_idx + pos);
      atomicMin(cand + v, col_offset + u);
    }
  }
}

}  // namespace

extern "C" int spmsv_csr_min(const void* ids, const void* offs,
                             const void* col_ptr, const void* row_idx,
                             void* cand, int n_ids, long long total,
                             int col_offset, int grid, void* stream) {
  if (total > 0 && n_ids > 0) {
    spmsv_min_kernel<kCsr><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, nullptr, (const int64_t*)offs,
        (const int32_t*)col_ptr, (const int32_t*)row_idx, (int32_t*)cand,
        n_ids, (int64_t)total, col_offset, n_ids, 0, 0, 0);
  }
  return (int)cudaGetLastError();
}

extern "C" int spmsv_dcsc_min(const void* ids, const void* slot,
                              const void* offs, const void* cp,
                              const void* row_idx, void* cand, int n_ids,
                              long long total, int col_offset, int grid,
                              void* stream) {
  if (total > 0 && n_ids > 0) {
    spmsv_min_kernel<kDcsc><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const int32_t*)slot, (const int64_t*)offs,
        (const int32_t*)cp, (const int32_t*)row_idx, (int32_t*)cand, n_ids,
        (int64_t)total, col_offset, n_ids, 0, 0, 0);
  }
  return (int)cudaGetLastError();
}

extern "C" int spmsv_strips_csr_min(const void* ids, const void* offs,
                                    const void* col_ptr, const void* row_idx,
                                    void* cand, int n_ids, int p,
                                    long long total, long long ptr_stride,
                                    long long ridx_stride, int nr, int grid,
                                    void* stream) {
  if (total > 0 && n_ids > 0) {
    spmsv_min_kernel<kStripsCsr><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, nullptr, (const int64_t*)offs,
        (const int32_t*)col_ptr, (const int32_t*)row_idx, (int32_t*)cand,
        n_ids * p, (int64_t)total, 0, n_ids, (int64_t)ptr_stride,
        (int64_t)ridx_stride, nr);
  }
  return (int)cudaGetLastError();
}
