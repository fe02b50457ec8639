// The two walks of the pipelined strip SpMSV (spmsv_strip_chunk_min.cu):
// the frontier walk, which looks each frontier column up in every
// strip's jc, and the range-restricted column walk, which tests only the
// jc slots that fall in step k's sub-ranges.  Both fold the found
// segments into the candidates through one block-wide gather
// (block_gather), which spreads a column of 10^5 edges over the block.
// strip_gather.cuh (the whole-bitmap kernel's column walk) is unchanged.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace walk {

constexpr int kBlock = 256;

// the first slot of jc[0, nz) holding a value >= x (jc ascends)
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ jc,
                                               int32_t nz, int32_t x) {
  int32_t lo = 0, hi = nz;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(jc + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the same, by a whole warp: 32 pivots a step narrow the range 32-fold,
// so a search of 2^23 slots takes 5 dependent loads, not 23; every lane
// calls it with the same arguments and gets the answer
__device__ __forceinline__ int32_t warp_lower_bound(
    const int32_t* __restrict__ jc, int32_t nz, int32_t x) {
  const int32_t lane = threadIdx.x & 31;
  int32_t lo = 0, hi = nz;                 // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int32_t step = (hi - lo + 31) >> 5;
    const int32_t i = lo + lane * step;
    const int32_t c = __popc(__ballot_sync(
        0xffffffffu, i < hi && __ldg(jc + i) < x));
    if (c == 0) return lo;
    hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
  }
  return lo + __popc(__ballot_sync(
      0xffffffffu, lo + lane < hi && __ldg(jc + lo + lane) < x));
}

struct Gather {
  using Scan = cub::BlockScan<int32_t, kBlock>;
  typename Scan::TempStorage scan;
  int32_t off[kBlock];
  int32_t col[kBlock];
  int32_t cbase[kBlock];
  int64_t start[kBlock];
};

// Every thread brings one segment (len 0 for none): column ``u`` of
// strip ``strip`` with its edges at row_idx[strip, start:start+len].
// The block scans the lengths and strides over all their edges
// together, atomicMin-ing u into the strip's candidate of each edge's
// row; the block's edge total goes to ``examined``.  Called by every
// thread of the block; ends with the block in step.
__device__ __forceinline__ void block_gather(
    Gather& sh, int32_t u, int32_t strip, int32_t start, int32_t len,
    const int32_t* __restrict__ row_idx, int64_t cap, int32_t* cand,
    int32_t nr, unsigned long long* examined) {
  if (!__syncthreads_or(len > 0)) return;
  int32_t off, total;
  Gather::Scan(sh.scan).ExclusiveSum(len, off, total);
  sh.off[threadIdx.x] = off;
  sh.col[threadIdx.x] = u;
  sh.cbase[threadIdx.x] = strip * nr;
  sh.start[threadIdx.x] = (int64_t)strip * cap + start;
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(examined, (unsigned long long)total);
  for (int32_t e = threadIdx.x; e < total; e += kBlock) {
    // largest t with off[t] <= e: the segment holding edge e (empty
    // segments share their offset with the next one and lose)
    int32_t lo = 0, hi = kBlock - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (sh.off[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int32_t v = __ldg(row_idx + sh.start[lo] + (e - sh.off[lo]));
    atomicMin(cand + sh.cbase[lo] + v, sh.col[lo]);
  }
  __syncthreads();          // the next call rewrites the shared arrays
}

}  // namespace walk
