// The 1D strip SpMSV shared by spmsv_strip_min.cu (the whole frontier
// bitmap) and spmsv_strip_chunk_min.cu (one pipelined sub-chunk): walk
// each strip's non-empty GLOBAL source columns (strip DCSC, jc/cp), test
// each column against the frontier, and fold the live columns' segments
// into the strip's candidates with an atomicMin of the column id.
//
// Replaces the TPU kernels src/repro/kernels/spmsv/strip.py::
// gather_strip_segments (pl.pallas_call at :66) and
// gather_strip_segments_chunk (:139), together with the scatter-min that
// follows them (src/repro/kernels/spmsv/ops.py::_scatter_min,
// col_offset = 0).  The TPU kernels wrote a (cap_nzc, maxdeg) scratch of
// gathered rows, gigabytes at scale 24; here nothing but the candidates
// is written.  A min is order independent, so the atomics are
// bit-identical to the reference scatter-min.
//
// Layout: one launch covers all p strips, which stack with a common
// capacity (jc (p, cap_nzc), cp (p, cap_nzc+1), row_idx (p, cap),
// cand (p, chunk)); every strip base is 64-bit, since p*cap passes 2^31
// at scale 24.  The grid is p x ceil(cap_nzc/256) blocks of 256 slots,
// fixed by the graph, so the launch reads nothing from the host.
//
// Work balance: a block tests its 256 slots, one thread each (coalesced
// jc reads, one L2-resident frontier word each); a block with no live
// slot leaves at once.  Otherwise a block-wide exclusive scan of the live
// segment lengths lets all 256 threads stride over the block's live
// edges together, each finding its column by binary search in the
// scanned offsets, so a column of 10^5 edges is spread over the block
// instead of one thread.  The block also adds its edge total to the
// `examined` counter (the frontier columns' segment lengths, the
// reference's _dcsc_edges_examined).
//
// Bound on the card: bytes.  jc is read for every slot below nzc, cp for
// the live ones, row_idx once per live edge; the candidates are written
// once.  The atomics are scattered over the strip's chunk of rows.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace strip {

constexpr int kBlock = 256;

// frontier test against the whole packed n-bit bitmap
struct FullBitmap {
  const uint32_t* fw;
  __device__ bool operator()(int32_t u) const {
    return (__ldg(fw + (u >> 5)) >> (u & 31)) & 1u;
  }
};

// frontier test against the raw owner-major sub-chunk buffer of
// pipelined step k: owner o's words for its local word range
// [k*w_sub, (k+1)*w_sub) sit at [o*w_sub, (o+1)*w_sub); a column outside
// sub-chunk k is not live in this step
struct SubChunk {
  const uint32_t* f_sub;
  int32_t wpc, w_sub, k;
  __device__ bool operator()(int32_t u) const {
    const int32_t wi = u >> 5;
    const int32_t owner = wi / wpc;
    const int32_t lw = wi - owner * wpc;
    if (lw < k * w_sub || lw >= (k + 1) * w_sub) return false;
    return (__ldg(f_sub + owner * w_sub + (lw - k * w_sub)) >> (u & 31)) &
           1u;
  }
};

template <class Test>
__device__ __forceinline__ void gather_min(
    const int32_t* __restrict__ jc, const int32_t* __restrict__ cp,
    const int32_t* __restrict__ nzc, const int32_t* __restrict__ row_idx,
    int32_t* __restrict__ cand, unsigned long long* __restrict__ examined,
    int32_t cap_nzc, int64_t cap, int32_t chunk, int32_t n,
    int32_t blocks_per_strip, Test in_front) {
  using Scan = cub::BlockScan<int32_t, kBlock>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int32_t s_off[kBlock];
  __shared__ int32_t s_start[kBlock];
  __shared__ int32_t s_col[kBlock];
  const int32_t strip = blockIdx.x / blocks_per_strip;
  const int32_t slot0 = (blockIdx.x - strip * blocks_per_strip) * kBlock;
  const int32_t nz = __ldg(nzc + strip);
  if (slot0 >= nz) return;                      // uniform across the block
  const int32_t slot = slot0 + threadIdx.x;
  int32_t len = 0, start = 0, u = n;
  if (slot < nz) {
    u = __ldg(jc + (int64_t)strip * cap_nzc + slot);
    if (u < n && in_front(u)) {
      const int64_t c = (int64_t)strip * (cap_nzc + 1) + slot;
      start = __ldg(cp + c);
      len = __ldg(cp + c + 1) - start;
    }
  }
  if (!__syncthreads_or(len > 0)) return;
  int32_t off, total;
  Scan(scan_tmp).ExclusiveSum(len, off, total);
  s_off[threadIdx.x] = off;
  s_start[threadIdx.x] = start;
  s_col[threadIdx.x] = u;
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(examined, (unsigned long long)total);
  const int32_t* ridx = row_idx + (int64_t)strip * cap;
  int32_t* c = cand + (int64_t)strip * chunk;
  for (int32_t e = threadIdx.x; e < total; e += kBlock) {
    // largest t with s_off[t] <= e: the live column holding edge e
    // (empty slots share their offset with the next one and lose)
    int32_t lo = 0, hi = kBlock - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (s_off[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int32_t v = __ldg(ridx + s_start[lo] + (e - s_off[lo]));
    atomicMin(c + v, s_col[lo]);
  }
}

inline int launch_grid(int p, int cap_nzc, int* blocks_per_strip,
                       unsigned* grid) {
  *blocks_per_strip = (cap_nzc + kBlock - 1) / kBlock;
  const int64_t g = (int64_t)p * *blocks_per_strip;
  if (g <= 0 || g >= (1ll << 31)) return 0;
  *grid = (unsigned)g;
  return 1;
}

}  // namespace strip
