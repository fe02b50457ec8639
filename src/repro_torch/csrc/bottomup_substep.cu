// One bottom-up sub-step (Alg. 4, lines 10-16) over row segments: for
// every row not yet completed, the smallest global source id among its
// in-neighbours that are in the frontier bitmap, else INT_MAX.  One
// launch covers either one rotated row segment of a 2D block (p = 1) or
// all p row strips of a 1D bottom-up level, stacked: rp (p, chunk+1),
// ue (p, ue_stride), cvec and out (p, chunk), and the strips' edge counts
// as a (p,) device array, so the launch reads nothing from the host.
//
// Replaces the TPU kernel
// src/repro/kernels/bottomup/bottomup.py::bottomup_substep_kernel
// (pl.pallas_call at :89).  The TPU kernel scanned row TILES with a
// tile-wide early exit, because a per-row break does not vectorize on its
// lanes.  CSR rows are sorted by ascending source (graph/formats.py keeps
// the (row, source) sort order), so the first hit in source order IS the
// minimum; every walk below keeps that order, and the result is
// bit-identical to the reference scatter-min.
//
// Bound on the card: bytes (chip_smoke.py::bottomup_bytes is the
// yardstick).  A completed row needs its flag, its two pointers and its
// output word; a live row also its edges up to the first hit, each with
// one frontier word (the bitmap is n/8 bytes and stays in L2).
//
// What the first design lost: one warp per row, 16.8M warps a launch on
// the 2D path's 2^24 rows, nearly all of them completed rows that only
// load a flag and store INT_MAX.  The card holds 8,448 warps at once, so
// a launch ran about 1,986 waves of two dependent trips to memory each
// (about 1.15 us a wave): bound by the life of a warp, 33x its bytes.
//
// This design:
//   * a warp owns 32 consecutive rows: lane i loads cvec[r0+i] and its
//     row pointers in one coalesced 128-byte read each and stores its
//     result in one coalesced write, so a completed row costs its bytes
//     at full bandwidth and 32x fewer warps exist;
//   * the grid is persistent (one wave: SMs x resident blocks) and
//     grid-strides over the row groups of all strips, loading the next
//     group's flags and pointers before walking the current one;
//   * a live row first goes one row per lane: its first kLaneEdges = 4
//     edges are loaded together, then their frontier words together, and
//     the lowest hit wins; a row that is longer and still unresolved then
//     goes warp-cooperative, 32 edges a step with a ballot early exit.
//     4 was the fastest of 0 (warp-cooperative only), 1, 2, 4, 8 and 16
//     on the scale-24 paths (PERF.md, findings).
//
// The edges it loads, counted (kCount, a non-null `loaded`): each live
// lane's head loads (up to kLaneEdges) and every in-range lane of each
// 32-wide walk step it runs, kept in a register over the warp's row
// groups, summed over the warp at its end and added with one atomicAdd a
// warp (an atomic a row group would be some 500k on one word in a
// 2^24-row launch, serialised).  The instance without the count is the
// kernel as it was: the same loads, stores and grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kIntInf = 0x7fffffff;
constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneEdges = 4;   // edges a lane walks before the warp does

struct Rows {        // one lane's row of a group
  int32_t cv, lo, hi;
};

__device__ __forceinline__ Rows load_rows(const int32_t* __restrict__ rp,
                                          const int32_t* __restrict__ cvec,
                                          int64_t g, int32_t gps,
                                          int32_t chunk, int32_t lane) {
  Rows x{1, 0, 0};
  const int32_t s = (int32_t)(g / gps);
  const int32_t r = (int32_t)(g - (int64_t)s * gps) * 32 + lane;
  if (r < chunk) {
    x.cv = __ldg(cvec + (int64_t)s * chunk + r);
    const int32_t* p = rp + (int64_t)s * (chunk + 1) + r;
    x.lo = __ldg(p);
    x.hi = __ldg(p + 1);
  }
  return x;
}

__device__ __forceinline__ bool in_front(const uint32_t* __restrict__ fw,
                                         int32_t u) {
  return (__ldg(fw + (u >> 5)) >> (u & 31)) & 1u;
}

template <bool kCount>
__global__ void __launch_bounds__(kBlock) bottomup_substep_kernel(
    const int32_t* __restrict__ rp, const int32_t* __restrict__ ue,
    const uint32_t* __restrict__ fw, const int32_t* __restrict__ cvec,
    int32_t* __restrict__ out, const int32_t* __restrict__ n_edges_dev,
    int32_t p, int32_t chunk, int64_t ue_stride, int32_t col_offset,
    int32_t n_edges, unsigned long long* __restrict__ loaded) {
  const int32_t lane = threadIdx.x & 31;
  const int32_t gps = (chunk + 31) >> 5;             // row groups a strip
  const int64_t n_groups = (int64_t)p * gps;
  const int64_t step = ((int64_t)gridDim.x * kBlock) >> 5;
  int64_t g = ((int64_t)blockIdx.x * kBlock + threadIdx.x) >> 5;
  Rows next{1, 0, 0};
  uint32_t n_loaded = 0;                // this lane's loads (kCount only)
  if (g < n_groups) next = load_rows(rp, cvec, g, gps, chunk, lane);
  for (; g < n_groups; g += step) {             // uniform across the warp
    const Rows cur = next;
    if (g + step < n_groups)
      next = load_rows(rp, cvec, g + step, gps, chunk, lane);
    const int32_t s = (int32_t)(g / gps);
    const int32_t r = (int32_t)(g - (int64_t)s * gps) * 32 + lane;
    const int32_t ne = n_edges_dev ? __ldg(n_edges_dev + s) : n_edges;
    const int32_t lo = cur.lo, hi = min(cur.hi, ne);
    const bool live = r < chunk && cur.cv == 0 && lo < hi;
    const int32_t* __restrict__ ues = ue + (int64_t)s * ue_stride;
    int32_t res = kIntInf;
    if (__any_sync(kFull, live)) {
      // one row per lane: the first kLaneEdges edges' loads issued
      // together, then their frontier words together; the lowest hit wins
      int32_t head[kLaneEdges];
      uint32_t word[kLaneEdges];
#pragma unroll
      for (int t = 0; t < kLaneEdges; ++t)
        head[t] = (live && lo + t < hi) ? __ldg(ues + lo + t) : -1;
      if (kCount && live) n_loaded += min(hi - lo, kLaneEdges);
#pragma unroll
      for (int t = 0; t < kLaneEdges; ++t)
        word[t] = head[t] >= 0 ? __ldg(fw + (head[t] >> 5)) : 0u;
#pragma unroll
      for (int t = kLaneEdges - 1; t >= 0; --t)
        if (head[t] >= 0 && ((word[t] >> (head[t] & 31)) & 1u))
          res = col_offset + head[t];
      // rows longer than kLaneEdges and unresolved: the warp walks each
      // in turn, 32 edges a step, and stops at the first step with a hit
      unsigned todo = __ballot_sync(kFull, live && res == kIntInf &&
                                               hi - lo > kLaneEdges);
      while (todo) {
        const int32_t src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int32_t rlo = __shfl_sync(kFull, lo, src) + kLaneEdges;
        const int32_t rhi = __shfl_sync(kFull, hi, src);
        int32_t found = kIntInf;
        for (int32_t e0 = rlo; e0 < rhi; e0 += 32) {
          const int32_t e = e0 + lane;
          int32_t u = 0;
          bool hit = false;
          if (e < rhi) {
            u = __ldg(ues + e);
            hit = in_front(fw, u);
            if (kCount) ++n_loaded;
          }
          const unsigned ballot = __ballot_sync(kFull, hit);
          if (ballot) {
            found = col_offset + __shfl_sync(kFull, u, __ffs(ballot) - 1);
            break;
          }
        }
        if (lane == src) res = found;
      }
    }
    if (r < chunk) out[(int64_t)s * chunk + r] = res;
  }
  if (kCount) {                         // every lane of the warp is here
    const uint32_t warp_loaded = __reduce_add_sync(kFull, n_loaded);
    if (lane == 0 && warp_loaded)
      atomicAdd(loaded, (unsigned long long)warp_loaded);
  }
}

template <bool kCount>
cudaError_t resident_blocks(int dev, int* out) {
  // one wave of resident blocks of this instance, found once per device
  static int waves[64] = {0};
  if (waves[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bottomup_substep_kernel<kCount>, kBlock, 0);
    if (err != cudaSuccess) return err;
    waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = waves[dev];
  return cudaSuccess;
}

cudaError_t launch(const int32_t* rp, const int32_t* ue, const uint32_t* fw,
                   const int32_t* cvec, int32_t* out, const int32_t* ne_dev,
                   int p, int chunk, long long ue_stride, int col_offset,
                   int n_edges, unsigned long long* loaded,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  int waves = 0;
  err = loaded ? resident_blocks<true>(dev, &waves)
               : resident_blocks<false>(dev, &waves);
  if (err != cudaSuccess) return err;
  const int64_t groups = (int64_t)p * ((chunk + 31) / 32);
  const int64_t need = (groups * 32 + kBlock - 1) / kBlock;
  const int grid = (int)(need < waves ? need : waves);
  if (loaded)
    bottomup_substep_kernel<true><<<grid, kBlock, 0, stream>>>(
        rp, ue, fw, cvec, out, ne_dev, p, chunk, (int64_t)ue_stride,
        col_offset, n_edges, loaded);
  else
    bottomup_substep_kernel<false><<<grid, kBlock, 0, stream>>>(
        rp, ue, fw, cvec, out, ne_dev, p, chunk, (int64_t)ue_stride,
        col_offset, n_edges, nullptr);
  return cudaGetLastError();
}

}  // namespace

// n_edges_dev: (p,) int32 device edge counts, or null to use n_edges for
// every strip.  loaded: one int64 device word the kernel adds the edges
// it loads to, or null to count nothing.  Returns cudaGetLastError().
extern "C" int bottomup_substep(const void* rp, const void* ue,
                                const void* f_words, const void* cvec,
                                void* out, const void* n_edges_dev, int p,
                                int chunk, long long ue_stride,
                                int col_offset, int n_edges, void* loaded,
                                void* stream) {
  if (p <= 0 || chunk <= 0) return (int)cudaGetLastError();
  return (int)launch((const int32_t*)rp, (const int32_t*)ue,
                     (const uint32_t*)f_words, (const int32_t*)cvec,
                     (int32_t*)out, (const int32_t*)n_edges_dev, p, chunk,
                     ue_stride, col_offset, n_edges,
                     (unsigned long long*)loaded, (cudaStream_t)stream);
}
