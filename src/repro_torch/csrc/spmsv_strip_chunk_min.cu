// Top-down local discovery of the 1D strips for one step k of the
// software-pipelined expand: for each strip, the smallest frontier
// column with an edge into each of its rows, where the frontier is the
// raw owner-major (p * w_sub,) sub-chunk words of step k (owner o's
// words of its local range [k*w_sub, (k+1)*w_sub) at [o*w_sub,
// (o+1)*w_sub)), so no full-size bitmap is built.  The caller
// min-combines the candidates of the n_chunks steps, which is exact
// under the min; a min is order independent, so the atomics are
// bit-identical to the reference scatter-min.
//
// Replaces the TPU kernel
// src/repro/kernels/spmsv/strip.py::gather_strip_segments_chunk
// (pl.pallas_call at :139) and the scatter-min after it.
//
// Bound on the card: bytes, as chip_smoke.py::strip_bytes charges them:
// nzc; per strip the cheaper of the walk of its jc and one jc word per
// frontier column looked up; the cp pair of each live column; one row
// id per live edge; the frontier words once; the candidates written
// once.
//
// What the first design lost: every step walked every strip's whole jc
// (p x cap_nzc/256 blocks, an integer division per slot), although only
// the columns of step k's sub-ranges can be live, and top-down levels
// are by construction the small-frontier levels of the
// direction-optimizing search: 18x its bound.
//
// This design, two launches from one C call:
//   1. prep: the set bits of the sub-chunk words are compacted into a
//      device list of global ids, o*chunk + k*sub + local, with a device
//      count (warp-aggregated atomics; the list holds list_cap ids and
//      the count runs on past it); the first blocks also find, a warp
//      for each (strip, owner) pair, the jc slot range of step k's
//      sub-range by a 32-way search (jc ascends within a strip).
//   2. walk, on a persistent grid fixed by the card: every block reads
//      the count and takes the same walk, so the launch reads nothing
//      from the host.
//        - frontier walk (count <= list_cap): each (id, strip) pair
//          binary-searches the id in jc[s, :nzc[s]];
//        - column walk (a larger frontier): every block scans the
//          ranges' 256-slot tile counts and grid-strides over the tiles,
//          1/C of the slots, each slot tested against its word.
//      Either way a block's found segments go through one block-wide
//      gather (strip_walk.cuh), so a hub column is spread over 256
//      threads.  stats[2] reports the walk taken (1 frontier, 2 column)
//      beside stats[0], the edges examined.
// At most kMaxStrips strips (the tile prefix sits in shared memory).
// list_cap is the caller's walk threshold (kernels/spmsv/strip.py::
// list_capacity): the frontier walk's count*L binary-search probes per
// strip against the column walk's cap_nzc/C slots.
#include "strip_walk.cuh"

namespace {

using walk::kBlock;
constexpr int kMaxStrips = 32;
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock) prep_kernel(
    const uint32_t* __restrict__ f_sub, int64_t n_words, int32_t w_sub,
    int32_t chunk, int32_t k, int32_t* __restrict__ ids, int32_t list_cap,
    unsigned long long* __restrict__ stats, const int32_t* __restrict__ jc,
    const int32_t* __restrict__ nzc, int32_t cap_nzc, int32_t p,
    int32_t range_blocks, int32_t* __restrict__ ranges) {
  const int32_t sub = w_sub * 32;
  const int32_t lane = threadIdx.x & 31;
  if ((int32_t)blockIdx.x < range_blocks) {
    // a warp per (strip, owner): step k's slot range in jc[s, :nzc[s]]
    const int32_t q = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (q >= p * p) return;
    const int32_t s = q / p, o = q - s * p;
    const int32_t* jcs = jc + (int64_t)s * cap_nzc;
    const int32_t nz = __ldg(nzc + s);
    const int32_t x = o * chunk + k * sub;
    const int32_t lo = walk::warp_lower_bound(jcs, nz, x);
    const int32_t hi = lo + walk::warp_lower_bound(jcs + lo, nz - lo,
                                                   x + sub);
    if (lane == 0) {
      ranges[2 * q] = lo;
      ranges[2 * q + 1] = hi;
    }
    return;
  }
  const int64_t w = (int64_t)(blockIdx.x - range_blocks) * kBlock +
                    threadIdx.x;
  uint32_t bits = w < n_words ? __ldg(f_sub + w) : 0u;
  const int32_t c = __popc(bits);
  int32_t incl = c;
#pragma unroll
  for (int32_t d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int32_t warp_total = __shfl_sync(0xffffffffu, incl, 31);
  unsigned long long base = 0;
  if (lane == 31 && warp_total > 0)
    base = atomicAdd(stats + 1, (unsigned long long)warp_total);
  base = __shfl_sync(0xffffffffu, base, 31);
  if (bits == 0) return;
  const int32_t owner = (int32_t)(w / w_sub);
  const int32_t id0 = owner * chunk + k * sub +
                      (int32_t)(w - (int64_t)owner * w_sub) * 32;
  unsigned long long pos = base + (unsigned long long)(incl - c);
  while (bits) {
    const int32_t b = __ffs(bits) - 1;
    bits &= bits - 1;
    if (pos < (unsigned long long)list_cap) ids[pos] = id0 + b;
    ++pos;
  }
}

__global__ void __launch_bounds__(kBlock) walk_kernel(
    const int32_t* __restrict__ jc, const int32_t* __restrict__ cp,
    const int32_t* __restrict__ nzc, const int32_t* __restrict__ row_idx,
    const uint32_t* __restrict__ f_sub, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ ranges,
    unsigned long long* __restrict__ stats, int32_t* cand, int32_t cap_nzc,
    int64_t cap, int32_t nr, int32_t chunk, int32_t p, int32_t w_sub,
    int32_t k, int32_t list_cap) {
  __shared__ walk::Gather sh;
  __shared__ int32_t tile_off[kMaxStrips * kMaxStrips + 1];
  const int32_t sub = w_sub * 32;
  const unsigned long long count = stats[1];
  const bool frontier = count <= (unsigned long long)list_cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) stats[2] = frontier ? 1 : 2;
  if (frontier) {
    const int64_t n = (int64_t)count;
    const int64_t pairs = n * p;                 // strip-major (s, id)
    for (int64_t b = (int64_t)blockIdx.x * kBlock; b < pairs;
         b += (int64_t)gridDim.x * kBlock) {
      const int64_t q = b + threadIdx.x;
      int32_t u = 0, s = 0, start = 0, len = 0;
      if (q < pairs) {
        s = (int32_t)(q / n);
        u = __ldg(ids + (q - (int64_t)s * n));
        const int32_t* jcs = jc + (int64_t)s * cap_nzc;
        const int32_t nz = __ldg(nzc + s);
        const int32_t slot = walk::lower_bound(jcs, nz, u);
        if (slot < nz && __ldg(jcs + slot) == u) {
          const int32_t* c = cp + (int64_t)s * (cap_nzc + 1) + slot;
          start = __ldg(c);
          len = __ldg(c + 1) - start;
        }
      }
      walk::block_gather(sh, u, s, start, len, row_idx, cap, cand, nr,
                         stats);
    }
    return;
  }
  // the exclusive prefix of the (strip, owner) ranges' tile counts
  const int32_t units = p * p;
  int32_t carry = 0;
  for (int32_t q0 = 0; q0 < units; q0 += kBlock) {
    const int32_t q = q0 + threadIdx.x;
    const int32_t tiles = q < units ? (__ldg(ranges + 2 * q + 1) -
                                       __ldg(ranges + 2 * q) + kBlock - 1) /
                                          kBlock
                                    : 0;
    int32_t excl, total;
    walk::Gather::Scan(sh.scan).ExclusiveSum(tiles, excl, total);
    if (q < units) tile_off[q] = carry + excl;
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_off[units] = carry;
  __syncthreads();
  const int32_t n_tiles = tile_off[units];
  for (int32_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // the unit holding tile t: the largest q with tile_off[q] <= t (an
    // empty unit shares its offset with the next one and loses)
    int32_t lo = 0, hi = units - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (tile_off[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int32_t s = lo / p, o = lo - s * p;
    const int32_t slot = __ldg(ranges + 2 * lo) + (t - tile_off[lo]) * kBlock +
                         threadIdx.x;
    int32_t u = 0, start = 0, len = 0;
    if (slot < __ldg(ranges + 2 * lo + 1)) {
      u = __ldg(jc + (int64_t)s * cap_nzc + slot);
      const int32_t loc = u - o * chunk - k * sub;      // in [0, sub)
      if ((__ldg(f_sub + o * w_sub + (loc >> 5)) >> (loc & 31)) & 1u) {
        const int32_t* c = cp + (int64_t)s * (cap_nzc + 1) + slot;
        start = __ldg(c);
        len = __ldg(c + 1) - start;
      }
    }
    walk::block_gather(sh, u, s, start, len, row_idx, cap, cand, nr,
                       stats);
  }
}

int walk_grid() {
  // one wave of resident blocks, found once per device
  static int waves[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (waves[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel,
                                                      kBlock, 0) !=
            cudaSuccess)
      return 0;
    waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return waves[dev];
}

}  // namespace

// chunk = n/p sets the ids (o*chunk + k*sub + local), nr the stride of
// the (p, nr) candidates.  stats: (3,) int64 zeroed by the caller: [0]
// edges examined, [1] the frontier count, [2] the walk taken.  scratch:
// int32, list_cap ids, then 2*p*p range bounds.
extern "C" int spmsv_strip_chunk_min(const void* jc, const void* cp,
                                     const void* nzc, const void* row_idx,
                                     const void* f_sub, void* cand,
                                     void* stats, void* scratch, int p,
                                     int cap_nzc, long long cap, int nr,
                                     int chunk, int w_sub, int k,
                                     int list_cap, void* stream) {
  if (p <= 0 || p > kMaxStrips || w_sub <= 0 || list_cap < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = walk_grid();
  if (grid == 0) return (int)cudaGetLastError();
  auto* ids = (int32_t*)scratch;
  int32_t* ranges = ids + list_cap;
  const int64_t n_words = (int64_t)p * w_sub;
  const int32_t range_blocks = (p * p + kWarps - 1) / kWarps;
  const int64_t prep_blocks = range_blocks + (n_words + kBlock - 1) / kBlock;
  if (prep_blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  auto* s64 = (unsigned long long*)stats;
  prep_kernel<<<(unsigned)prep_blocks, kBlock, 0, st>>>(
      (const uint32_t*)f_sub, n_words, w_sub, chunk, k, ids, list_cap, s64,
      (const int32_t*)jc, (const int32_t*)nzc, cap_nzc, p, range_blocks,
      ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<grid, kBlock, 0, st>>>(
      (const int32_t*)jc, (const int32_t*)cp, (const int32_t*)nzc,
      (const int32_t*)row_idx, (const uint32_t*)f_sub, ids, ranges, s64,
      (int32_t*)cand, cap_nzc, (int64_t)cap, nr, chunk, p, w_sub, k,
      list_cap);
  return (int)cudaGetLastError();
}
