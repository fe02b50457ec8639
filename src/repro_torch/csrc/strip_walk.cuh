// The strip SpMSV shared by spmsv_strip_min.cu (kernel 3: the whole
// (n/32,) frontier bitmap) and spmsv_strip_chunk_min.cu (kernel 4: one
// step of the pipelined expand): for each of the p strips, the smallest
// frontier column with an edge into each of its rows.  A min is order
// independent, so the atomics are bit-identical to the reference
// scatter-min.
//
// Two launches from one C call (launch_walks), which read nothing from
// the host:
//   1. prep_kernel<Words>: the set bits of the frontier words are
//      compacted into a device list of global ids with a device count
//      (warp-aggregated atomics; the list holds list_cap ids and the
//      count runs on past it).  ``Words`` maps word w to its first id
//      and may give the first blocks a job of their own (kernel 4's
//      search of each (strip, owner) slot range).
//   2. walk_kernel<Cols>, on a persistent grid fixed by the card: every
//      block reads the count and takes the same walk.
//        - frontier walk (count <= list_cap): each (strip, id) pair
//          binary-searches the id in jc[s, :nzc[s]];
//        - column walk (a larger frontier): ``Cols`` cuts the jc slots
//          that can be live into 256-slot tiles, each slot tested
//          against its word.
//      Blocks claim their pairs or tiles unit by unit from a device
//      counter, so a block held up by a hub holds up nothing behind it,
//      and a frontier of few pairs gets a block a pair.  A block's found
//      segments go through one block-wide gather (block_gather), so a
//      hub column of 10^5 edges is spread over 256 threads, each with
//      kGatherDepth row loads in flight.  stats[2] reports the walk
//      taken (1 frontier, 2 column) beside stats[0], the edges
//      examined.
// list_cap is the caller's walk threshold (kernels/spmsv/strip.py::
// list_capacity): the frontier walk's count*L binary-search probes per
// strip against the column walk's slots.
//
// Layout: all p strips stack with a common capacity (jc (p, cap_nzc),
// cp (p, cap_nzc+1), row_idx (p, cap), cand (p, nr)); every strip base
// is 64-bit, since p*cap passes 2^31 at scale 24.
//
// Kernel 1 (spmsv_csr_min.cu) runs prep_kernel, claim and block_gather
// under a walk of its own, whose frontier and column walks look each
// segment up through one of its three addressings.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace walk {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kGatherDepth = 4;     // row loads in flight a thread
constexpr int kClaimsPerBlock = 16; // claims a block, about, on large walks
constexpr int kWalkMinBlocks = 8;   // walk blocks resident on an SM

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

// the stacked strips and their candidates
struct Strips {
  const int32_t* jc;
  const int32_t* cp;
  const int32_t* nzc;
  const int32_t* row_idx;
  int32_t* cand;
  int32_t p, cap_nzc, nr;
  int64_t cap;
};

// block_gather's shared arrays; ``Off`` types a block's edge offsets
// (kernel 1 takes int64: its strip entry's segments from several strips
// can pass 2^31 edges together)
template <class Off>
struct GatherT {
  using Scan = cub::BlockScan<Off, kBlock>;
  typename Scan::TempStorage scan;
  Off off[kBlock];
  int32_t col[kBlock];
  int32_t cbase[kBlock];
  int64_t start[kBlock];
};
using Gather = GatherT<int32_t>;

// Every thread brings one segment (len 0 for none): column ``u`` of
// strip ``strip`` with its edges at row_idx[strip, start:start+len].
// The block scans the lengths and strides over all their edges
// together, atomicMin-ing u into the strip's candidate of each edge's
// row; the block's edge total goes to ``examined``.  Called by every
// thread of the block; ends with the block in step.
template <class Off>
__device__ __forceinline__ void block_gather(
    GatherT<Off>& sh, const Strips& g, int32_t u, int32_t strip,
    int32_t start, int32_t len, unsigned long long* examined) {
  if (!__syncthreads_or(len > 0)) return;
  Off off, total;
  typename GatherT<Off>::Scan(sh.scan).ExclusiveSum((Off)len, off, total);
  sh.off[threadIdx.x] = off;
  sh.col[threadIdx.x] = u;
  sh.cbase[threadIdx.x] = strip * g.nr;
  sh.start[threadIdx.x] = (int64_t)strip * g.cap + start;
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(examined, (unsigned long long)total);
  // kGatherDepth edges a thread a round: their row loads are in flight
  // together before the atomics
  for (Off e0 = threadIdx.x; e0 < total; e0 += kGatherDepth * kBlock) {
    int32_t v[kGatherDepth], col[kGatherDepth], cb[kGatherDepth];
#pragma unroll
    for (int i = 0; i < kGatherDepth; ++i) {
      const Off e = e0 + i * kBlock;
      v[i] = -1;
      if (e < total) {
        // largest t with off[t] <= e: the segment holding edge e (empty
        // segments share their offset with the next one and lose)
        int32_t lo = 0, hi = kBlock - 1;
        while (lo < hi) {
          const int32_t mid = (lo + hi + 1) >> 1;
          if (sh.off[mid] <= e) lo = mid; else hi = mid - 1;
        }
        v[i] = __ldg(g.row_idx + sh.start[lo] + (e - sh.off[lo]));
        col[i] = sh.col[lo];
        cb[i] = sh.cbase[lo];
      }
    }
#pragma unroll
    for (int i = 0; i < kGatherDepth; ++i)
      if (v[i] >= 0) atomicMin(g.cand + cb[i] + v[i], col[i]);
  }
  __syncthreads();          // the next call rewrites the shared arrays
}

// the block's next work unit from the device counter ``next``: thread 0
// takes it, every thread returns it
__device__ __forceinline__ int64_t claim(unsigned long long* next,
                                         int64_t* s_unit) {
  __syncthreads();          // every thread has read the last unit
  if (threadIdx.x == 0) *s_unit = (int64_t)atomicAdd(next, 1ull);
  __syncthreads();
  return *s_unit;
}

// the segment of slot ``slot`` of strip ``s`` (column u): start and length
__device__ __forceinline__ void segment(const Strips& g, int32_t s,
                                        int32_t slot, int32_t* start,
                                        int32_t* len) {
  const int32_t* c = g.cp + (int64_t)s * (g.cap_nzc + 1) + slot;
  *start = __ldg(c);
  *len = __ldg(c + 1) - *start;
}

// Prep: blocks [0, f.prelude_blocks()) run the Words' own job, the rest
// compact the set bits of the n_words frontier words, one word a
// thread, into ids[0, list_cap) with the count in stats[1].
template <class Words>
__global__ void __launch_bounds__(kBlock) prep_kernel(
    Words f, int64_t n_words, int32_t* __restrict__ ids, int32_t list_cap,
    unsigned long long* __restrict__ stats) {
  const int32_t pre = f.prelude_blocks();
  if ((int32_t)blockIdx.x < pre) {
    f.prelude(blockIdx.x);
    return;
  }
  const int32_t lane = threadIdx.x & 31;
  const int64_t w = (int64_t)(blockIdx.x - pre) * kBlock + threadIdx.x;
  uint32_t bits = w < n_words ? f.word(w) : 0u;
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
  const int32_t id0 = f.first_id(w);
  unsigned long long pos = base + (unsigned long long)(incl - c);
  while (bits) {
    const int32_t b = __ffs(bits) - 1;
    bits &= bits - 1;
    if (pos < (unsigned long long)list_cap) ids[pos] = id0 + b;
    ++pos;
  }
}

// the frontier walk: all strip-major (strip, id) pairs, ``per`` a block
// a round, in units of ``rounds`` rounds claimed from ``next``; ``per``
// spreads a frontier of few pairs over one pair a block (a hub's
// segment gets a block of its own) and takes up to a block's width of
// them when there are more than the grid holds
__device__ __forceinline__ void frontier_walk(
    Gather& sh, const Strips& g, const int32_t* __restrict__ ids, int64_t n,
    unsigned long long* examined, unsigned long long* next,
    int64_t* s_unit) {
  const int64_t pairs = n * g.p;
  const int64_t per =
      min((int64_t)kBlock, max((int64_t)1, (pairs + gridDim.x - 1) /
                                               (int64_t)gridDim.x));
  const int64_t n_rounds = (pairs + per - 1) / per;
  const int64_t rounds = max((int64_t)1, n_rounds / ((int64_t)gridDim.x *
                                                     kClaimsPerBlock));
  const int64_t units = (n_rounds + rounds - 1) / rounds;
  for (int64_t w = claim(next, s_unit); w < units;
       w = claim(next, s_unit)) {
    for (int64_t r = w * rounds; r < min(n_rounds, (w + 1) * rounds); ++r) {
      const int64_t q = r * per + threadIdx.x;
      int32_t u = 0, s = 0, start = 0, len = 0;
      if (threadIdx.x < per && q < pairs) {
        s = (int32_t)(q / n);
        u = __ldg(ids + (q - (int64_t)s * n));
        const int32_t* jcs = g.jc + (int64_t)s * g.cap_nzc;
        const int32_t nz = __ldg(g.nzc + s);
        const int32_t slot = lower_bound(jcs, nz, u);
        if (slot < nz && __ldg(jcs + slot) == u) segment(g, s, slot, &start,
                                                         &len);
      }
      block_gather(sh, g, u, s, start, len, examined);
    }
  }
}

// one 256-slot tile of the column walk: slots [slot0, end) of strip s
// (end may lie past slot0 + kBlock), ``aux`` for the Cols' live test
struct Tile {
  int32_t s, slot0, end, aux;
};

// Walk: the walk the count picks.  ``Cols`` gives the column walk's
// tiles: n_tiles(shared, sh) (block-wide, may use sh.scan), tile(shared,
// t) and live(tile, u), the frontier test of a column in the tile.
template <class Cols>
__global__ void __launch_bounds__(kBlock, kWalkMinBlocks) walk_kernel(
    Strips g, Cols cols, const int32_t* __restrict__ ids, int32_t list_cap,
    unsigned long long* __restrict__ stats) {
  __shared__ Gather sh;
  __shared__ typename Cols::Shared cs;
  __shared__ int64_t s_unit;
  const unsigned long long count = stats[1];
  const bool frontier = count <= (unsigned long long)list_cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) stats[2] = frontier ? 1 : 2;
  if (frontier) {
    frontier_walk(sh, g, ids, (int64_t)count, stats, stats + 3, &s_unit);
    return;
  }
  // units of ``per`` consecutive tiles, about kClaimsPerBlock a block,
  // claimed from stats[3]: a block held up by a hub column's tile does
  // not hold up the tiles behind it
  const int64_t n_tiles = cols.n_tiles(cs, sh, g);
  const int64_t per = max((int64_t)1, n_tiles / ((int64_t)gridDim.x *
                                                 kClaimsPerBlock));
  const int64_t units = (n_tiles + per - 1) / per;
  for (int64_t w = claim(stats + 3, &s_unit); w < units;
       w = claim(stats + 3, &s_unit)) {
    for (int64_t t = w * per; t < min(n_tiles, (w + 1) * per); ++t) {
      const Tile tl = cols.tile(cs, g, t);
      if (tl.slot0 >= tl.end) continue;         // uniform across the block
      const int32_t slot = tl.slot0 + threadIdx.x;
      int32_t u = 0, start = 0, len = 0;
      if (slot < tl.end) {
        u = __ldg(g.jc + (int64_t)tl.s * g.cap_nzc + slot);
        if (cols.live(tl, u)) segment(g, tl.s, slot, &start, &len);
      }
      block_gather(sh, g, u, tl.s, start, len, stats);
    }
  }
}

// one wave of resident walk blocks, found once per device and instance
template <class Cols>
int walk_grid() {
  static int waves[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (waves[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, walk_kernel<Cols>, kBlock, 0) != cudaSuccess)
      return 0;
    waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return waves[dev];
}

// The two launches.  stats: (4,) int64 zeroed by the caller: [0] edges
// examined, [1] the frontier count, [2] the walk taken, [3] the walk's
// work counter; ids: list_cap int32 of scratch.  Returns a cudaError_t.
template <class Words, class Cols>
int launch_walks(const Strips& g, const Words& f, int64_t n_words,
                 const Cols& cols, int32_t* ids, int32_t list_cap,
                 void* stats, cudaStream_t st) {
  if (g.p <= 0 || n_words < 0 || list_cap < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = walk_grid<Cols>();
  if (grid == 0) return (int)cudaGetLastError();
  const int64_t prep_blocks =
      f.prelude_blocks() + (n_words + kBlock - 1) / kBlock;
  if (prep_blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto* s64 = (unsigned long long*)stats;
  if (prep_blocks > 0) {
    prep_kernel<Words><<<(unsigned)prep_blocks, kBlock, 0, st>>>(
        f, n_words, ids, list_cap, s64);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  walk_kernel<Cols><<<grid, kBlock, 0, st>>>(g, cols, ids, list_cap, s64);
  return (int)cudaGetLastError();
}

}  // namespace walk
