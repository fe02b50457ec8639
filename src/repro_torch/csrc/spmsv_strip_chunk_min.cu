// Top-down local discovery of the 1D strips for one step k of the
// software-pipelined expand: for each strip, the smallest frontier
// column with an edge into each of its rows, where the frontier is the
// raw owner-major (p * w_sub,) sub-chunk words of step k (owner o's
// words of its local range [k*w_sub, (k+1)*w_sub) at [o*w_sub,
// (o+1)*w_sub)), so no full-size bitmap is built.  The caller
// min-combines the candidates of the n_chunks steps, which is exact
// under the min.
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
// What the first design lost: every step walked every strip's whole jc,
// although only the columns of step k's sub-ranges can be live, and
// top-down levels are by construction the small-frontier levels of the
// direction-optimizing search: 18x its bound.
//
// This design is the shared prep and walks of strip_walk.cuh with:
//   - SubChunk words: owner o's bit j of step k is global id o*chunk +
//     k*sub + j; the prep's first blocks also find, a warp for each
//     (strip, owner) pair, the jc slot range of step k's sub-range by a
//     32-way search (jc ascends within a strip);
//   - RangeColumns: the column walk scans the ranges' 256-slot tile
//     counts and walks only their tiles, 1/C of the slots.
// At most kMaxStrips strips (the tile prefix sits in shared memory).
#include "strip_walk.cuh"

namespace {

using walk::kBlock;
using walk::kWarps;
constexpr int kMaxStrips = 32;

struct SubChunk {
  const uint32_t* f_sub;
  const int32_t* jc;
  const int32_t* nzc;
  int32_t* ranges;               // (p*p, 2) slot bounds, written here
  int32_t p, cap_nzc, chunk, w_sub, k, range_blocks;

  __host__ __device__ int32_t prelude_blocks() const { return range_blocks; }
  __device__ uint32_t word(int64_t w) const { return __ldg(f_sub + w); }
  __device__ int32_t first_id(int64_t w) const {
    const int32_t owner = (int32_t)(w / w_sub);
    return owner * chunk + k * w_sub * 32 +
           (int32_t)(w - (int64_t)owner * w_sub) * 32;
  }
  // a warp per (strip, owner): step k's slot range in jc[s, :nzc[s]]
  __device__ void prelude(int32_t block) const {
    const int32_t q = block * kWarps + (threadIdx.x >> 5);
    if (q >= p * p) return;
    const int32_t s = q / p, o = q - s * p;
    const int32_t* jcs = jc + (int64_t)s * cap_nzc;
    const int32_t nz = __ldg(nzc + s);
    const int32_t x = o * chunk + k * w_sub * 32;
    const int32_t lo = walk::warp_lower_bound(jcs, nz, x);
    const int32_t hi =
        lo + walk::warp_lower_bound(jcs + lo, nz - lo, x + w_sub * 32);
    if ((threadIdx.x & 31) == 0) {
      ranges[2 * q] = lo;
      ranges[2 * q + 1] = hi;
    }
  }
};

struct RangeColumns {
  const uint32_t* f_sub;
  const int32_t* ranges;
  int32_t p, chunk, w_sub, k;
  struct Shared {
    int32_t tile_off[kMaxStrips * kMaxStrips + 1];
  };

  // the exclusive prefix of the (strip, owner) ranges' tile counts
  __device__ int64_t n_tiles(Shared& cs, walk::Gather& sh,
                             const walk::Strips&) const {
    const int32_t units = p * p;
    int32_t carry = 0;
    for (int32_t q0 = 0; q0 < units; q0 += kBlock) {
      const int32_t q = q0 + threadIdx.x;
      const int32_t tiles =
          q < units ? (__ldg(ranges + 2 * q + 1) - __ldg(ranges + 2 * q) +
                       kBlock - 1) / kBlock
                    : 0;
      int32_t excl, total;
      walk::Gather::Scan(sh.scan).ExclusiveSum(tiles, excl, total);
      if (q < units) cs.tile_off[q] = carry + excl;
      carry += total;
      __syncthreads();
    }
    if (threadIdx.x == 0) cs.tile_off[units] = carry;
    __syncthreads();
    return cs.tile_off[units];
  }
  __device__ walk::Tile tile(const Shared& cs, const walk::Strips&,
                             int64_t t) const {
    // the unit holding tile t: the largest q with tile_off[q] <= t (an
    // empty unit shares its offset with the next one and loses)
    int32_t lo = 0, hi = p * p - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (cs.tile_off[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int32_t s = lo / p;
    return {s, __ldg(ranges + 2 * lo) + ((int32_t)t - cs.tile_off[lo]) *
                                            kBlock,
            __ldg(ranges + 2 * lo + 1), lo - s * p};
  }
  __device__ bool live(const walk::Tile& tl, int32_t u) const {
    const int32_t o = tl.aux;
    const int32_t loc = u - o * chunk - k * w_sub * 32;    // in [0, sub)
    return (__ldg(f_sub + o * w_sub + (loc >> 5)) >> (loc & 31)) & 1u;
  }
};

}  // namespace

// chunk = n/p sets the ids (o*chunk + k*sub + local), nr the stride of
// the (p, nr) candidates.  stats: (4,) int64 zeroed by the caller: [0]
// edges examined, [1] the frontier count, [2] the walk taken, [3] the
// walk's work counter.  scratch: int32, list_cap ids, then 2*p*p range
// bounds.
extern "C" int spmsv_strip_chunk_min(const void* jc, const void* cp,
                                     const void* nzc, const void* row_idx,
                                     const void* f_sub, void* cand,
                                     void* stats, void* scratch, int p,
                                     int cap_nzc, long long cap, int nr,
                                     int chunk, int w_sub, int k,
                                     int list_cap, void* stream) {
  if (p <= 0 || p > kMaxStrips || w_sub <= 0 || list_cap < 0)
    return (int)cudaErrorInvalidValue;
  auto* ids = (int32_t*)scratch;
  int32_t* ranges = ids + list_cap;
  const walk::Strips g{(const int32_t*)jc, (const int32_t*)cp,
                       (const int32_t*)nzc, (const int32_t*)row_idx,
                       (int32_t*)cand, p, cap_nzc, nr, (int64_t)cap};
  const SubChunk f{(const uint32_t*)f_sub, (const int32_t*)jc,
                   (const int32_t*)nzc, ranges, p, cap_nzc, chunk, w_sub, k,
                   (p * p + kWarps - 1) / kWarps};
  const RangeColumns cols{(const uint32_t*)f_sub, ranges, p, chunk, w_sub,
                          k};
  return walk::launch_walks(g, f, (int64_t)p * w_sub, cols, ids, list_cap,
                            stats, (cudaStream_t)stream);
}
