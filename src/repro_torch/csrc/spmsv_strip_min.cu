// Top-down local discovery of the 1D strips against the whole
// allgathered frontier bitmap (n bits): for each strip, the smallest
// frontier column with an edge into each of its rows.
//
// Replaces the TPU kernel
// src/repro/kernels/spmsv/strip.py::gather_strip_segments
// (pl.pallas_call at :66) and the scatter-min after it
// (src/repro/kernels/spmsv/ops.py::_scatter_min, col_offset = 0).  The
// TPU kernel wrote a (cap_nzc, maxdeg) scratch of gathered rows,
// gigabytes at scale 24; here nothing but the candidates is written.
//
// Bound on the card: bytes, as chip_smoke.py::strip_bytes charges them:
// nzc; per strip the cheaper of the walk of its jc and one jc word per
// frontier column looked up; the cp pair of each live column; one row
// id per live edge; the frontier words once; the candidates written
// once.  On the direction-optimizing path it is almost all the one
// write of the (p, nr) candidates.
//
// What the first design lost: every launch tested every jc slot of
// every strip against the bitmap, about 0.35 ms at scale 24 whatever
// the frontier, although top-down levels are by construction the
// small-frontier levels.
//
// This design is kernel 4's (spmsv_strip_chunk_min.cu) at one step: the
// shared prep and walks of strip_walk.cuh with
//   - FullBitmap words: bit b of word w is id 32w + b; no prelude;
//   - StripColumns: the column walk covers each strip's whole [0,
//     nzc[s]) in p x ceil(cap_nzc/256) tiles, a tile past nzc[s] left
//     at once, so it needs no slot ranges and no tile prefix, and takes
//     any number of strips.
#include "strip_walk.cuh"

namespace {

using walk::kBlock;

struct FullBitmap {
  const uint32_t* fw;
  __host__ __device__ int32_t prelude_blocks() const { return 0; }
  __device__ void prelude(int32_t) const {}
  __device__ uint32_t word(int64_t w) const { return __ldg(fw + w); }
  __device__ int32_t first_id(int64_t w) const { return (int32_t)(w * 32); }
};

struct StripColumns {
  const uint32_t* fw;
  int32_t n, tiles_per_strip;
  struct Shared {};

  __device__ int64_t n_tiles(Shared&, walk::Gather&,
                             const walk::Strips& g) const {
    return (int64_t)g.p * tiles_per_strip;
  }
  __device__ walk::Tile tile(const Shared&, const walk::Strips& g,
                             int64_t t) const {
    const int32_t s = (int32_t)(t / tiles_per_strip);
    return {s, (int32_t)(t - (int64_t)s * tiles_per_strip) * kBlock,
            __ldg(g.nzc + s), 0};
  }
  __device__ bool live(const walk::Tile&, int32_t u) const {
    return u < n && ((__ldg(fw + (u >> 5)) >> (u & 31)) & 1u);
  }
};

}  // namespace

// n = 32 * the bitmap's words; nr the stride of the (p, nr) candidates.
// stats: (4,) int64 zeroed by the caller: [0] edges examined, [1] the
// frontier count, [2] the walk taken, [3] the walk's work counter.  ids:
// list_cap int32 of scratch.
extern "C" int spmsv_strip_min(const void* jc, const void* cp,
                               const void* nzc, const void* row_idx,
                               const void* fw, void* cand, void* stats,
                               void* ids, int p, int cap_nzc, long long cap,
                               int nr, int n, int list_cap, void* stream) {
  if (n < 0 || n % 32 || cap_nzc < 0) return (int)cudaErrorInvalidValue;
  const walk::Strips g{(const int32_t*)jc, (const int32_t*)cp,
                       (const int32_t*)nzc, (const int32_t*)row_idx,
                       (int32_t*)cand, p, cap_nzc, nr, (int64_t)cap};
  const FullBitmap f{(const uint32_t*)fw};
  const StripColumns cols{(const uint32_t*)fw, n,
                          (cap_nzc + kBlock - 1) / kBlock};
  return walk::launch_walks(g, f, (int64_t)n / 32, cols, (int32_t*)ids,
                            list_cap, stats, (cudaStream_t)stream);
}
