// Top-down local discovery: SpMSV in the (select-source, min) semiring
// over the CSC column segments of the frontier columns.  One walk, three
// ways of addressing a segment, three C entries:
//
//   spmsv_csr_min         a 2D block through its uncompressed col_ptr[u]
//   spmsv_dcsc_min        a 2D block through the DCSC (jc, cp): each
//                         frontier id's binary search in jc[0, nzc) gives
//                         its slot (found when jc[slot] is the id), and
//                         the segment starts at cp[slot]
//   spmsv_strips_csr_min  all p 1D strips at once through the (p, n+1)
//                         strip col_ptr: one item per (strip, frontier
//                         id), strip-major, with 64-bit strip bases
//
// Replaces the TPU kernel src/repro/kernels/spmsv/spmsv.py::gather_segments
// (pl.pallas_call at :56) together with the scatter-min that follows it
// (src/repro/kernels/spmsv/ops.py::_scatter_min), as spmsv_block_csr,
// spmsv_block_dcsc (ops.py:36, :77) and the 1D _td_kernel_csr reach it.
// The TPU kernel wrote a (cap_f, maxdeg) scratch of gathered
// destinations; here each edge of a frontier segment does its atomicMin
// straight into the candidate vector.  A min is order independent, so
// the result is bit-identical whatever order the atomics land in.
//
// Two launches a call, and nothing read back to the host (the walks of
// kernels 3 and 4, strip_walk.cuh):
//   1. prep_kernel<FrontierWords>: the set bits of the frontier WORDS
//      (n/32 int32, not the bool mask, 8x the bytes) are compacted into
//      a device id list with the count kept on the device
//      (warp-aggregated atomics; the list holds list_cap ids and the
//      count runs on past it); its first blocks fill the candidates with
//      INT_INF.
//   2. spmsv_walk<Addressing>, on a persistent grid fixed by the card:
//      every block reads the count and takes the same walk.
//        - frontier walk (count <= list_cap): each (strip, id) pair looks
//          its segment up through the addressing;
//        - column walk (a larger frontier): the addressing's columns (its
//          jc slots for DCSC) in 256-wide tiles, each tested against its
//          frontier word.
//      Blocks claim their pairs or tiles unit by unit from a device
//      counter, so a block held up by a hub holds up nothing behind it.
//      A block's found segments go through one block-wide gather
//      (block_gather, int64 offsets), so a hub column of 10^5 edges is
//      spread over 256 threads.  The last block out writes the edges
//      examined (exact int64), the frontier count and the walk taken to
//      the caller's out[3], and zeroes the scratch counters for the next
//      call: the scratch is allocated once per shape, not once a call.
// list_cap is the caller's walk threshold (kernels/spmsv/ops.py::
// list_capacity).
//
// Bound on the card: bytes.  The frontier words are read once; each
// frontier column reads its pointer pair (DCSC: its binary search in jc)
// and one row id an edge; the candidates are written once.  The reads
// of row_idx are contiguous within a segment; the atomics are
// scattered.  On the direction-optimizing path the top-down frontiers
// are small, and the one write of the candidates dominates.
#include "strip_walk.cuh"

namespace {

using walk::kBlock;

constexpr int32_t kInf = 0x7fffffff;
constexpr int kFillPerThread = 8;     // int4 stores a prep thread
// walk blocks resident on an SM: 64 registers a thread, where the strip
// kernels' 8 (walk::kWalkMinBlocks) spill the int64 gather's state
constexpr int kWalkBlocksPerSm = 4;

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ fw,
                                        int32_t u) {
  return (__ldg(fw + (u >> 5)) >> (u & 31)) & 1u;
}

// The prep's words: bit b of word w is id 32w + b; the prelude blocks
// fill the n_cand candidates with INT_INF (16-byte stores; the wrapper
// allocates them, so they are aligned).
struct FrontierWords {
  const uint32_t* fw;
  int32_t* cand;
  int64_t n_cand;
  int32_t fill_blocks;
  __host__ __device__ int32_t prelude_blocks() const { return fill_blocks; }
  __device__ void prelude(int32_t b) const {
    const int64_t stride = (int64_t)fill_blocks * kBlock;
    const int64_t n4 = n_cand / 4;
    const int4 inf = make_int4(kInf, kInf, kInf, kInf);
    int4* c4 = reinterpret_cast<int4*>(cand);
    for (int64_t i = (int64_t)b * kBlock + threadIdx.x; i < n4; i += stride)
      c4[i] = inf;
    const int64_t t = 4 * n4 + (int64_t)b * kBlock + threadIdx.x;
    if (t < n_cand) cand[t] = kInf;
  }
  __device__ uint32_t word(int64_t w) const { return __ldg(fw + w); }
  __device__ int32_t first_id(int64_t w) const { return (int32_t)(w * 32); }
};

// The three addressings.  Each gives:
//   strips()                 the strips the candidates stack (1 in 2D)
//   find(s, u, start, len)   the segment of frontier id u in strip s
//                            (len 0 where there is none)
//   n_tiles()                the column walk's 256-wide tiles
//   column(fw, t, i, ...)    slot i of tile t: its strip, column and
//                            segment if the column is in the frontier
//   value(u)                 the candidate value of column u

struct Csr {
  const int32_t* col_ptr;
  int32_t n_cols, col_offset;
  __device__ int32_t strips() const { return 1; }
  __device__ void find(int32_t, int32_t u, int32_t* start,
                       int32_t* len) const {
    *start = __ldg(col_ptr + u);
    *len = __ldg(col_ptr + u + 1) - *start;
  }
  __device__ int64_t n_tiles() const { return (n_cols + kBlock - 1) / kBlock; }
  __device__ void column(const uint32_t* fw, int64_t t, int32_t i,
                         int32_t* s, int32_t* u, int32_t* start,
                         int32_t* len) const {
    const int32_t c = (int32_t)t * kBlock + i;
    *s = 0;
    *u = c;
    if (c < n_cols && bit_set(fw, c)) find(0, c, start, len);
  }
  __device__ int32_t value(int32_t u) const { return col_offset + u; }
};

struct Dcsc {
  const int32_t* jc;
  const int32_t* cp;
  const int32_t* nzc;
  int32_t n_cols, col_offset;
  __device__ int32_t strips() const { return 1; }
  __device__ void find(int32_t, int32_t u, int32_t* start,
                       int32_t* len) const {
    const int32_t nz = __ldg(nzc);
    const int32_t slot = walk::lower_bound(jc, nz, u);
    if (slot < nz && __ldg(jc + slot) == u) {
      *start = __ldg(cp + slot);
      *len = __ldg(cp + slot + 1) - *start;
    }
  }
  __device__ int64_t n_tiles() const {
    return (__ldg(nzc) + kBlock - 1) / kBlock;
  }
  __device__ void column(const uint32_t* fw, int64_t t, int32_t i,
                         int32_t* s, int32_t* u, int32_t* start,
                         int32_t* len) const {
    const int32_t slot = (int32_t)t * kBlock + i;
    *s = 0;
    *u = 0;
    if (slot >= __ldg(nzc)) return;
    *u = __ldg(jc + slot);
    if (*u < n_cols && bit_set(fw, *u)) {
      *start = __ldg(cp + slot);
      *len = __ldg(cp + slot + 1) - *start;
    }
  }
  __device__ int32_t value(int32_t u) const { return col_offset + u; }
};

struct StripsCsr {
  const int32_t* col_ptr;     // (p, n+1), rows ptr_stride apart
  int64_t ptr_stride;
  int32_t p, n, tiles_per_strip;
  __device__ int32_t strips() const { return p; }
  __device__ void find(int32_t s, int32_t u, int32_t* start,
                       int32_t* len) const {
    const int32_t* c = col_ptr + (int64_t)s * ptr_stride + u;
    *start = __ldg(c);
    *len = __ldg(c + 1) - *start;
  }
  __device__ int64_t n_tiles() const {
    return (int64_t)p * tiles_per_strip;
  }
  __device__ void column(const uint32_t* fw, int64_t t, int32_t i,
                         int32_t* s, int32_t* u, int32_t* start,
                         int32_t* len) const {
    *s = (int32_t)(t / tiles_per_strip);
    const int32_t c =
        (int32_t)(t - (int64_t)*s * tiles_per_strip) * kBlock + i;
    *u = c;
    if (c < n && bit_set(fw, c)) find(*s, c, start, len);
  }
  __device__ int32_t value(int32_t u) const { return u; }
};

// scratch: [0] edges examined, [1] the frontier count, [2] the walk's
// work counter, [3] blocks done; out: edges examined, frontier count,
// walk taken (1 frontier, 2 column)
template <class A>
__global__ void __launch_bounds__(kBlock, kWalkBlocksPerSm) spmsv_walk(
    A a, walk::Strips g, const uint32_t* __restrict__ fw,
    const int32_t* __restrict__ ids, int32_t list_cap,
    unsigned long long* __restrict__ scratch, long long* __restrict__ out) {
  __shared__ walk::GatherT<int64_t> sh;
  __shared__ int64_t s_unit;
  const unsigned long long count = scratch[1];
  const bool frontier = count <= (unsigned long long)list_cap;
  unsigned long long* next = scratch + 2;
  if (frontier) {
    // all strip-major (strip, id) pairs, ``per`` a block a round, in
    // units of ``rounds`` rounds: a frontier of few pairs gets a block a
    // pair (a hub's segment a block of its own), a large one up to a
    // block's width of them a round
    const int64_t n = (int64_t)count;
    const int64_t pairs = n * a.strips();
    const int64_t per = min((int64_t)kBlock,
                            max((int64_t)1, (pairs + gridDim.x - 1) /
                                                (int64_t)gridDim.x));
    const int64_t n_rounds = (pairs + per - 1) / per;
    const int64_t rounds = max(
        (int64_t)1, n_rounds / ((int64_t)gridDim.x * walk::kClaimsPerBlock));
    const int64_t units = (n_rounds + rounds - 1) / rounds;
    for (int64_t w = walk::claim(next, &s_unit); w < units;
         w = walk::claim(next, &s_unit)) {
      for (int64_t r = w * rounds; r < min(n_rounds, (w + 1) * rounds);
           ++r) {
        const int64_t q = r * per + threadIdx.x;
        int32_t u = 0, s = 0, start = 0, len = 0;
        if (threadIdx.x < per && q < pairs) {
          s = (int32_t)(q / n);
          u = __ldg(ids + (q - (int64_t)s * n));
          a.find(s, u, &start, &len);
        }
        walk::block_gather(sh, g, a.value(u), s, start, len, scratch);
      }
    }
  } else {
    // units of ``per`` consecutive tiles, about kClaimsPerBlock a block
    const int64_t n_tiles = a.n_tiles();
    const int64_t per = max((int64_t)1, n_tiles / ((int64_t)gridDim.x *
                                                   walk::kClaimsPerBlock));
    const int64_t units = (n_tiles + per - 1) / per;
    for (int64_t w = walk::claim(next, &s_unit); w < units;
         w = walk::claim(next, &s_unit)) {
      for (int64_t t = w * per; t < min(n_tiles, (w + 1) * per); ++t) {
        int32_t s = 0, u = 0, start = 0, len = 0;
        a.column(fw, t, threadIdx.x, &s, &u, &start, &len);
        walk::block_gather(sh, g, a.value(u), s, start, len, scratch);
      }
    }
  }
  // the last block out reports and leaves the counters at 0: every block
  // read the count and made its last claim before it counted itself done
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(scratch + 3, 1ull) == gridDim.x - 1) {
      out[0] = (long long)atomicAdd(scratch, 0ull);
      out[1] = (long long)count;
      out[2] = frontier ? 1 : 2;
      scratch[0] = scratch[1] = scratch[2] = scratch[3] = 0;
    }
  }
}

// one wave of resident walk blocks, found once per device and addressing
template <class A>
int walk_grid() {
  static int waves[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (waves[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spmsv_walk<A>, kBlock, 0) != cudaSuccess)
      return 0;
    waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return waves[dev];
}

// The two launches on ``stream``; returns a cudaError_t.
template <class A>
int launch(const A& a, const walk::Strips& g, const void* fw,
           int64_t n_words, void* ids, int32_t list_cap, void* scratch,
           void* out, void* stream) {
  if (g.p <= 0 || g.nr <= 0 || n_words < 0 || list_cap < 1)
    return (int)cudaErrorInvalidValue;
  const int grid = walk_grid<A>();
  if (grid == 0) return (int)cudaGetLastError();
  const int64_t n_cand = (int64_t)g.p * g.nr;
  const int64_t per_block = (int64_t)kBlock * 4 * kFillPerThread;
  const FrontierWords f{(const uint32_t*)fw, g.cand, n_cand,
                        (int32_t)((n_cand + per_block - 1) / per_block)};
  const int64_t prep_blocks =
      f.prelude_blocks() + (n_words + kBlock - 1) / kBlock;
  if (prep_blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto* s64 = (unsigned long long*)scratch;
  const auto st = (cudaStream_t)stream;
  walk::prep_kernel<FrontierWords><<<(unsigned)prep_blocks, kBlock, 0, st>>>(
      f, n_words, (int32_t*)ids, list_cap, s64);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  spmsv_walk<A><<<grid, kBlock, 0, st>>>(a, g, (const uint32_t*)fw,
                                         (const int32_t*)ids, list_cap, s64,
                                         (long long*)out);
  return (int)cudaGetLastError();
}

walk::Strips strips_of(const void* row_idx, void* cand, int p, int nr,
                       long long ridx_stride) {
  return walk::Strips{nullptr, nullptr, nullptr, (const int32_t*)row_idx,
                      (int32_t*)cand, p, 0, nr, (int64_t)ridx_stride};
}

}  // namespace

// The three entries share one argument list; each reads what its
// addressing needs.  ptr: col_ptr (n_ptr+1,), cp (n_ptr+1,) with n_ptr =
// cap_nzc, or the (p, n_ptr+1) strip col_ptr, rows ptr_stride apart; jc,
// nzc: the DCSC's (else null); row_idx: (cap,) or (p, cap) with rows
// ridx_stride apart; fw: the n_words frontier words; cand: the (p, nr)
// candidates (p = 1 in 2D), written whole; scratch: (4,) int64 at 0, left
// at 0; ids: list_cap int32; out: (3,) int64 written by the walk.
extern "C" int spmsv_csr_min(const void* ptr, const void*, const void*,
                             const void* row_idx, const void* fw, void* cand,
                             void* scratch, void* ids, void* out, int,
                             int n_ptr, long long, long long,
                             long long n_words, int nr, int col_offset,
                             int list_cap, void* stream) {
  const Csr a{(const int32_t*)ptr, n_ptr, col_offset};
  return launch(a, strips_of(row_idx, cand, 1, nr, 0), fw, n_words, ids,
                list_cap, scratch, out, stream);
}

extern "C" int spmsv_dcsc_min(const void* ptr, const void* jc,
                              const void* nzc, const void* row_idx,
                              const void* fw, void* cand, void* scratch,
                              void* ids, void* out, int, int, long long,
                              long long, long long n_words, int nr,
                              int col_offset, int list_cap, void* stream) {
  const Dcsc a{(const int32_t*)jc, (const int32_t*)ptr,
               (const int32_t*)nzc, (int32_t)(n_words * 32), col_offset};
  return launch(a, strips_of(row_idx, cand, 1, nr, 0), fw, n_words, ids,
                list_cap, scratch, out, stream);
}

extern "C" int spmsv_strips_csr_min(const void* ptr, const void*,
                                    const void*, const void* row_idx,
                                    const void* fw, void* cand,
                                    void* scratch, void* ids, void* out,
                                    int p, int n_ptr, long long ptr_stride,
                                    long long ridx_stride, long long n_words,
                                    int nr, int, int list_cap,
                                    void* stream) {
  const StripsCsr a{(const int32_t*)ptr, (int64_t)ptr_stride, p, n_ptr,
                    (n_ptr + kBlock - 1) / kBlock};
  return launch(a, strips_of(row_idx, cand, p, nr, ridx_stride), fw,
                n_words, ids, list_cap, scratch, out, stream);
}
