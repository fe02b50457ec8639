// Kernel 8b, the table gradient of the table-batched EmbeddingBag
// (kernel 8): for each table row r,
//   dtable[r] = sum over the (bag b, slot j) with ids[b,j] -> r of
//               w[b,j] * (dout[b] / den[b] under "mean", else dout[b]),
// the terms taken in their flat order b * L + j, in float32, rounded once
// to the table's dtype; zero for a row that no bag reads.  A pad (id < 0)
// adds nothing; an id at or past V lands on row V-1, the row the forward
// read.  The gradient is dense, (V, D), as jax.grad gives it.
//
// Replaces no TPU kernel of its own: the JAX package differentiates the
// lookup with XLA (jax.grad of jnp.take, src/repro/models/embedding.py:55)
// around the forward Pallas kernel
// src/repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_kernel
// (pl.pallas_call at :41), and the port's forward is a hand-written kernel
// (csrc/embedding_bag.cu), so its gradient is one too.
//
// Bound on the card: bytes.  The ids and dout read once and the dense
// (V, D) output written once; at AutoInt's training lookup (2,555,904
// ids, 11,238,400 x 16 float32 rows) the output is 719 MB of the 893 MB.
//
// What the first design lost (4.7x its bound at that lookup): its plain
// torch prep read two counts back to the host (nonzero, then
// unique_consecutive), the wrapper zero-filled the whole table, and the
// kernel then wrote every live row a second time.
//
// This design: four C entries, all on the device, nothing read back, and
// every output byte written once.
// 1. embedding_bag_bwd_keys, one thread a term: its key, the row it reads
//    (min(id, V-1)), or V for a pad.  Under "mean" the first B threads
//    also write each bag's divisor: its weights added in slot order with
//    one rounded add each, clamped below at 1e-9 (a NaN stays NaN), as
//    ref.bag_denominators does.
// 2. embedding_bag_bwd_sort: a stable LSD radix sort of the keys, 8 bits
//    a pass over the bits of V (three passes below 2^24 rows), the values
//    each term's flat position b * L + j as int32, built from the
//    identity.  A row's terms keep their flat order, and the pads (key V)
//    sort last and drop out.
// 3. embedding_bag_bwd_tiles cuts the rows into tiles, one a block, by
//    rows plus terms (a merge path): a tile holds at most C = ops.
//    tile_items rows and terms together (480 at D = 16 float32), so a
//    block of empty rows writes about 30 KB and one of dense rows stages
//    about 450 terms.  Fixed tiles of rows left the blocks of AutoInt's
//    2,000-row fields (33 terms a row) walking 130 terms a row group in
//    turn while the others had none.
// 4. embedding_bag_bwd: a block owns its tile's rows and writes each of
//    them exactly once, so the output is torch.empty.  It marks in shared
//    memory where each row's terms start, reading the tile's keys once,
//    and loads their positions beside them.  Where the terms fit the
//    stage (kStage floats, C of them and a sixteenth over), the block
//    issues all their gathers at once (``lanes`` threads a term, kUnroll
//    terms a thread in flight), stages each term's value w * dout[b] /
//    den[b] in shared memory, then ``lanes`` threads own a row (16 bytes
//    each where the row allows: vec 4 float32, 8 bf16, else 1;
//    ops.layout), 256 / lanes rows side by side, and sum its staged terms
//    in order, or write zeros.  A tile of more terms (a row of many) has
//    each row's lanes walk its terms from device memory, kUnroll gathers
//    in flight.  Staging replaced a design whose row groups walked their
//    rows' terms in turn, two dependent loads a term: a block then waited
//    on its slowest group.
// No atomics: a row belongs to one group of lanes, so its sum's order is
// fixed (deterministic, and equal to the plain version's index_add_ in
// flat order on the CPU).  The arithmetic is the plain version's, element
// by element: one rounded division under "mean", one rounded multiply and
// one rounded add a term (__fdiv_rn/__fmul_rn/__fadd_rn, no FMA
// contraction), so the two agree bit for bit.
//
// A row with many terms is summed by its own lanes in flat order: the
// float32 sum's order is fixed, so its terms cannot be split between
// threads, and the row's time grows with its count (kUnroll gathers in
// flight).  Its tile holds it alone or with a few short rows.  AutoInt's
// rows hold about 33 of the 2,555,904 terms on average in its 2,000-row
// fields, its densest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;     // terms whose loads are in flight together
constexpr int kMaxTile = 1024;  // a tile's items at most (ops.MAX_ITEMS)
constexpr int kStage = 8192;    // floats of staged terms a block holds
constexpr int kMaxStaged = 1024;  // terms it stages at most

template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* x) { x[0] = __ldg(p); }
  __device__ static void store(float* p, const float* x) { *p = x[0]; }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    x[0] = __bfloat162float(p[0]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct KeyArgs {
  const int32_t* ids;     // (B, L), -1 = pad
  const float* weights;   // (B, L) or null (all 1)
  int32_t* keys;          // (n,) out: min(id, V-1), V for a pad
  float* den;             // (B,) out under "mean", else null
  int64_t n, B;
  int32_t L, V;
};

__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_keys_kernel(
    const KeyArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i < a.n) {
    const int32_t id = __ldg(a.ids + i);
    a.keys[i] = id < 0 ? a.V : min(id, a.V - 1);
  }
  if (a.den != nullptr && i < a.B) {
    float wsum = 0.0f;
    for (int32_t j = 0; j < a.L; ++j) {
      float w = __ldg(a.ids + i * a.L + j) >= 0 ? 1.0f : 0.0f;
      if (a.weights != nullptr)
        w = __fmul_rn(__ldg(a.weights + i * a.L + j), w);
      wsum = __fadd_rn(wsum, w);
    }
    const float tiny = (float)1e-9;
    a.den[i] = wsum < tiny ? tiny : wsum;
  }
}

// x's exclusive prefix over the block's threads in thread order, and the
// block's total (every thread of the block calls it)
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x,
                                                        int32_t* total) {
  __shared__ int32_t warp_sum[kBlock / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

// ---------------------------------------------------------------- sort
// A stable LSD radix sort of the keys, 8 bits a pass, the values each
// term's flat position (pass 0 starts from the identity).  A pass is
// three kernels: each block counts the digits of its 4096 keys
// (radix_count), each digit's counts are scanned over the blocks
// (radix_scan), and each block scatters its keys in order (radix_scatter):
// a key's place is its digit's start, plus the keys of that digit in the
// blocks before, plus those before it in its block.  In the block, each
// warp ranks its 512 keys in order (eight ballots, 32 at a time) and
// the warps' counts are added up a digit; the tile is sorted in shared
// memory and written out in that order, so a digit's keys go out as one
// run of consecutive places.
constexpr int kBins = 256;
constexpr int kSortItems = 16;  // keys a thread holds
constexpr int kSortTile = kBlock * kSortItems;
static_assert(kBins == kBlock, "a thread a digit");

__global__ void __launch_bounds__(kBlock) radix_count(
    const int32_t* keys, int32_t* hist, int32_t n, int shift, int nb) {
  __shared__ int32_t count[kBins];
  count[threadIdx.x] = 0;
  __syncthreads();
  const int32_t base = blockIdx.x * kSortTile + threadIdx.x;
  int32_t k[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int32_t idx = base + r * kBlock;
    k[r] = idx < n ? __ldg(keys + idx) : -1;
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r)
    if (k[r] >= 0) atomicAdd(&count[(k[r] >> shift) & (kBins - 1)], 1);
  __syncthreads();
  hist[threadIdx.x * nb + blockIdx.x] = count[threadIdx.x];
}

// block d: digit d's counts over the nb blocks, scanned in place
// (exclusive); its total into totals[d]
__global__ void __launch_bounds__(kBlock) radix_scan(int32_t* hist,
                                                     int32_t* totals,
                                                     int nb) {
  int32_t* row = hist + (int64_t)blockIdx.x * nb;
  int32_t carry = 0;
  for (int c0 = 0; c0 < nb; c0 += kBlock) {
    const int c = c0 + threadIdx.x;
    int32_t total;
    const int32_t x = c < nb ? row[c] : 0;
    const int32_t before = block_exclusive_scan(x, &total);
    if (c < nb) row[c] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kBlock) radix_scatter(
    const int32_t* keys_in, const int32_t* pos_in, int32_t* keys_out,
    int32_t* pos_out, const int32_t* hist, const int32_t* totals, int32_t n,
    int shift, int nb) {
  constexpr int kWarps = kBlock / 32, kRun = kSortTile / kWarps;
  __shared__ int32_t sk[kSortTile];    // the tile's keys, sorted
  __shared__ int16_t src[kSortTile];   // each one's place in the input
  __shared__ int16_t rank[kSortTile];  // by input place: its warp rank
  __shared__ int32_t at[kWarps][kBins];  // a warp's next place of a digit
  __shared__ int32_t out_at[kBins];      // global place of tile place 0
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) at[w][threadIdx.x] = 0;
  // warp w holds the tile's keys [w * kRun, (w + 1) * kRun), in order
  const int32_t tile0 = blockIdx.x * kSortTile;
  const int32_t mine = warp * kRun + lane;  // + 32 r: the r-th key's place
  int32_t k[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int32_t idx = tile0 + mine + r * 32;
    k[r] = idx < n ? __ldg(keys_in + idx) : -1;
  }
  __syncthreads();
  // each key's rank among its warp's keys of its digit, in order
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int digit = k[r] >= 0 ? (k[r] >> shift) & (kBins - 1) : kBins;
    // the lanes of the same digit: eight ballots, one a bit
    unsigned peers = __ballot_sync(0xffffffffu, digit < kBins);
    if (digit == kBins) peers = ~peers;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const unsigned vote = __ballot_sync(0xffffffffu, (digit >> bit) & 1);
      peers &= (digit >> bit) & 1 ? vote : ~vote;
    }
    const int leader = __ffs(peers) - 1;
    int32_t before = 0;
    if (lane == leader && digit < kBins) {
      before = at[warp][digit];
      at[warp][digit] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[mine + r * 32] =
        (int16_t)(before + __popc(peers & ((1u << lane) - 1)));
    __syncwarp();
  }
  __syncthreads();
  // thread d: digit d's place in the tile, warp by warp, and in the output
  int32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count += at[w][threadIdx.x];
  int32_t unused;
  int32_t place = block_exclusive_scan(count, &unused);
  const int32_t digit_start = block_exclusive_scan(totals[threadIdx.x],
                                                   &unused);
  out_at[threadIdx.x] =
      digit_start + hist[threadIdx.x * nb + blockIdx.x] - place;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t c = at[w][threadIdx.x];
    at[w][threadIdx.x] = place;
    place += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    if (k[r] >= 0) {
      const int32_t q = at[warp][(k[r] >> shift) & (kBins - 1)]
                        + rank[mine + r * 32];
      sk[q] = k[r];
      src[q] = (int16_t)(mine + r * 32);
    }
  }
  __syncthreads();
  // the tile in digit order: a digit's keys go to consecutive places;
  // every value's load is issued before any is written
  const int32_t tile_n = min(kSortTile, n - tile0);
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int32_t q = threadIdx.x + r * kBlock;
    const int32_t from = tile0 + src[q < tile_n ? q : 0];
    k[r] = q < tile_n && pos_in != nullptr ? __ldg(pos_in + from) : from;
  }
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int32_t q = threadIdx.x + r * kBlock;
    if (q < tile_n) {
      const int32_t key = sk[q];
      const int32_t dst = out_at[(key >> shift) & (kBins - 1)] + q;
      keys_out[dst] = key;
      pos_out[dst] = k[r];
    }
  }
}

// ---------------------------------------------------------------- tiles
constexpr int kTileItems = 4;  // terms a thread of the tile kernel takes

struct TileArgs {
  const int32_t* keys;    // (n,) sorted keys
  int2* bounds;           // (n_tiles + 1,) out: (first row, first term)
  int32_t n, V, items, n_tiles;
};

// The tiles cut the sequence of V + 1 row marks (row V the end) and the
// n_live terms, each row's mark before its terms (row r's mark at
// s(r) = r + the terms with a key below r, term i of row k at k + i + 1),
// every ``items`` places, each cut moved on to the next row's mark: tile
// b owns the rows whose marks lie in [b * items, (b + 1) * items), so a
// tile holds at most ``items`` rows, and at most ``items`` terms but for
// its last row's.  bounds[b] = (its first row, that row's first term).
// Term i in [0, n] (kTileItems a thread) finds the cuts at the marks of
// the rows (key[i-1], key[i]] (whose first term is i), term n (or the
// first pad) also every cut past the end; the block's threads write all
// their cuts together, so a long run of empty rows is spread over the
// block.  A cut at the place of one of row k's terms is (k + 1, the end
// of row k's terms), written by the row's last term.  Each entry is
// written once.
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_tiles_kernel(
    const TileArgs a) {
  // 32-bit places throughout (the entry checks V + n + 2 items < 2^31):
  // a 64-bit division costs several times a 32-bit one
  constexpr int kItems = kTileItems * kBlock;
  __shared__ int32_t first_cut[kItems];
  __shared__ int32_t cut_at[kItems + 1];
  const uint32_t items = a.items;
  const int32_t i0 = (blockIdx.x * kBlock + threadIdx.x) * kTileItems;
  // key[u + 1] is term i0 + u's key, key[0] its predecessor's; V past
  // the end
  int32_t key[kTileItems + 2];
#pragma unroll
  for (int u = 0; u <= kTileItems + 1; ++u) {
    const int32_t i = i0 + u - 1;
    key[u] = i < 0 ? -1 : i < a.n ? __ldg(a.keys + i) : a.V;
  }
  int32_t cuts[kTileItems], mine = 0;
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    // marks s(r) = r + i of rows r in (key[u], key[u + 1]]: the cuts
    // b * items there
    const int32_t i = i0 + u;
    const int32_t prev = key[u], cur = key[u + 1];
    uint32_t first = 0;
    cuts[u] = 0;
    if (i <= a.n && prev < cur) {
      first = prev + i < 0 ? 0 : (uint32_t)(prev + i) / items + 1;
      const uint32_t last =
          cur == a.V ? a.n_tiles : (uint32_t)(cur + i) / items;
      cuts[u] = last >= first ? (int32_t)(last - first + 1) : 0;
    }
    first_cut[threadIdx.x * kTileItems + u] = (int32_t)first;
    mine += cuts[u];
  }
  int32_t total;
  int32_t at = block_exclusive_scan(mine, &total);
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    cut_at[threadIdx.x * kTileItems + u] = at;
    at += cuts[u];
  }
  if (threadIdx.x == 0) cut_at[kItems] = total;
  __syncthreads();
  // the block's cuts written together: a long run of empty rows is spread
  // over the block
  for (int32_t j = threadIdx.x; j < total; j += kBlock) {
    int lo = 0, hi = kItems;  // the last term whose cuts start at or before j
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cut_at[mid] <= j) lo = mid; else hi = mid;
    }
    const int32_t b = first_cut[lo] + (j - cut_at[lo]);
    const int32_t t = blockIdx.x * kItems + lo;
    a.bounds[b] = make_int2(min(b * a.items - t, a.V), t);
  }
  // the cuts at the places of a row's terms, written by its last term j:
  // the multiples c of items in (k + first, k + j + 1] (row k's terms
  // [first, j] at k + i + 1), found from the top, one load each
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    const int32_t j = i0 + u;
    const int32_t k = key[u + 1];
    if (j < a.n && k < a.V && key[u + 2] != k) {
      for (int32_t c = (int32_t)((uint32_t)(k + j + 1) / items * items);
           c - k - 1 >= 0 && __ldg(a.keys + c - k - 1) == k; c -= a.items)
        a.bounds[(uint32_t)c / items] = make_int2(k + 1, j + 1);
    }
  }
}

// ------------------------------------------------------------- gradient
struct Args {
  const void* dout;       // (B, D) in T
  const int32_t* keys;    // (n,) sorted keys
  const int32_t* pos;     // (n,) each sorted term's flat position b*L + j
  const int2* bounds;     // (gx + 1,) each tile's first row and term
  const float* weights;   // (B, L) or null (all 1)
  const float* den;       // (B,) under "mean", else null
  void* dtable;           // (V, D) in T, every row written here
  int32_t L, V, D, n_vec, lanes;
};

// One term's value w * (dout[b] / den[b]) on V elements of the row
// slice at d0: the plain version's operations, rounded one at a time.
template <typename T, int V>
__device__ __forceinline__ void load_term(const Args& a, int32_t f,
                                          int32_t d0, float* x) {
  const int64_t b = f / a.L;
  const float w = a.weights != nullptr ? __ldg(a.weights + f) : 1.0f;
  Vec<T, V>::load((const T*)a.dout + b * a.D + d0, x);
  const float den = a.den != nullptr ? __ldg(a.den + b) : 1.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (a.den != nullptr) x[v] = __fdiv_rn(x[v], den);
    x[v] = __fmul_rn(w, x[v]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kBlock) embedding_bag_bwd_kernel(
    const Args a) {
  __shared__ int32_t start[kMaxTile + 1];  // a row's first term
  __shared__ int32_t spos[kMaxStaged];     // a staged term's position
  __shared__ __align__(16) float stage[kStage];  // its value, the slice
  const int2 b0 = a.bounds[blockIdx.x], b1 = a.bounds[blockIdx.x + 1];
  const int32_t r0 = b0.x, rows = b1.x - b0.x, lo = b0.y, hi = b1.y;
  const int32_t width = a.lanes * V;  // elements of a staged term
  const bool staged = hi - lo <= min(kStage / width, kMaxStaged);
  // start[t] = the first term of [lo, hi) whose row is >= r0 + t, each
  // entry written once: a term writes the rows from its predecessor's
  // (exclusive) to its own, and the rows past the last term get hi
  for (int32_t k = lo + threadIdx.x; k < hi; k += kBlock) {
    const int32_t cur = __ldg(a.keys + k) - r0;
    const int32_t prev = k == lo ? -1 : __ldg(a.keys + k - 1) - r0;
    for (int32_t t = prev + 1; t <= cur; ++t) start[t] = k;
    if (staged) spos[k - lo] = __ldg(a.pos + k);
  }
  const int32_t last = hi > lo ? __ldg(a.keys + hi - 1) - r0 : -1;
  for (int32_t t = last + 1 + threadIdx.x; t <= rows; t += kBlock)
    start[t] = hi;
  __syncthreads();

  const int32_t per_pass = kBlock / a.lanes;
  const int32_t slot = threadIdx.x / a.lanes;
  const int32_t lane = threadIdx.x - slot * a.lanes;
  const int32_t vec = blockIdx.y * a.lanes + lane;
  const bool active = slot < per_pass && vec < a.n_vec;
  const int32_t d0 = vec * V;
  T* out = (T*)a.dtable + (int64_t)r0 * a.D + d0;
  if (staged) {
    // every term's loads at once, kUnroll a thread in flight, its value
    // staged; then each row sums its staged terms in flat order
    const int32_t terms = hi - lo;
    if (active) {
      for (int32_t k = slot; k < terms; k += per_pass * kUnroll) {
        float x[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t q = k + u * per_pass;
          if (q < terms) load_term<T, V>(a, spos[q], d0, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t q = k + u * per_pass;
          if (q < terms) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              stage[q * width + lane * V + v] = x[u][v];
          }
        }
      }
    }
    __syncthreads();
    if (!active) return;
    for (int32_t t = slot; t < rows; t += per_pass) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      for (int32_t q = start[t] - lo; q < start[t + 1] - lo; ++q) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], stage[q * width + lane * V + v]);
      }
      Vec<T, V>::store(out + (int64_t)t * a.D, acc);
    }
    return;
  }
  // more terms than the stage holds: each row's lanes walk its terms,
  // kUnroll loads in flight
  if (!active) return;
  for (int32_t t = slot; t < rows; t += per_pass) {
    const int32_t k0 = start[t], k1 = start[t + 1];
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int32_t p = k0; p < k1; p += kUnroll) {
      float x[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t q = p + u < k1 ? p + u : k0;
        load_term<T, V>(a, __ldg(a.pos + q), d0, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u < k1) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], x[u][v]);
        }
      }
    }
    Vec<T, V>::store(out + (int64_t)t * a.D, acc);
  }
}

template <typename T, int V>
int launch(const Args& a, long long gx, int gy, cudaStream_t stream) {
  if ((long long)gy * a.lanes < a.n_vec || gx < 1 || gx >= (1ll << 31)
      || gy > 65535)
    return (int)cudaErrorInvalidValue;
  embedding_bag_bwd_kernel<T, V>
      <<<dim3((unsigned)gx, gy), kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// a: the key kernel's 9 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py::prepare_backward): ids, weights (0 for
// none), keys, den (0 unless "mean"), n = B * L, B, L, V, stream.  One
// thread a term and, under "mean", a bag.
extern "C" int embedding_bag_bwd_keys(const long long* a) {
  KeyArgs args;
  args.ids = (const int32_t*)a[0];
  args.weights = (const float*)a[1];
  args.keys = (int32_t*)a[2];
  args.den = (float*)a[3];
  args.n = a[4];
  args.B = a[5];
  args.L = (int32_t)a[6];
  args.V = (int32_t)a[7];
  const auto st = (cudaStream_t)a[8];
  if (args.n < 0 || args.B < 0 || args.L < 0 || args.V < 1
      || args.n != args.B * args.L || args.n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long threads =
      args.den != nullptr && args.B > args.n ? args.B : args.n;
  if (threads == 0) return (int)cudaGetLastError();
  embedding_bag_bwd_keys_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock),
                                  kBlock, 0, st>>>(args);
  return (int)cudaGetLastError();
}

// a: the sort's 11 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py::sort_keys): keys (the key kernel's, read
// by pass 0 and then free), keys_a, keys_b, pos_a, pos_b, hist (256 x nb,
// nb = ceil(n / 4096)), totals (256), n, bits, stream, and 0.  Pass p of
// the ceil(bits / 8) passes writes keys_a/pos_a when p is even, else
// keys_b/pos_b; keys_b may be the input keys.
extern "C" int embedding_bag_bwd_sort(const long long* a) {
  const int32_t* keys = (const int32_t*)a[0];
  int32_t* out_k[2] = {(int32_t*)a[1], (int32_t*)a[2]};
  int32_t* out_p[2] = {(int32_t*)a[3], (int32_t*)a[4]};
  int32_t* hist = (int32_t*)a[5];
  int32_t* totals = (int32_t*)a[6];
  const long long n = a[7], bits = a[8];
  const auto st = (cudaStream_t)a[9];
  if (n < 0 || n >= (1ll << 31) - kSortTile || bits < 1 || bits > 31)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int nb = (int)((n + kSortTile - 1) / kSortTile);
  const int32_t* in_k = keys;
  const int32_t* in_p = nullptr;
  for (int p = 0; p * 8 < bits; ++p) {
    radix_count<<<nb, kBlock, 0, st>>>(in_k, hist, (int32_t)n, p * 8, nb);
    radix_scan<<<kBins, kBlock, 0, st>>>(hist, totals, nb);
    radix_scatter<<<nb, kBlock, 0, st>>>(in_k, in_p, out_k[p % 2],
                                         out_p[p % 2], hist, totals,
                                         (int32_t)n, p * 8, nb);
    in_k = out_k[p % 2];
    in_p = out_p[p % 2];
  }
  return (int)cudaGetLastError();
}

// a: the tile kernel's 6 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py::tile_bounds): keys (sorted), bounds (an
// int2 each, n_tiles + 1 of them), n, V, items, stream, with n_tiles =
// ceil((V + 1 + n) / items), the most the marks and terms can fill.
// n + 1 terms, kTileItems a thread.
extern "C" int embedding_bag_bwd_tiles(const long long* a) {
  TileArgs args;
  args.keys = (const int32_t*)a[0];
  args.bounds = (int2*)a[1];
  const long long n = a[2], rows = a[3], items = a[4];
  const auto st = (cudaStream_t)a[5];
  if (n < 0 || rows < 1 || items < 1 || items > kMaxTile
      || n + rows + 2 * items >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  args.n = (int32_t)n;
  args.V = (int32_t)rows;
  args.items = (int32_t)items;
  args.n_tiles = (int32_t)((rows + 1 + n + items - 1) / items);
  const long long per_block = kBlock * kTileItems;
  embedding_bag_bwd_tiles_kernel<<<(unsigned)((n + per_block) / per_block),
                                   kBlock, 0, st>>>(args);
  return (int)cudaGetLastError();
}

// a: the gradient kernel's 16 values as int64, packed by the wrapper
// (kernels/embedding_bag/ops.py::launch_backward): dout, keys, pos,
// bounds, weights (0 for none), den (0 unless "mean"), dtable, L, V, D,
// bf16, vec, lanes, gx, gy, stream.  keys and pos are the key kernel's
// keys stable-sorted and the sort's permutation, bounds the tile kernel's
// (gx + 1 of them) at ops.tile_items; vec and lanes as for the forward
// entry (ops.layout), with dout and dtable 16-byte aligned for vec > 1.
extern "C" int embedding_bag_bwd(const long long* a) {
  Args args;
  args.dout = (const void*)a[0];
  args.keys = (const int32_t*)a[1];
  args.pos = (const int32_t*)a[2];
  args.bounds = (const int2*)a[3];
  args.weights = (const float*)a[4];
  args.den = (const float*)a[5];
  args.dtable = (void*)a[6];
  const long long L = a[7], rows = a[8], D = a[9];
  const int bf16 = (int)a[10], vec = (int)a[11];
  args.lanes = (int32_t)a[12];
  const long long gx = a[13];
  const int gy = (int)a[14];
  const auto st = (cudaStream_t)a[15];
  if (rows < 1 || D < 1) return (int)cudaGetLastError();
  if (rows >= (1ll << 31) || L < 0 || L >= (1ll << 31) || args.lanes < 1
      || args.lanes > kBlock || vec < 1 || D % vec || D >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  args.L = L < 1 ? 1 : (int32_t)L;
  args.V = (int32_t)rows;
  args.D = (int32_t)D;
  args.n_vec = args.D / vec;
  if (bf16) {
    if (vec == 8) return launch<__nv_bfloat16, 8>(args, gx, gy, st);
    if (vec == 1) return launch<__nv_bfloat16, 1>(args, gx, gy, st);
  } else {
    if (vec == 4) return launch<float, 4>(args, gx, gy, st);
    if (vec == 1) return launch<float, 1>(args, gx, gy, st);
  }
  return (int)cudaErrorInvalidValue;
}
