// The end of one 2D level (Alg. 3 l.12-14 / Alg. 4 l.18-21) in one pass
// over the vertices: the parent update, the next frontier as packed
// words, and the three sums the level loop's direction rule and exit
// read (frontier size n_f, frontier edge mass m_f, unvisited edge mass
// m_u).  Every array is the (pr, pc, chunk) grid layout, flat: vertex
// v = (i * pc + q) * chunk + r is row r of block (i, q), and its flat
// index is its global id.
//
// The TPU program has no kernel here: XLA fused the update, the pack
// and the reductions of the JAX package's loop body.  The port ran them
// as PyTorch's generic passes: the four-pass update (pi == -1, t !=
// INT_INF, &, where), pack_bits through an int64 widening and a sum, and
// the loop's tail (two where temporaries, three reductions), some 1.9 GB
// a top-down level over 2^24 vertices where the level needs about 0.26.
//
// A level's candidates come in slots, applied in order, first find wins
// (the JAX package's loop over sub-steps):
//   slot 0     cand[v]: the folded top-down candidates, or a bottom-up
//              level's own sub-step 0 (self_par); null cand: the start
//              of a search, whose one candidate is root at v = root
//   slot s > 0 recv[b][(q + s) mod pc][r], b = i * pc + q: what the
//              bottom-up exchange delivered from sub-step s (null recv:
//              one slot)
// For every vertex with pi == -1 the first slot that is not INT_MAX
// becomes its parent, written in place: newly found.
//
// This design:
//   * a lane owns 4 consecutive vertices, read as one int4, and a warp
//     128 of one block (chunk is a multiple of 32): each of its loads is
//     512 coalesced bytes.  The lane's 4 "newly" bits are a nibble of
//     the next frontier's word v / 32 (frontier.py::pack_bits' bits);
//     eight lanes OR theirs into the word with three xor shuffles, and
//     the first of them writes it;
//   * a lane reads the candidates and degrees of its 4 only when one of
//     them is unvisited, and writes pi back only when one is newly found,
//     so late levels (most vertices visited) move little more than pi and
//     the words;
//   * a warp takes kSteps such steps a trip, their pi loads issued
//     together before any candidate load, so that enough reads are in
//     flight to fill HBM from a persistent grid (one wave: SMs x
//     resident blocks);
//   * the sums are exact int64: each lane keeps its own, the warp
//     reduces them with shuffles, the block through shared memory, and
//     one atomicAdd a sum a block adds them into the scratch.  Integer
//     adds are order-free, so the values are decomp._masses' bit for bit.
//     The last block out (its count of finished blocks, after a fence)
//     writes them to the caller's masses[3] and leaves the scratch at 0
//     for the next launch, so no fill is launched before this one.
//
// Bound on the card: bytes.  pi read once (4 B a vertex), the words
// written (1/8 B), and for each unvisited vertex its candidate slots up
// to the first find and its degree (4 B each); each newly found vertex
// writes its parent (4 B).  No flops but the integer sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kIntInf = 0x7fffffff;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 4;      // vertices a lane reads at once (one int4)
constexpr int kSteps = 2;    // 128-vertex warp steps a trip of the loop

struct Slots {
  const int32_t* __restrict__ cand;   // slot 0, or null: the root alone
  const int32_t* __restrict__ recv;   // slots 1..pc-1, or null
  int64_t root;
  int32_t pc, chunk;
};

// slot 0 of the four vertices of int4 i
__device__ __forceinline__ int4 slot0(const Slots& sl, int64_t i) {
  if (sl.cand) return __ldg(reinterpret_cast<const int4*>(sl.cand) + i);
  const int64_t v = i * kVec;
  auto at = [&](int e) { return v + e == sl.root ? (int32_t)sl.root
                                                 : kIntInf; };
  return make_int4(at(0), at(1), at(2), at(3));
}

// the first of slots 1..pc-1 of vertex v that is not INT_MAX
__device__ __forceinline__ int32_t later_slots(const Slots& sl, int64_t v) {
  const int64_t b = v / sl.chunk;
  const int32_t r = (int32_t)(v - b * sl.chunk);
  const int32_t q = (int32_t)(b % sl.pc);
  const int32_t* row = sl.recv + b * sl.pc * sl.chunk + r;
  int32_t par = kIntInf;
  for (int32_t s = 1; s < sl.pc && par == kIntInf; ++s) {
    const int32_t src = q + s < sl.pc ? q + s : q + s - sl.pc;
    par = __ldg(row + (int64_t)src * sl.chunk);
  }
  return par;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ int32_t& lane_of(int4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__global__ void __launch_bounds__(kBlock) level_epilogue_kernel(
    Slots sl, int32_t* __restrict__ pi, const int32_t* __restrict__ deg,
    uint32_t* __restrict__ words, int64_t n_vec,
    unsigned long long* __restrict__ scratch, long long* __restrict__ out) {
  const int32_t lane = threadIdx.x & 31;
  const int32_t warp = threadIdx.x >> 5;
  int4* __restrict__ pi4 = reinterpret_cast<int4*>(pi);
  const int64_t step = (int64_t)gridDim.x * kWarps * kSteps * 32;
  long long n_f = 0, m_f = 0, m_u = 0;    // this lane's sums
  for (int64_t i0 = ((int64_t)blockIdx.x * kWarps + warp) * kSteps * 32;
       i0 < n_vec; i0 += step) {          // uniform across the warp
    int4 old[kSteps], par[kSteps], d[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int64_t i = i0 + k * 32 + lane;
      old[k] = i < n_vec ? pi4[i] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int64_t i = i0 + k * 32 + lane;
      const bool any = i < n_vec && (old[k].x == -1 || old[k].y == -1 ||
                                     old[k].z == -1 || old[k].w == -1);
      par[k] = any ? slot0(sl, i) : make_int4(kIntInf, kIntInf, kIntInf,
                                             kIntInf);
      d[k] = any ? __ldg(reinterpret_cast<const int4*>(deg) + i)
                 : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (i0 + k * 32 >= n_vec) break;
      const int64_t i = i0 + k * 32 + lane;
      unsigned nib = 0;                    // this lane's 4 bits
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (lane_of(old[k], e) != -1) continue;
        int32_t p = lane_of(par[k], e);
        if (p == kIntInf && sl.recv != nullptr)
          p = later_slots(sl, i * kVec + e);
        if (p != kIntInf) {
          nib |= 1u << e;
          lane_of(old[k], e) = p;
          m_f += lane_of(d[k], e);
        } else {
          m_u += lane_of(d[k], e);
        }
      }
      if (nib) pi4[i] = old[k];
      n_f += __popc(nib);
      // eight lanes' nibbles make one word: lane 8w + j holds bits
      // 4j..4j+3 of word i0 / 8 + k * 4 + w
      unsigned w = nib << (kVec * (lane & 7));
      w |= __shfl_xor_sync(kFull, w, 1);
      w |= __shfl_xor_sync(kFull, w, 2);
      w |= __shfl_xor_sync(kFull, w, 4);
      if ((lane & 7) == 0 && i < n_vec) words[i / 8] = w;
    }
  }
  // lane 0 of each warp holds its warp's sums, then thread 0 the block's
  __shared__ long long part[3][kWarps];
  n_f = warp_sum(n_f);
  m_f = warp_sum(m_f);
  m_u = warp_sum(m_u);
  if (lane == 0) {
    part[0][warp] = n_f;
    part[1][warp] = m_f;
    part[2][warp] = m_u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum[3] = {0, 0, 0};
    for (int w = 0; w < kWarps; ++w)
      for (int j = 0; j < 3; ++j) sum[j] += part[j][w];
    for (int j = 0; j < 3; ++j)
      if (sum[j]) atomicAdd(scratch + j, (unsigned long long)sum[j]);
    // the last block out reports: every other block fenced its adds
    // before it counted itself done
    __threadfence();
    if (atomicAdd(scratch + 3, 1ull) == gridDim.x - 1) {
      for (int j = 0; j < 3; ++j)
        out[j] = (long long)atomicExch(scratch + j, 0ull);
      scratch[3] = 0;
    }
  }
}

// one wave of resident blocks, found once per device
int resident_blocks() {
  static int waves[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (waves[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, level_epilogue_kernel, kBlock, 0) != cudaSuccess)
      return 0;
    waves[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return waves[dev];
}

}  // namespace

// cand: (n,) int32 slot-0 candidates, or null (the start: root's id is
// the one candidate); recv: (n_blocks, pc, chunk) int32 of slots 1..pc-1,
// or null; pi: (n,) int32, updated in place; deg: (n,) int32; words:
// (n / 32,) int32, written whole; scratch: (4,) int64 at 0, left at 0;
// masses: (3,) int64 written (n_f, m_f, m_u).  n = n_blocks * chunk,
// chunk a multiple of 32; cand, pi and deg 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int level_epilogue(const void* cand, const void* recv,
                              long long root, void* pi, const void* deg,
                              void* words, void* scratch, void* masses,
                              long long n_blocks, int pc, int chunk,
                              void* stream) {
  if (n_blocks <= 0 || pc <= 0 || chunk <= 0 || chunk % 32)
    return (int)cudaErrorInvalidValue;
  const int waves = resident_blocks();
  if (waves == 0) return (int)cudaGetLastError();
  const int64_t n_vec = n_blocks * (chunk / kVec);
  const int64_t per_block = (int64_t)kWarps * kSteps * 32;
  const int64_t need = (n_vec + per_block - 1) / per_block;
  const int grid = (int)(need < waves ? need : waves);
  const Slots sl{(const int32_t*)cand, (const int32_t*)recv, root, pc,
                 chunk};
  level_epilogue_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      sl, (int32_t*)pi, (const int32_t*)deg, (uint32_t*)words, n_vec,
      (unsigned long long*)scratch, (long long*)masses);
  return (int)cudaGetLastError();
}
