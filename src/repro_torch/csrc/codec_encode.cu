// Encode of the "1ds" packed frontier codec: p buckets of cap local
// offsets each -> p count-prefixed buckets of 1 + W u32 words, the
// offsets bit-packed at `bits` bits (W = ceil(cap*bits/32)).
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_codec/frontier_codec.py::encode_offsets_kernel
// (pl.pallas_call at :58), which encoded one bucket per call as a
// per-bit gather and a 32-lane sum per word.  Word 0 is min(count, cap);
// slots at or past the count pack as 0, and so do the bits past cap*bits
// in the last word.
//
// Bound on the card: bytes (the counts, the offsets below each count, and
// every bucket word written once).  On the path the buckets are nearly
// empty (a few thousand ids in 16 x 52,448 slots), so the launch is close
// to a zero-fill of its 1 + W words a bucket.
//
// Design: one launch for all p buckets, the bucket blockIdx.y (so no
// division on the card), a block 4,096 consecutive slots of it.  A thread
// owns 32 consecutive slots, which are exactly `bits` whole payload words
// (32 x bits bits): it streams its 32 offsets through a 64-bit register
// and emits a word each time 32 bits are full, so no word is split
// between threads and nothing carries over.  `bits` is a template
// constant (1..32, dispatched in the C entry), so the stream's shifts and
// emits are resolved at compile time: a live block's packing is a few
// independent shifts and ORs a word, not a chain of 32 steps on its
// critical path.  All index arithmetic is 32-bit.  Thread 0 reads the
// bucket's count once into shared memory.  A block whose slots all lie
// at or past the count stores only zeros: it reads no offsets and packs
// nothing, which is nearly every block on the path.  A block with live
// slots stages its offsets through shared memory (coalesced 16-byte loads
// where the row allows), a thread reads its 32 back in 16-byte pieces,
// packs, and stages its words in a second buffer, so that loads and
// stores run over contiguous runs and one barrier fewer stands between
// them.  A row is 1 + W words, so its payload need not start on 16
// bytes: the words are staged from the payload's offset in its 16-byte
// group, so that every 16-byte vector stored is one aligned 16-byte
// shared read, and the words before the first 16-byte boundary and after
// the last are stored one by one.  The last block of a row packs its
// slots past cap as 0 and stores no word past W.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kBlock = 128;                    // threads a block
constexpr int kThreadSlots = 32;               // slots a thread: bits words
constexpr int kSlots = kBlock * kThreadSlots;  // slots a block
// Shared staging keeps rows of 32 entries at a pitch of 36: a 16-byte
// group stays 16-byte aligned, and the 8 threads of a 16-byte access
// phase that read consecutive rows fall in distinct banks.
constexpr int kStage = kSlots / 32 * 36 + 8;

__device__ __forceinline__ int skew(int i) { return i + ((i >> 5) << 2); }

// Stores the block's n words at dst (4-byte aligned): zeros where `src`
// is null, else the words `src` stages from entry `mis`, the offset of
// dst in its 16-byte group, so that each 16-byte vector of dst is one
// aligned 16-byte read of `src`.  The words before the first 16-byte
// boundary and after the last go one by one.
__device__ __forceinline__ void store_words(uint32_t* dst, int n,
                                            const uint32_t* src, int mis) {
  const int lead = min(n, (4 - mis) & 3);
  const int n_vec = (n - lead) >> 2;
  const int tail = lead + 4 * n_vec;
  const int t = threadIdx.x;
  if (t < lead) dst[t] = src ? src[skew(mis + t)] : 0u;
  if (t >= 4 && t - 4 < n - tail)
    dst[tail + t - 4] = src ? src[skew(mis + tail + t - 4)] : 0u;
  uint4* vec = reinterpret_cast<uint4*>(dst + lead);
  for (int i = t; i < n_vec; i += kBlock)
    vec[i] = src ? *reinterpret_cast<const uint4*>(
                       src + skew(mis + lead + 4 * i))
                 : make_uint4(0u, 0u, 0u, 0u);
}

template <int BITS>
__global__ void __launch_bounds__(kBlock)
    codec_encode_kernel(const int32_t* __restrict__ off,
                        const int32_t* __restrict__ count,
                        uint32_t* __restrict__ out, int32_t cap, int32_t w) {
  __shared__ __align__(16) uint32_t offs_s[kStage];
  __shared__ __align__(16) uint32_t words_s[kStage];
  __shared__ int32_t live_s;
  const int k = blockIdx.y;
  const int s_block = blockIdx.x * kSlots;         // the block's first slot
  const int w_block = blockIdx.x * kBlock * BITS;  // its first payload word
  uint32_t* row = out + (int64_t)k * (w + 1);
  if (threadIdx.x == 0) {
    const uint32_t live = min((uint32_t)__ldg(count + k), (uint32_t)cap);
    live_s = (int32_t)live;
    if (blockIdx.x == 0) row[0] = live;
  }
  __syncthreads();
  const int live = live_s;
  const int n_words = min(kBlock * BITS, w - w_block);  // none past W
  uint32_t* dst = row + 1 + w_block;
  const int mis = (int)(((uintptr_t)dst >> 2) & 3u);
  if (live <= s_block) {  // every slot of the block at or past the count
    store_words(dst, n_words, nullptr, mis);
    return;
  }
  // stage the live offsets, 16 bytes a load where the row allows
  const int n_live = min(live - s_block, kSlots);
  const int32_t* src = off + (int64_t)k * cap + s_block;
  int i0 = 0;
  if (((uintptr_t)src & 15u) == 0) {
    i0 = n_live & ~3;
    for (int i = threadIdx.x; 4 * i < i0; i += kBlock) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src) + i);
      *reinterpret_cast<uint4*>(offs_s + skew(4 * i)) =
          make_uint4(x.x, x.y, x.z, x.w);
    }
  }
  for (int i = i0 + threadIdx.x; i < n_live; i += kBlock)
    offs_s[skew(i)] = (uint32_t)__ldg(src + i);
  __syncthreads();
  // a thread's 32 offsets, 16 bytes a read; slots past the count are 0
  constexpr uint32_t kMask =
      BITS >= 32 ? 0xffffffffu : (1u << (BITS & 31)) - 1u;
  const int t0 = threadIdx.x * kThreadSlots;
  uint32_t v[kThreadSlots];
#pragma unroll
  for (int q = 0; q < kThreadSlots; q += 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(offs_s + skew(t0 + q));
    v[q] = x.x, v[q + 1] = x.y, v[q + 2] = x.z, v[q + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kThreadSlots; ++i)
    v[i] = t0 + i < n_live ? v[i] & kMask : 0u;
  // stream them into BITS words, staged from entry mis
  uint64_t acc = 0;
  int n_acc = 0;
  int wi = mis + threadIdx.x * BITS;
#pragma unroll
  for (int i = 0; i < kThreadSlots; ++i) {
    acc |= (uint64_t)v[i] << n_acc;
    n_acc += BITS;
    if (n_acc >= 32) {
      words_s[skew(wi++)] = (uint32_t)acc;
      acc >>= 32;
      n_acc -= 32;
    }
  }
  __syncthreads();
  store_words(dst, n_words, words_s, mis);
}

template <int BITS>
void launch(const int32_t* off, const int32_t* count, uint32_t* out, int p,
            int cap, int w, int gx, cudaStream_t stream) {
  codec_encode_kernel<BITS>
      <<<dim3(gx, p), kBlock, 0, stream>>>(off, count, out, cap, w);
}

typedef void (*Launch)(const int32_t*, const int32_t*, uint32_t*, int, int,
                       int, int, cudaStream_t);

template <int... B>
Launch pick(int bits, std::integer_sequence<int, B...>) {
  constexpr Launch fns[] = {&launch<B + 1>...};
  return fns[bits - 1];
}

}  // namespace

// One packed argument, int64 values: off, count, out, p, cap, bits, w, gx
// (blocks a bucket: ceil(cap / 4096), at least 1 so that an empty row
// still gets its count word; ops.py::encode_shape), stream.
extern "C" int codec_encode(const long long* a) {
  const auto* off = (const int32_t*)a[0];
  const auto* count = (const int32_t*)a[1];
  auto* out = (uint32_t*)a[2];
  const int p = (int)a[3], cap = (int)a[4], bits = (int)a[5], w = (int)a[6];
  const int gx = (int)a[7];
  const auto stream = (cudaStream_t)a[8];
  if (p <= 0) return (int)cudaGetLastError();
  if (bits < 1 || bits > 32 || p > 65535 || cap < 0 ||
      cap > 0x7fffffff - kSlots || gx < 1 ||
      (int64_t)gx * kSlots < (int64_t)cap ||
      (int64_t)w * 32 < (int64_t)cap * bits)
    return (int)cudaErrorInvalidValue;
  pick(bits, std::make_integer_sequence<int, 32>{})(off, count, out, p, cap,
                                                    w, gx, stream);
  return (int)cudaGetLastError();
}
