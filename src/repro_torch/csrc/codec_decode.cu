// Decode of the "1ds" packed frontier codec: p allgathered buckets of
// 1 + W u32 words -> p*cap global vertex ids, bucket k's offsets rebased
// by k*chunk, and the drop sentinel n in every slot past the bucket's
// count word.
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_codec/frontier_codec.py::decode_buckets_kernel
// (pl.pallas_call at :93), one grid program per bucket doing a per-bit
// gather and a `bits`-wide sum per slot.  On the simulated mesh every
// receiver holds the same gathered buffer, so the caller decodes it once
// per exchange.
//
// Bound on the card: bytes.  The count words, the payload words that
// hold live offsets, and the p*cap ids written once.  On the path the
// frontiers are small (a few to tens of thousands of ids in 16 x 52,448
// slots), so nearly all the work is the sentinel fill.
//
// Design: a thread owns one 16-byte vector of the flat output, 4
// consecutive slots, and a block 256 vectors of one bucket (blockIdx.y);
// the grid is the vectors that touch a bucket's row, not one thread a
// slot.  Where cap % 4 != 0 a row starts and ends inside a vector; the
// slots of such a vector that lie in the row are stored one by one (the
// neighbouring bucket's block stores the others).  Thread 0 reads the
// bucket's count word once into shared memory.  A block wholly past the
// count stores only sentinels.  A block with live slots first stages the
// payload words that hold them through shared memory, with coalesced
// loads, then extracts each slot from the one or two staged words its
// `bits` bits span (1 <= bits <= 32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 4;                       // slots a thread
constexpr int kSlots = kBlock * kVec;         // flat slots a block
constexpr int kStage = kSlots + 1;            // words of kSlots 32-bit slots,
                                              // one more where they straddle

__global__ void __launch_bounds__(kBlock)
    codec_decode_kernel(const uint32_t* __restrict__ recv,
                        int32_t* __restrict__ out, int32_t cap, int32_t bits,
                        int32_t w, int32_t chunk, int32_t n) {
  __shared__ int32_t count_s;
  __shared__ uint32_t words[kStage];
  const int k = blockIdx.y;
  const uint32_t* buf = recv + (int64_t)k * ((int64_t)w + 1);
  const int64_t row0 = (int64_t)k * cap;      // flat index of slot 0
  // the block's first flat index, a multiple of 4; its slot (may be < 0)
  const int64_t f0 = ((row0 >> 2) + (int64_t)blockIdx.x * kBlock) * kVec;
  const int64_t s_block = f0 - row0;
  if (threadIdx.x == 0) count_s = (int32_t)buf[0];
  __syncthreads();
  // the block's live slots [a, e): inside the row and below the count
  const int64_t live_end = count_s < cap ? count_s : cap;
  const int64_t a = s_block > 0 ? s_block : 0;
  const int64_t e =
      s_block + kSlots < live_end ? s_block + kSlots : live_end;
  int64_t w_lo = 0;
  int nw = 0;
  if (a < e) {  // the same in the whole block
    w_lo = (a * bits) >> 5;
    nw = (int)(((e * bits - 1) >> 5) - w_lo + 1);
    for (int i = threadIdx.x; i < nw; i += kBlock)
      words[i] = __ldg(buf + 1 + w_lo + i);
    __syncthreads();
  }
  const int64_t s0 = s_block + (int64_t)threadIdx.x * kVec;
  const uint64_t mask = bits >= 32 ? 0xffffffffull : ((1ull << bits) - 1);
  const uint32_t rebase = (uint32_t)((int64_t)k * chunk);  // mod 2**32
  int32_t v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int64_t s = s0 + j;
    v[j] = n;
    if (s >= a && s < e) {
      const int64_t b = s * bits;
      const int wi = (int)((b >> 5) - w_lo);
      const uint64_t lo = words[wi];
      const uint64_t hi = wi + 1 < nw ? words[wi + 1] : 0;
      v[j] = (int32_t)(rebase + (uint32_t)((((hi << 32) | lo) >> (b & 31)) &
                                           mask));
    }
  }
  int32_t* o = out + f0 + (int64_t)threadIdx.x * kVec;
  if (s0 >= 0 && s0 + kVec <= cap) {
    *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (s0 + j >= 0 && s0 + j < cap) o[j] = v[j];
  }
}

}  // namespace

// One packed argument, int64 values: recv, out, p, cap, bits, w, chunk, n,
// gx (blocks a bucket: the vectors that touch a row, at most
// (cap + 2) / 4 + 1, over 256; ops.py::_shape), stream.  out must be 16-byte
// aligned.
extern "C" int codec_decode(const long long* a) {
  const auto* recv = (const uint32_t*)a[0];
  auto* out = (int32_t*)a[1];
  const int p = (int)a[2], cap = (int)a[3], bits = (int)a[4], w = (int)a[5];
  const int chunk = (int)a[6], n = (int)a[7], gx = (int)a[8];
  const auto stream = (cudaStream_t)a[9];
  if (p <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (bits < 1 || bits > 32 || p > 65535 || gx < 1 ||
      (int64_t)gx * kBlock < ((int64_t)cap + 2) / kVec + 1 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  codec_decode_kernel<<<dim3(gx, p), kBlock, 0, stream>>>(recv, out, cap,
                                                          bits, w, chunk, n);
  return (int)cudaGetLastError();
}
