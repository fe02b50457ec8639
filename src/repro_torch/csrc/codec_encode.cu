// Encode of the "1ds" packed frontier codec: p buckets of cap local
// offsets each -> p count-prefixed buckets of 1 + W u32 words, the
// offsets bit-packed at `bits` bits (W = ceil(cap*bits/32)).
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_codec/frontier_codec.py::encode_offsets_kernel
// (pl.pallas_call at :58), which encoded one bucket per call as a
// per-bit gather and a 32-lane sum per word.  Here one launch encodes all
// p buckets and one thread owns one output word: it ORs in the at most
// ceil(32/bits)+1 offsets whose bits fall inside its 32, each shifted to
// its place (a negative shift for an offset that started in the word
// before).  No word depends on another, so there is no carry and no
// atomic.  Word 0 is min(count, cap); slots at or past the count pack
// as 0, and so do the bits past cap*bits in the last word.
//
// Bound on the card: bytes.  The offsets are read once (each is read by
// the one or two threads whose words it touches, next to each other, so
// the second read hits L1/L2) and every bucket word is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void codec_encode_kernel(const int32_t* __restrict__ off,
                                    const int32_t* __restrict__ count,
                                    uint32_t* __restrict__ out, int32_t p,
                                    int32_t cap, int32_t bits, int32_t w) {
  const int64_t per = (int64_t)w + 1;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)p * per) return;
  const int64_t k = tid / per;
  const int64_t j = tid - k * per;
  const uint32_t cnt = min((uint32_t)__ldg(count + k), (uint32_t)cap);
  if (j == 0) {
    out[tid] = cnt;
    return;
  }
  const int64_t b0 = (j - 1) * 32;          // first packed bit of the word
  const int64_t s_lo = b0 / bits;
  const int64_t s_hi = min((b0 + 31) / bits, (int64_t)cnt - 1);
  const uint64_t mask = (bits >= 32) ? 0xffffffffull : ((1ull << bits) - 1);
  const int32_t* o = off + k * cap;
  uint32_t word = 0;
  for (int64_t s = s_lo; s <= s_hi; ++s) {
    const uint64_t v = (uint64_t)(uint32_t)__ldg(o + s) & mask;
    const int64_t sh = s * bits - b0;       // in (-bits, 32)
    word |= (uint32_t)(sh >= 0 ? (v << sh) : (v >> (-sh)));
  }
  out[tid] = word;
}

}  // namespace

extern "C" int codec_encode(const void* off, const void* count, void* out,
                            int p, int cap, int bits, int w, void* stream) {
  const int64_t threads = (int64_t)p * ((int64_t)w + 1);
  if (threads > 0) {
    const int block = 256;
    const int64_t grid = (threads + block - 1) / block;
    codec_encode_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)off, (const int32_t*)count, (uint32_t*)out, p, cap,
        bits, w);
  }
  return (int)cudaGetLastError();
}
