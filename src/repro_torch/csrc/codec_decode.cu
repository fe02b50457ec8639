// Decode of the "1ds" packed frontier codec: p allgathered buckets of
// 1 + W u32 words -> p*cap global vertex ids, bucket k's offsets rebased
// by k*chunk, and the drop sentinel n in every slot past the bucket's
// count word.
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_codec/frontier_codec.py::decode_buckets_kernel
// (pl.pallas_call at :93), one grid program per bucket doing a per-bit
// gather and a `bits`-wide sum per slot.  Here one thread owns one
// (bucket, slot): it reads the one or two words its `bits` bits span as
// one 64-bit value, shifts and masks.  On the simulated mesh every
// receiver holds the same gathered buffer, so the caller decodes it once
// per exchange.
//
// Bound on the card: bytes.  Each packed word is read by the few threads
// whose slots it holds (neighbours, so L1/L2 serves the repeats); every
// id is written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void codec_decode_kernel(const uint32_t* __restrict__ recv,
                                    int32_t* __restrict__ out, int32_t p,
                                    int32_t cap, int32_t bits, int32_t w,
                                    int32_t chunk, int32_t n) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)p * cap) return;
  const int64_t k = tid / cap;
  const int64_t s = tid - k * cap;
  const uint32_t* buf = recv + k * ((int64_t)w + 1);
  const int32_t cnt = (int32_t)__ldg(buf);
  if (s >= cnt) {
    out[tid] = n;
    return;
  }
  const int64_t b = s * bits;
  const int64_t wi = b >> 5;
  const uint64_t lo = __ldg(buf + 1 + wi);
  const uint64_t hi = (wi + 1 < w) ? __ldg(buf + 2 + wi) : 0;
  const uint64_t mask = (bits >= 32) ? 0xffffffffull : ((1ull << bits) - 1);
  const uint64_t v = (((hi << 32) | lo) >> (b & 31)) & mask;
  out[tid] = (int32_t)(k * chunk) + (int32_t)v;
}

}  // namespace

extern "C" int codec_decode(const void* recv, void* out, int p, int cap,
                            int bits, int w, int chunk, int n,
                            void* stream) {
  const int64_t threads = (int64_t)p * cap;
  if (threads > 0) {
    const int block = 256;
    const int64_t grid = (threads + block - 1) / block;
    codec_decode_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)recv, (int32_t*)out, p, cap, bits, w, chunk, n);
  }
  return (int)cudaGetLastError();
}
