// One bottom-up sub-step (Alg. 4, lines 10-16) over one rotated row
// segment of a 2D block: for every row not yet completed, the smallest
// global source id among its in-neighbours that are in the frontier
// bitmap, else INT_MAX.
//
// Replaces the TPU kernel
// src/repro/kernels/bottomup/bottomup.py::bottomup_substep_kernel
// (pl.pallas_call at :89).  The TPU kernel scanned row TILES with a
// tile-wide early exit, because a per-row break does not vectorize on its
// lanes.  Here one warp owns one row: its 32 lanes test 32 consecutive
// edges of the row at once, a ballot finds the first hit, and the warp
// stops there.  CSR rows are sorted by ascending source
// (graph/formats.py keeps the (block, row, source) sort order), so the
// first hit IS the minimum and the result is bit-identical to the
// reference scatter-min.
//
// Bound on the card: bytes.  A live row reads its two pointers, the
// completed flag, its edges up to the first hit, and one frontier word
// per edge read (the frontier bitmap is nc/8 bytes and stays in L2); a
// completed row reads only its flag.  Every row writes one output word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kIntInf = 0x7fffffff;

__global__ void bottomup_substep_kernel(const int32_t* __restrict__ rp_seg,
                                        const int32_t* __restrict__ ue_win,
                                        const int32_t* __restrict__ f_words,
                                        const int32_t* __restrict__ cvec,
                                        int32_t* __restrict__ out,
                                        int32_t chunk, int32_t col_offset,
                                        int32_t n_edges) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int32_t lane = threadIdx.x & 31;
  if (warp >= chunk) return;               // uniform across the warp
  const int32_t r = (int32_t)warp;
  int32_t res = kIntInf;
  if (__ldg(cvec + r) == 0) {
    const int32_t lo = __ldg(rp_seg + r);
    const int32_t hi = min(__ldg(rp_seg + r + 1), n_edges);
    for (int32_t e0 = lo; e0 < hi; e0 += 32) {
      const int32_t e = e0 + lane;
      int32_t u = 0;
      bool hit = false;
      if (e < hi) {
        u = __ldg(ue_win + e);
        hit = (__ldg(f_words + (u >> 5)) >> (u & 31)) & 1;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot) {
        u = __shfl_sync(0xffffffffu, u, __ffs(ballot) - 1);
        res = col_offset + u;
        break;
      }
    }
  }
  if (lane == 0) out[r] = res;
}

}  // namespace

extern "C" int bottomup_substep(const void* rp_seg, const void* ue_win,
                                const void* f_words, const void* cvec,
                                void* out, int chunk, int col_offset,
                                int n_edges, void* stream) {
  if (chunk > 0) {
    const int64_t threads = (int64_t)chunk * 32;
    const int block = 256;
    const int64_t grid = (threads + block - 1) / block;
    bottomup_substep_kernel<<<(unsigned)grid, block, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)rp_seg, (const int32_t*)ue_win,
        (const int32_t*)f_words, (const int32_t*)cvec, (int32_t*)out, chunk,
        col_offset, n_edges);
  }
  return (int)cudaGetLastError();
}
