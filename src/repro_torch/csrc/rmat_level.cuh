// The counter R-MAT level body, shared by rmat_counter.cu (the kernel)
// and int_rate.cu (the integer instruction rate that kernel's bound
// uses), so that the rate is measured on the instructions the kernel
// issues.
//
// With h the counter's hash and s a level's salt, the level starts from
// (h^s) ^ ((h^s)>>16) = (h ^ h>>16) ^ (s ^ s>>16): the caller computes
// base = h ^ h>>16 once an edge and passes the folded salts
// S_l = s ^ s>>16 (graph/rmat.py::kernel_salts), so a level starts with
// one xor.  With t1 <= t2 <= t3 the dst bit ((x>=t1) && (x<t2)) ||
// (x>=t3) is (x>=t1) ^ (x>=t2) ^ (x>=t3).
#pragma once

#include <stdint.h>

#include <utility>

namespace rmat {

constexpr uint32_t kGolden = 0x9E3779B9u;

// One level of one edge.  The compares and the predicated ORs are
// written in PTX (setp.ge.xor chains the three compares; or.b32 under a
// predicate): from the same logic in C++ the compiler made each bit a
// SEL and summed them with IADD3, and the scale-24 kernel took 4.47 ms
// for the 268,435,456-edge stream against 3.37 ms in this form (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md).
template <int L>
__device__ __forceinline__ void level(uint32_t base, uint32_t salt,
                                      uint32_t t1, uint32_t t2, uint32_t t3,
                                      uint32_t& s, uint32_t& d) {
  uint32_t x = base ^ salt;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  asm("{\n.reg .pred p, q;\n"
      "setp.ge.u32 p, %2, %4;\n"            // src bit: x >= t2
      "setp.ge.xor.u32 q, %2, %3, p;\n"     // (x >= t1) ^ (x >= t2)
      "setp.ge.xor.u32 q, %2, %5, q;\n"     // ... ^ (x >= t3): dst bit
      "@p or.b32 %0, %0, %6;\n"
      "@q or.b32 %1, %1, %6;\n}\n"
      : "+r"(s), "+r"(d)
      : "r"(x), "r"(t1), "r"(t2), "r"(t3), "n"(1u << L));
}

// Levels L... of one edge: the (src, dst) bits of the levels, salts.v[L]
// the folded salt of level L.
template <typename Salts, int... L>
__device__ __forceinline__ void levels(std::integer_sequence<int, L...>,
                                       uint32_t base, const Salts& salts,
                                       uint32_t t1, uint32_t t2, uint32_t t3,
                                       uint32_t& s, uint32_t& d) {
  (level<L>(base, salts.v[L], t1, t2, t3, s, d), ...);
}

}  // namespace rmat
