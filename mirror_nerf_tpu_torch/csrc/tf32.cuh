// 3×TF32 products on `mma.sync.m16n8k8`, shared by the CP composite
// (csrc/fused_cp_composite.cu) and the CP train kernels
// (csrc/fused_cp_train.cu): fp32-accurate a·b as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi with fp32 accumulators, each hi and lo a `cvt.rna.tf32.f32`
// (lo of x − hi). The tensor cores' sums truncate; a caller that sums many
// k-tiles adds short chunks into fp32 itself.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A fragment of a 16 × 8 tile (row-major), hi and lo: a lane (g = lane/4,
// t = lane%4) holds rows g, g+8 of columns t, t+4 as v0 (g, t), v1 (g+8,
// t), v2 (g, t+4), v3 (g+8, t+4).
struct AFrag {
  uint32_t hi[4], lo[4];
};
// B fragment of an 8 × 8 tile: rows t, t+4 of column g.
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ AFrag split_a(float v0, float v1, float v2,
                                         float v3) {
  AFrag a;
  tf32_split(v0, a.hi[0], a.lo[0]);
  tf32_split(v1, a.hi[1], a.lo[1]);
  tf32_split(v2, a.hi[2], a.lo[2]);
  tf32_split(v3, a.hi[3], a.lo[3]);
  return a;
}

// The next layer's A fragment from a C fragment: C's columns 2t, 2t+1 are
// A's columns t, t+4 (the wrapper orders the next weight's K rows so).
__device__ __forceinline__ AFrag a_from_c(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3×TF32, the small products first
__device__ __forceinline__ void mma3(float c[4], const AFrag& a,
                                     const BFrag& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

}  // namespace
