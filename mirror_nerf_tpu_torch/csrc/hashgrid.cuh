// The hash-grid lookup's device functions, shared by the ENCODE, GATHER and
// DENSE modes of csrc/hashgrid.cu and (all but DENSE's) by the fused NGP
// composite of
// csrc/fused_cp_composite.cu (`hash_field_kernel`), so that both compute a
// level's features with the same arithmetic.
//
// One level as the wrapper packs it (ops/hashgrid.py `_level_table`): 8
// int32 words. A level's rows start at `offset` rows into the flat (rows,
// C) table; a hashed level's corner row is the uint32 xor of
// coordinate·prime (gridencoder.cu:51-66) modulo its size, a dense level's
// the strided sum. pos = x·scale + 0.5 is one fused multiply-add
// (__fmaf_rn), as XLA contracts the JAX package's expression.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

struct Level {
  unsigned offset;     // first row of the level in the table
  unsigned size;       // rows of the level
  float scale;         // fp32 2^(l·S)·H − 1
  unsigned stride[3];  // dense strides (0 past the level size)
  int use_hash;
  int pad;
};
static_assert(sizeof(Level) == 32, "Level is 8 words");

// Level l of the device array the wrapper packs: two 16-B read-only loads.
__device__ __forceinline__ Level load_level(const Level* __restrict__ levels,
                                            int l) {
  Level L;
  const uint4* w = reinterpret_cast<const uint4*>(levels + l);
  const uint4 a = __ldg(w), b = __ldg(w + 1);
  memcpy(&L, &a, 16);
  memcpy(reinterpret_cast<unsigned char*>(&L) + 16, &b, 16);
  return L;
}

// The widest load unit for a row of BYTES bytes (rows start at multiples of
// min(BYTES, 16) bytes; the wrapper checks the table's base).
template <int BYTES> struct Unit { using T = uint4; };
template <> struct Unit<2> { using T = unsigned short; };
template <> struct Unit<4> { using T = unsigned; };
template <> struct Unit<8> { using T = uint2; };

// GATHER's device function: one row of BYTES bytes through the read-only
// path, into registers.
template <int BYTES>
__device__ __forceinline__ void copy_row(const unsigned char* __restrict__ base,
                                         size_t row, void* dst) {
  using U = typename Unit<BYTES>::T;
  constexpr int K = BYTES / sizeof(U);
  const U* src = reinterpret_cast<const U*>(base + row * BYTES);
  U u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = __ldg(src + k);
  memcpy(dst, u, BYTES);
}

__device__ __forceinline__ unsigned corner_row(const Level& L, unsigned x,
                                               unsigned y, unsigned z) {
  const unsigned h =
      L.use_hash ? (x ^ (y * 2654435761u) ^ (z * 805459861u))
                 : (x * L.stride[0] + y * L.stride[1] + z * L.stride[2]);
  return h % L.size;
}

// DENSE's device function: the trilinear interpolation of one level at
// x ∈ [0, 1]³ from the level's rows (size × C floats). Corner c has bit d
// set for +1 along axis d; weights ((w_x·w_y)·w_z), corners summed 0..7, as
// the JAX package orders them.
template <int C>
__device__ __forceinline__ void interp_level(const float* __restrict__ rows,
                                             const Level& L, float x0,
                                             float x1, float x2,
                                             float (&acc)[C]) {
  const float p0 = __fmaf_rn(x0, L.scale, 0.5f);
  const float p1 = __fmaf_rn(x1, L.scale, 0.5f);
  const float p2 = __fmaf_rn(x2, L.scale, 0.5f);
  const float f0 = floorf(p0), f1 = floorf(p1), f2 = floorf(p2);
  const float t0 = p0 - f0, t1 = p1 - f1, t2 = p2 - f2;
  const unsigned g0 = (unsigned)(int)f0, g1 = (unsigned)(int)f1,
                 g2 = (unsigned)(int)f2;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(rows);
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 1) ? t0 : 1.f - t0;
    const float wy = (c & 2) ? t1 : 1.f - t1;
    const float wz = (c & 4) ? t2 : 1.f - t2;
    const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
    float v[C];
    copy_row<C * 4>(base,
                    corner_row(L, g0 + (c & 1), g1 + ((c >> 1) & 1),
                               g2 + ((c >> 2) & 1)),
                    v);
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = fmaf(w, v[k], acc[k]);
  }
}

// DENSE's device functions: interp_level's arithmetic for one dense
// level of C = 2 (8-B rows, x stride 1, as the DENSE entry packs it), split
// so that a thread can issue the loads of several samples before their
// FMAs. `dense_corners` computes the position with the same FMA and floor
// and loads the eight corner rows; `dense_sum` weighs them ((w_x·w_y)·w_z)
// and sums corners 0..7 by fmaf, so the result equals interp_level's bit
// for bit. The x-pair of corners (rows r and r + 1 of one y, z: corners 2k
// and 2k + 1) comes in one 16-B load where r + 1 follows r (the modulo
// does not wrap between them) and row r starts on a 16-B boundary; else in
// two 8-B loads. Row r + 1 is derived from r, not from a second modulo.
struct DenseCorners {
  float t[3];     // the position's fractions
  float2 v[8];    // corner c's row (bit d of c: +1 along axis d)
};

__device__ __forceinline__ DenseCorners dense_corners(
    const float* __restrict__ rows, const Level& L, float x0, float x1,
    float x2) {
  DenseCorners d;
  const float p0 = __fmaf_rn(x0, L.scale, 0.5f);
  const float p1 = __fmaf_rn(x1, L.scale, 0.5f);
  const float p2 = __fmaf_rn(x2, L.scale, 0.5f);
  const float f0 = floorf(p0), f1 = floorf(p1), f2 = floorf(p2);
  d.t[0] = p0 - f0;
  d.t[1] = p1 - f1;
  d.t[2] = p2 - f2;
  const unsigned g0 = (unsigned)(int)f0, g1 = (unsigned)(int)f1,
                 g2 = (unsigned)(int)f2;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(rows);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned h = g0 + (g1 + (k & 1)) * L.stride[1] +
                       (g2 + (k >> 1)) * L.stride[2];
    const unsigned r0 = h % L.size;
    // (h + 1) mod 2³², then mod the size
    const unsigned r1 = h == 0xFFFFFFFFu ? 0u
                                         : (r0 + 1 == L.size ? 0u : r0 + 1);
    const unsigned char* a0 = base + (size_t)r0 * 8;
    if (r1 == r0 + 1 && (reinterpret_cast<uintptr_t>(a0) & 15) == 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a0));
      d.v[2 * k] = make_float2(v.x, v.y);
      d.v[2 * k + 1] = make_float2(v.z, v.w);
    } else {
      d.v[2 * k] = __ldg(reinterpret_cast<const float2*>(a0));
      d.v[2 * k + 1] =
          __ldg(reinterpret_cast<const float2*>(base + (size_t)r1 * 8));
    }
  }
  return d;
}

__device__ __forceinline__ void dense_sum(const DenseCorners& d,
                                          float (&acc)[2]) {
  acc[0] = acc[1] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 1) ? d.t[0] : 1.f - d.t[0];
    const float wy = (c & 2) ? d.t[1] : 1.f - d.t[1];
    const float wz = (c & 4) ? d.t[2] : 1.f - d.t[2];
    const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
    acc[0] = fmaf(w, d.v[c].x, acc[0]);
    acc[1] = fmaf(w, d.v[c].y, acc[1]);
  }
}

__device__ __forceinline__ bool in_unit_cube(float x0, float x1, float x2) {
  return !(x0 < 0.f || x0 > 1.f || x1 < 0.f || x1 > 1.f || x2 < 0.f ||
           x2 > 1.f);
}

}  // namespace
