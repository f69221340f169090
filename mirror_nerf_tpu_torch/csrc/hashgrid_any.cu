// The hash-grid encoder for every `HashGridSpec` (sm_90a): ENCODE, BWD and
// BWD2 for any input_dim D in 1..7, any level_dim C, align_corners, linear
// or smoothstep interpolation, any number of levels, hashed or tiled.
//
// A GPU addition, as csrc/hashgrid.cu's ENCODE, BWD and BWD2 are: it
// replaces XLA's gathers and autodiff (scatter-adds, grad-of-grad) of
// mirror_nerf_tpu/ops/hashgrid.py:137 `hashgrid_encode`, over the range of
// specs that function takes (`HashGridSpec`, :51-62; D ≤ 7, the length of
// `_PRIMES`, :37). The tuned kernels of csrc/hashgrid.cu stay the route for
// the hash-grid model's spec (3-d, C = 2, linear, align_corners off, ≤ 32
// levels; ops/hashgrid.py routes it there); every other spec runs here.
//
// Per level of a point x ∈ [0, 1]^D (a point outside gets zero features,
// adds nothing and gets zero gradients), with the fp32 scale s:
//   pos_d = x_d·s + (align_corners ? 0 : 0.5), one FMA, as XLA contracts it
//   g_d = floor(pos_d), t_d = pos_d − g_d, S_d = t_d, or with smoothstep
//     (t·t)·(3 − 2t), S' = 6t·(1 − t), S'' = 6 − 12t
//   corner c (bit d: +1 along axis d): f_d = S_d or 1 − S_d, w_c = Π_d f_d
//     (in axis order); its row: the uint32 xor of (g_d + bit)·prime_d for
//     a hashed level, else Σ (g_d + bit)·stride_d, modulo the level size
//   ENCODE  y[k] = Σ_c w_c T[row_c][k]
//   BWD     d_table[row_c] += w_c·dy_l; dx_d = Σ_l s Σ_c ∂w_c/∂t_d ⟨T_c, dy_l⟩,
//           ∂w_c/∂t_d = ±S'_d Π_{e≠d} f_e
//   BWD2    (the cotangent g of dx) u_c = s Σ_d g_d ∂w_c/∂t_d;
//           d_dy_l = Σ_c u_c T_c; d_table[row_c] += u_c·dy_l;
//           d_x_d = Σ_l s² Σ_c ⟨T_c, dy_l⟩ (Σ_{e≠d} g_e ∂²w_c/∂t_d∂t_e
//             + g_d ±S''_d Π_{e≠d} f_e): smoothstep's diagonal term, which
//           the linear weights lack
// The products of all factors but one (and, for BWD2, the sums of
// a_e Π_{k≠e} f_k with a_e = g_e ∂f_e/∂t_e, and their derivatives) come
// from prefix and suffix products over the axes: O(D) a corner at D = 7's
// 128 corners.
//
// What bounds it on the H100: the gathers, 2^D row loads of C·4 bytes a
// (point, level) at data-dependent addresses (and for BWD, BWD2 as many
// fp32 reductions into L2). The design is the simple one, templated on D
// only (C, align_corners and the interpolation are run-time arguments, so
// the build holds 7 instances a mode):
//   * ENCODE: one thread a (point, level), level fastest, as the tuned
//     ENCODE; the features in chunks of four;
//   * BWD, BWD2: one thread a point, its levels in order (dx and d_x are
//     summed in registers, no atomics); the table grads by one fp32
//     `atomicAdd` (a no-return reduction) a (corner, feature);
//   * the level table (16 words a level: offset, size, scale, hashed, D
//     strides) is read from global memory, uniform within a level.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23,
// PERF.md §6 rows 9g–9i; five specs of 16 levels × 2¹⁹ rows, 2-d to 7-d):
// ENCODE 0.85–8.7 ms on 2,097,152 points (2.5–10.6 % of each spec's
// bound), BWD 0.57–2.4 ms and BWD2 0.99–3.9 ms on 131,072 (1.6–4.1 %).

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_D = 7;

// the reference's spatial-hash primes (gridencoder.cu:55-56)
__constant__ unsigned PRIMES[MAX_D] = {1u,          2654435761u, 805459861u,
                                       3674653429u, 2097192037u, 1434869437u,
                                       2165219737u};

// One level as ops/hashgrid.py `_level_table_any` packs it: 16 int32 words.
struct LevelAny {
  unsigned offset;         // first row of the level in the table
  unsigned size;           // rows of the level
  float scale;             // fp32 2^(l·S)·H − 1
  int use_hash;
  unsigned stride[MAX_D];  // dense strides (0 past the level size)
  unsigned pad[5];
};
static_assert(sizeof(LevelAny) == 64, "LevelAny is 16 words");

// One level of one point: the cell, the interpolants S_d and their first
// and second derivatives.
template <int D>
struct Cell {
  unsigned g[D];
  float s[D], s1[D], s2[D];
};

template <int D>
__device__ __forceinline__ Cell<D> cell_of(const LevelAny& L, const float* x,
                                           float off, bool smooth) {
  Cell<D> k;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = __fmaf_rn(x[d], L.scale, off);
    const float f = floorf(p);
    const float t = __fsub_rn(p, f);
    k.g[d] = (unsigned)(int)f;
    if (smooth) {
      k.s[d] = __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.f, __fmul_rn(2.f, t)));
      k.s1[d] = __fmul_rn(__fmul_rn(6.f, t), __fsub_rn(1.f, t));
      k.s2[d] = __fsub_rn(6.f, __fmul_rn(12.f, t));
    } else {
      k.s[d] = t;
      k.s1[d] = 1.f;
      k.s2[d] = 0.f;
    }
  }
  return k;
}

// corner c's row in the flat table
template <int D>
__device__ __forceinline__ size_t corner_row(const LevelAny& L,
                                             const Cell<D>& k, int c) {
  unsigned h = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const unsigned v = k.g[d] + ((c >> d) & 1);
    if (L.use_hash)
      h ^= v * PRIMES[d];
    else
      h += v * L.stride[d];
  }
  return (size_t)L.offset + h % L.size;
}

// corner c's factors f_d and ∂f_d/∂t_d
template <int D>
__device__ __forceinline__ void factors(const Cell<D>& k, int c,
                                        float (&f)[D], float (&df)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const bool up = (c >> d) & 1;
    f[d] = up ? k.s[d] : __fsub_rn(1.f, k.s[d]);
    df[d] = up ? k.s1[d] : -k.s1[d];
  }
}

// w = Π f in axis order and pex_d = Π_{e≠d} f_e (in axis order)
template <int D>
__device__ __forceinline__ float products(const float (&f)[D],
                                          float (&pex)[D]) {
  float pre[D + 1], suf[D + 1];
  pre[0] = 1.f;
  suf[D] = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) pre[d + 1] = pre[d] * f[d];
#pragma unroll
  for (int d = D - 1; d >= 0; --d) suf[d] = f[d] * suf[d + 1];
#pragma unroll
  for (int d = 0; d < D; ++d) pex[d] = pre[d] * suf[d + 1];
  return pre[D];
}

__device__ __forceinline__ bool in_unit_box(const float* x, int d) {
  for (int i = 0; i < d; ++i)
    if (x[i] < 0.f || x[i] > 1.f) return false;
  return true;
}

// ENCODE: one thread a (point, level), level fastest; out (N, L·C)
template <int D>
__global__ void __launch_bounds__(BLOCK)
    encode_any_kernel(const float* __restrict__ x,
                      const float* __restrict__ table,
                      const LevelAny* __restrict__ levels, int n_levels,
                      int C, long long n, float off, int smooth,
                      float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= n * n_levels) return;
  const long long p = t / n_levels;
  const int l = (int)(t - p * n_levels);
  float xp[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xp[d] = __ldg(x + D * p + d);
  float* y = out + t * C;
  if (!in_unit_box(xp, D)) {
    for (int k = 0; k < C; ++k) y[k] = 0.f;
    return;
  }
  const LevelAny L = levels[l];
  const Cell<D> cell = cell_of<D>(L, xp, off, smooth);
  for (int k0 = 0; k0 < C; k0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < (1 << D); ++c) {
      float f[D], df[D], pex[D];
      factors<D>(cell, c, f, df);
      const float w = products<D>(f, pex);
      const float* row = table + corner_row<D>(L, cell, c) * C + k0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k0 + k < C) acc[k] = fmaf(w, __ldg(row + k), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k0 + k < C) y[k0 + k] = acc[k];
  }
}

// BWD: one thread a point, its levels in order
template <int D>
__global__ void __launch_bounds__(BLOCK)
    bwd_any_kernel(const float* __restrict__ x,
                   const float* __restrict__ table,
                   const LevelAny* __restrict__ levels, int n_levels, int C,
                   long long n, float off, int smooth,
                   const float* __restrict__ dy, float* __restrict__ d_table,
                   float* __restrict__ dx) {
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= n) return;
  float xp[D], gx[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xp[d] = __ldg(x + D * p + d);
    gx[d] = 0.f;
  }
  if (in_unit_box(xp, D)) {
    const long long lc = (long long)n_levels * C;
    for (int l = 0; l < n_levels; ++l) {
      const LevelAny L = levels[l];
      const Cell<D> cell = cell_of<D>(L, xp, off, smooth);
      const float* dyl = dy + p * lc + (long long)l * C;
      float gl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) gl[d] = 0.f;
#pragma unroll 4
      for (int c = 0; c < (1 << D); ++c) {
        float f[D], df[D], pex[D];
        factors<D>(cell, c, f, df);
        const float w = products<D>(f, pex);
        const size_t row = corner_row<D>(L, cell, c) * C;
        float dot = 0.f;
        for (int k = 0; k < C; ++k) {
          const float g = __ldg(dyl + k);
          if (d_table) atomicAdd(d_table + row + k, w * g);
          if (dx) dot = fmaf(__ldg(table + row + k), g, dot);
        }
        if (dx) {
#pragma unroll
          for (int d = 0; d < D; ++d)
            gl[d] = fmaf(df[d] * pex[d], dot, gl[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) gx[d] += gl[d] * L.scale;
    }
  }
  if (dx) {
#pragma unroll
    for (int d = 0; d < D; ++d) dx[D * p + d] = gx[d];
  }
}

// BWD2: one thread a point, its levels in order. With a_e = g_e ∂f_e/∂t_e,
// Q = Σ_e a_e Π_{k≠e} f_k (u = s·Q) and, per axis d, ∂Q/∂f_d =
// Σ_{e≠d} a_e Π_{k≠d,e} f_k, by prefix and suffix pairs (P, R) over the
// axes: P' = P·f_k, R' = R·f_k + a_k·P.
template <int D>
__global__ void __launch_bounds__(BLOCK)
    bwd2_any_kernel(const float* __restrict__ x,
                    const float* __restrict__ table,
                    const LevelAny* __restrict__ levels, int n_levels, int C,
                    long long n, float off, int smooth,
                    const float* __restrict__ dy,
                    const float* __restrict__ g, float* __restrict__ d_dy,
                    float* __restrict__ d_table, float* __restrict__ d_x) {
  const long long p = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (p >= n) return;
  float xp[D], gp[D], ex[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xp[d] = __ldg(x + D * p + d);
    gp[d] = __ldg(g + D * p + d);
    ex[d] = 0.f;
  }
  const bool live = in_unit_box(xp, D);
  const long long lc = (long long)n_levels * C;
  for (int l = 0; l < n_levels; ++l) {
    float* ddy = d_dy ? d_dy + p * lc + (long long)l * C : nullptr;
    if (!live) {
      if (ddy)
        for (int k = 0; k < C; ++k) ddy[k] = 0.f;
      continue;
    }
    const LevelAny L = levels[l];
    const float s = L.scale;
    const Cell<D> cell = cell_of<D>(L, xp, off, smooth);
    const float* dyl = dy + p * lc + (long long)l * C;
    if (ddy)
      for (int k = 0; k < C; ++k) ddy[k] = 0.f;
    float el[D];
#pragma unroll
    for (int d = 0; d < D; ++d) el[d] = 0.f;
#pragma unroll 2
    for (int c = 0; c < (1 << D); ++c) {
      float f[D], df[D], a[D];
      factors<D>(cell, c, f, df);
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] = gp[d] * df[d];
      float pp[D + 1], pr[D + 1], sp[D + 1], sr[D + 1];
      pp[0] = 1.f;
      pr[0] = 0.f;
      sp[D] = 1.f;
      sr[D] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        pp[d + 1] = pp[d] * f[d];
        pr[d + 1] = fmaf(a[d], pp[d], pr[d] * f[d]);
      }
#pragma unroll
      for (int d = D - 1; d >= 0; --d) {
        sp[d] = f[d] * sp[d + 1];
        sr[d] = fmaf(a[d], sp[d + 1], sr[d + 1] * f[d]);
      }
      const float u = s * pr[D];
      const size_t row = corner_row<D>(L, cell, c) * C;
      float dot = 0.f;
      for (int k = 0; k < C; ++k) {
        const float dyk = __ldg(dyl + k);
        if (d_table) atomicAdd(d_table + row + k, u * dyk);
        if (ddy || d_x) {
          const float v = __ldg(table + row + k);
          if (ddy) ddy[k] = fmaf(u, v, ddy[k]);
          dot = fmaf(v, dyk, dot);
        }
      }
      if (d_x) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          // Σ_{e≠d} g_e ∂²w/∂t_d∂t_e, then the diagonal g_d ±S''_d Π f
          const float rex = fmaf(pr[d], sp[d + 1], pp[d] * sr[d + 1]);
          float h = df[d] * rex;
          if (smooth) {
            const float dd = ((c >> d) & 1) ? cell.s2[d] : -cell.s2[d];
            h = fmaf(gp[d] * dd, pp[d] * sp[d + 1], h);
          }
          el[d] = fmaf(h, dot, el[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) ex[d] += (el[d] * s) * s;
  }
  if (d_x) {
#pragma unroll
    for (int d = 0; d < D; ++d) d_x[D * p + d] = ex[d];
  }
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + BLOCK - 1) / BLOCK);
}

struct Args {
  const float* x;
  const float* table;
  const LevelAny* levels;
  int n_levels, C;
  long long n;
  float off;
  int smooth;
};

template <int D>
int encode(const Args& a, float* out, cudaStream_t s) {
  encode_any_kernel<D><<<blocks(a.n * a.n_levels), BLOCK, 0, s>>>(
      a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth, out);
  return (int)cudaGetLastError();
}

template <int D>
int bwd(const Args& a, const float* dy, float* d_table, float* dx,
        cudaStream_t s) {
  bwd_any_kernel<D><<<blocks(a.n), BLOCK, 0, s>>>(
      a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth, dy,
      d_table, dx);
  return (int)cudaGetLastError();
}

template <int D>
int bwd2(const Args& a, const float* dy, const float* g, float* d_dy,
         float* d_table, float* d_x, cudaStream_t s) {
  bwd2_any_kernel<D><<<blocks(a.n), BLOCK, 0, s>>>(
      a.x, a.table, a.levels, a.n_levels, a.C, a.n, a.off, a.smooth, dy, g,
      d_dy, d_table, d_x);
  return (int)cudaGetLastError();
}

// the instance for D (1..MAX_D), checked by the entries
#define MNERF_BY_D(D_, CALL)                \
  switch (D_) {                             \
    case 1: return CALL(1);                 \
    case 2: return CALL(2);                 \
    case 3: return CALL(3);                 \
    case 4: return CALL(4);                 \
    case 5: return CALL(5);                 \
    case 6: return CALL(6);                 \
    default: return CALL(7);                \
  }

int check(int d, int n_levels, int c) {
  if (d < 1 || d > MAX_D) return -1;
  if (n_levels < 1) return -2;
  if (c < 1) return -3;
  return 0;
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Each entry returns 0, a cudaError_t (> 0) from the launch, or a negative
// code for arguments the kernels do not take (ops/hashgrid.py maps each to
// a message):
//   -1 input_dim outside [1, 7] (the hash's primes)   -2 no levels
//   -3 level_dim < 1                                   -5 no output asked for
// x is (n, d), table (rows, c), `levels` n_levels × 16 int32 words;
// align_corners puts pos at x·scale (else x·scale + 0.5), smooth selects
// smoothstep interpolation. Each entry takes the card's index (int) and a
// stream of that card last (csrc/launch.cuh).
int mnerf_hash_any_encode(const float* x, const float* table,
                          const int* levels, int d, int n_levels, int c,
                          long long n, int align_corners, int smooth,
                          float* out, int device, void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) encode<D>(a, out, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

// BWD: d_table (rows × c, zeroed by the caller) and dx (n × d) may each be
// null (not computed), not both; `table` is read only for dx.
int mnerf_hash_any_bwd(const float* x, const float* table, const int* levels,
                       int d, int n_levels, int c, long long n,
                       int align_corners, int smooth, const float* dy,
                       float* d_table, float* dx, int device, void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  if (!d_table && !dx) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) bwd<D>(a, dy, d_table, dx, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

// BWD2: d_dy (n × L·c), d_table (rows × c, zeroed by the caller) and d_x
// (n × d) may each be null (not computed), not all three.
int mnerf_hash_any_bwd2(const float* x, const float* table,
                        const int* levels, int d, int n_levels, int c,
                        long long n, int align_corners, int smooth,
                        const float* dy, const float* g, float* d_dy,
                        float* d_table, float* d_x, int device,
                        void* stream) {
  if (int e = check(d, n_levels, c)) return e;
  if (!d_dy && !d_table && !d_x) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Args a{x, table, reinterpret_cast<const LevelAny*>(levels),
               n_levels, c, n, align_corners ? 0.f : 0.5f, smooth};
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_CALL(D) bwd2<D>(a, dy, g, d_dy, d_table, d_x, s)
  MNERF_BY_D(d, MNERF_CALL)
#undef MNERF_CALL
}

#undef MNERF_BY_D

}  // extern "C"
