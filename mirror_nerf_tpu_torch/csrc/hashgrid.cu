// Multiresolution hash-grid lookups, one kernel library (sm_90a), five modes
// built from shared device functions:
//
//   GATHER replaces the Pallas TPU probe kernel `_scalar_loop_kernel`
//     (tools/exp_hash_inkernel.py:59, driven by scalar_loop_gather:97 →
//     :104): rows of an (R, C) table, fp32 or bf16, at int32 indices of any
//     shape, copied bit for bit. Device function: `copy_row`.
//   DENSE replaces `_dense_matmul_kernel` (tools/exp_hash_inkernel.py:137;
//     dense_matmul_lookup:168 → :171): the trilinear lookup of one dense
//     level from its flat rows (row x + y·side + z·side², modulo the row
//     count) at pos = x·scale + 0.5, fp32. Device functions:
//     `dense_corners` / `dense_sum`, interp_level's arithmetic with the
//     x-pair of corners (rows r, r + 1) as one 16-B load where r + 1
//     follows r and r is 16-B aligned (two samples a thread, every load
//     before the FMAs, measured no faster). Its output equals that of
//     `interp_level`, its first design, bit for bit.
//   ENCODE is the encoder the probe was written for: the hash-grid model's
//     `hashgrid_encode` (mirror_nerf_tpu/ops/hashgrid.py:139, XLA gathers
//     in the JAX package) for every level of a point, (N, 3) x01 →
//     (N, L·C), zero for a point outside [0, 1]³. Each level is
//     `interp_level`, whose corner loads are `copy_row`; a hashed level's
//     row is the uint32 xor of coordinate·prime (gridencoder.cu:51-66)
//     modulo its size, a dense level's the strided sum. With --fused_field
//     the renderer's noise-free passes take the fused NGP composite
//     (`hash_field_kernel`, csrc/fused_cp_composite.cu) instead, which
//     interpolates with the same device functions (csrc/hashgrid.cuh).
//   BWD is ENCODE's backward (a GPU addition: the JAX package trains the
//     hash grid through XLA's autodiff of its gathers, scatter-adds for the
//     table): from dy (N, L·C) it adds w_c·dy_l into d_table (R, C) and
//     writes dx01 (N, 3) = Σ_l s_l Σ_c ∇_t w_c ⟨T[row_c], dy_l⟩, either or
//     both. With dx01 alone it is the ∇σ = Jᵀ·v of an eval render.
//   BWD2 is BWD's backward for a cotangent g (N, 3) of dx01 (the normal
//     losses' grad-of-grad): with u_c = s_l ∇_t w_c · g it writes
//     d_dy_l = Σ_c u_c T[row_c], adds u_c·dy_l into d_table and writes
//     d_x01_e = Σ_l s_l² Σ_c Σ_{d≠e} g_d ∂²w_c/∂t_d∂t_e ⟨T[row_c], dy_l⟩
//     (trilinear weights have only mixed second derivatives), any subset.
//     A cotangent on BWD's d_table needs no mode: it is ENCODE (d_dy) and
//     BWD's dx01 with that cotangent as the table (ops/hashgrid.py).
// The TPU kernels' design is gone: no hat basis, no T2 reorder, no (8, 128)
// block loads with iota-mask selects, no bf16 hat weights. Those answered
// Mosaic's lack of a scalar gather; a GPU thread loads any address.
//
// pos = x·scale + 0.5 is one fused multiply-add (__fmaf_rn) with the fp32
// scale: XLA contracts the JAX package's expression the same way, as nvcc
// does the reference's CUDA encoder. Two roundings would move pos by one
// ulp (5e-4 of a cell at the finest level) for a few % of the points. The
// plain PyTorch version rounds once too (ops/hashgrid.py `_grid_pos`).
//
// What bounds it on the H100: the gathers. A point costs L·8 row loads of
// C·4 bytes at data-dependent addresses (16 × 8 × 8 B = 1 KB at the model's
// spec) against 12 B in and L·C·4 = 128 B out; the compulsory traffic is
// those bytes and the table once (52.9 MB at bound 6), ~0.1 ms for 2M
// points at 3.35 TB/s. The design, simple first:
//   * one thread per (point, level), level fastest: the 16 threads of a
//     point write its 128 B of features contiguously, a warp 256 B;
//   * the level table (8 words a level) is read from a small device array
//     (uniform within a level, cached); a dense level's rows (≤ 1.9 MB at
//     bound 6) stay in L2, a hashed level's 4 MB of rows mostly do too
//     (the whole table is 52.9 MB against 50 MB of L2);
//   * corner rows are read-only loads (__ldg) of one 8-byte access for C = 2
//     (DENSE: a 16-B access for an aligned x-pair);
//   * nothing is staged in shared memory, no tensor-core work: gathers and
//     the FMAs of the interpolation on the CUDA cores.
// BWD and BWD2, a first design: one thread per (point, level slot), the
// slots of a point a power of two P ≥ L (16 at the model's spec), so that a
// point's slots are P aligned lanes of one warp and its dx01 is summed over
// its levels by warp shuffles, without atomics; a point outside [0, 1]³
// adds nothing and gets dx01 = 0. The table grads go out as 8-B vector
// reductions (atomicAdd on float2) into a d_table the wrapper zeroes. What
// bounds them: the same gathers as ENCODE plus a read-modify-write of each
// table sector they touch; at the coarse levels (level 0 is dense, 4,913
// rows) every sample of a batch adds into the same few thousand rows, and
// those same-row reductions are likely the pace-setter (measured in
// chip_smoke.py with the reductions' count and the level split).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hashgrid.cuh"
#include "launch.cuh"

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int BLOCK = 256;
// DENSE's samples a thread (tools/exp_hash_diag.py --dense times two: no
// faster on an H100)
constexpr int DENSE_SPT = 1;

// Level, load_level, copy_row, corner_row and interp_level are in
// csrc/hashgrid.cuh (shared with the fused NGP composite).

template <int BYTES>
__device__ __forceinline__ void store_row(unsigned char* __restrict__ base,
                                          size_t row, const void* src) {
  using U = typename Unit<BYTES>::T;
  constexpr int K = BYTES / sizeof(U);
  U u[K];
  memcpy(u, src, BYTES);
  U* dst = reinterpret_cast<U*>(base + row * BYTES);
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = u[k];
}

template <int C>
__global__ void __launch_bounds__(BLOCK)
    hash_encode_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       const Level* __restrict__ levels, int n_levels,
                       long long n, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= n * n_levels) return;
  const long long p = t / n_levels;
  const int l = (int)(t - p * n_levels);
  const float x0 = __ldg(x + 3 * p), x1 = __ldg(x + 3 * p + 1),
              x2 = __ldg(x + 3 * p + 2);
  float acc[C];
  if (!in_unit_cube(x0, x1, x2)) {
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = 0.f;
  } else {
    const Level L = load_level(levels, l);
    interp_level<C>(table + (size_t)L.offset * C, L, x0, x1, x2, acc);
  }
  // out[p, l·C + k] = out[t·C + k]: level-fastest threads write contiguously
  store_row<C * 4>(reinterpret_cast<unsigned char*>(out), (size_t)t, acc);
}

template <int BYTES>
__global__ void __launch_bounds__(BLOCK)
    hash_gather_kernel(const unsigned char* __restrict__ table, long long rows,
                       const int* __restrict__ idx, long long n,
                       unsigned char* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  // JAX's table[idx]: a negative index counts from the end, then the row is
  // clamped into [0, rows): −1 reads rows − 1, −rows − 1 row 0, rows row
  // rows − 1
  long long r = __ldg(idx + i);
  if (r < 0) r += rows;
  r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  unsigned char v[BYTES];
  copy_row<BYTES>(table, (size_t)r, v);
  store_row<BYTES>(out, (size_t)i, v);
}

// DENSE: DENSE_SPT samples a thread (block-strided, so that the x loads and
// the output stores of a warp stay contiguous), every sample's corner loads
// issued before the first sample's FMAs (`dense_corners`, `dense_sum`);
// a sample past n reads the rows of x = 0 and stores nothing
__global__ void __launch_bounds__(BLOCK)
    hash_dense_kernel(const float* __restrict__ rows, Level L,
                      const float* __restrict__ x, long long n,
                      float* __restrict__ out) {
  const long long i0 =
      (long long)blockIdx.x * BLOCK * DENSE_SPT + threadIdx.x;
  DenseCorners d[DENSE_SPT];
#pragma unroll
  for (int s = 0; s < DENSE_SPT; ++s) {
    const long long i = i0 + (long long)s * BLOCK;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (i < n) {
      x0 = __ldg(x + 3 * i);
      x1 = __ldg(x + 3 * i + 1);
      x2 = __ldg(x + 3 * i + 2);
    }
    d[s] = dense_corners(rows, L, x0, x1, x2);
  }
#pragma unroll
  for (int s = 0; s < DENSE_SPT; ++s) {
    const long long i = i0 + (long long)s * BLOCK;
    if (i >= n) break;
    float acc[2];
    dense_sum(d[s], acc);
    store_row<8>(reinterpret_cast<unsigned char*>(out), (size_t)i, acc);
  }
}

// The slot count of a point: the power of two P = 2^lp ≥ n_levels.
int slots_log2(int n_levels) {
  int lp = 0;
  while ((1 << lp) < n_levels) ++lp;
  return lp;
}

// One level of one point, as BWD and BWD2 need it: the fraction t, the
// integer cell and the fp32 scale s (pos = x·s + 0.5 is ENCODE's FMA).
struct Cell {
  float t[3];
  unsigned g[3];
};

__device__ __forceinline__ Cell cell_of(const Level& L, float x0, float x1,
                                        float x2) {
  Cell k;
  const float p[3] = {__fmaf_rn(x0, L.scale, 0.5f),
                      __fmaf_rn(x1, L.scale, 0.5f),
                      __fmaf_rn(x2, L.scale, 0.5f)};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float f = floorf(p[d]);
    k.t[d] = p[d] - f;
    k.g[d] = (unsigned)(int)f;
  }
  return k;
}

// Corner c's row in the flat table and its three factors f_d (t_d for bit d
// set, else 1 − t_d); ∂f_d/∂t_d = +1 for bit d set, else −1.
__device__ __forceinline__ unsigned corner_of(const Level& L, const Cell& k,
                                              int c, float (&f)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) f[d] = ((c >> d) & 1) ? k.t[d] : 1.f - k.t[d];
  return L.offset + corner_row(L, k.g[0] + (c & 1), k.g[1] + ((c >> 1) & 1),
                               k.g[2] + ((c >> 2) & 1));
}

__device__ __forceinline__ float sgn(int c, int d) {
  return ((c >> d) & 1) ? 1.f : -1.f;
}

// Sum v over the P = 2^lp aligned lanes of a point's slots; every lane of
// the warp calls it (inactive slots hold zeros).
__device__ __forceinline__ float slot_sum(float v, int lp) {
  for (int o = (1 << lp) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// BWD: thread t is slot l = t mod P of point p = t / P; slots l ≥ L and
// points past n compute nothing but join the shuffles.
template <bool TABLE, bool DX>
__global__ void __launch_bounds__(BLOCK)
    hash_backward_kernel(const float* __restrict__ x,
                    const float* __restrict__ table,
                    const Level* __restrict__ levels, int n_levels, int lp,
                    long long n, const float* __restrict__ dy,
                    float* __restrict__ d_table, float* __restrict__ dx) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long p = t >> lp;
  const int l = (int)(t & ((1 << lp) - 1));
  float gx[3] = {0.f, 0.f, 0.f};
  if (p < n && l < n_levels) {
    const float x0 = __ldg(x + 3 * p), x1 = __ldg(x + 3 * p + 1),
                x2 = __ldg(x + 3 * p + 2);
    if (in_unit_cube(x0, x1, x2)) {
      const Level L = load_level(levels, l);
      const float2 dyl = __ldg(reinterpret_cast<const float2*>(
          dy + 2 * (p * n_levels + l)));
      const Cell k = cell_of(L, x0, x1, x2);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float f[3];
        const unsigned row = corner_of(L, k, c, f);
        if (TABLE) {
          const float w = __fmul_rn(__fmul_rn(f[0], f[1]), f[2]);
          atomicAdd(reinterpret_cast<float2*>(d_table) + row,
                    make_float2(w * dyl.x, w * dyl.y));
        }
        if (DX) {
          const float2 v =
              __ldg(reinterpret_cast<const float2*>(table) + row);
          const float dot = fmaf(v.y, dyl.y, v.x * dyl.x);
          gx[0] = fmaf(sgn(c, 0) * (f[1] * f[2]), dot, gx[0]);
          gx[1] = fmaf(sgn(c, 1) * (f[0] * f[2]), dot, gx[1]);
          gx[2] = fmaf(sgn(c, 2) * (f[0] * f[1]), dot, gx[2]);
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d] *= L.scale;
    }
  }
  if (DX) {
#pragma unroll
    for (int d = 0; d < 3; ++d) gx[d] = slot_sum(gx[d], lp);
    if (l == 0 && p < n) {
      dx[3 * p] = gx[0];
      dx[3 * p + 1] = gx[1];
      dx[3 * p + 2] = gx[2];
    }
  }
}

// BWD2, the same threads: u_c = s ∇_t w_c · g; d_dy (N, L·2) is written for
// every level of every point (zero outside [0, 1]³).
template <bool TABLE, bool DDY, bool DX>
__global__ void __launch_bounds__(BLOCK)
    hash_backward2_kernel(const float* __restrict__ x,
                     const float* __restrict__ table,
                     const Level* __restrict__ levels, int n_levels, int lp,
                     long long n, const float* __restrict__ dy,
                     const float* __restrict__ g, float* __restrict__ d_dy,
                     float* __restrict__ d_table, float* __restrict__ d_x) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long p = t >> lp;
  const int l = (int)(t & ((1 << lp) - 1));
  const bool live = p < n && l < n_levels;
  float ex[3] = {0.f, 0.f, 0.f};
  float2 ddy = make_float2(0.f, 0.f);
  if (live) {
    const float x0 = __ldg(x + 3 * p), x1 = __ldg(x + 3 * p + 1),
                x2 = __ldg(x + 3 * p + 2);
    if (in_unit_cube(x0, x1, x2)) {
      const Level L = load_level(levels, l);
      const float s = L.scale;
      const float g0 = __ldg(g + 3 * p), g1 = __ldg(g + 3 * p + 1),
                  g2 = __ldg(g + 3 * p + 2);
      const float2 dyl = __ldg(reinterpret_cast<const float2*>(
          dy + 2 * (p * n_levels + l)));
      const Cell k = cell_of(L, x0, x1, x2);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float f[3];
        const unsigned row = corner_of(L, k, c, f);
        const float s0 = sgn(c, 0), s1 = sgn(c, 1), s2 = sgn(c, 2);
        // u_c = s (g0 ∂w/∂t0 + g1 ∂w/∂t1 + g2 ∂w/∂t2)
        const float u =
            s * fmaf(g2, s2 * (f[0] * f[1]),
                     fmaf(g1, s1 * (f[0] * f[2]), g0 * (s0 * (f[1] * f[2]))));
        if (TABLE)
          atomicAdd(reinterpret_cast<float2*>(d_table) + row,
                    make_float2(u * dyl.x, u * dyl.y));
        if (DDY || DX) {
          const float2 v =
              __ldg(reinterpret_cast<const float2*>(table) + row);
          if (DDY) {
            ddy.x = fmaf(u, v.x, ddy.x);
            ddy.y = fmaf(u, v.y, ddy.y);
          }
          if (DX) {
            const float dot = fmaf(v.y, dyl.y, v.x * dyl.x);
            // ∂²w/∂t_d∂t_e = s_d s_e f_other for d ≠ e
            const float h01 = s0 * s1 * f[2], h02 = s0 * s2 * f[1],
                        h12 = s1 * s2 * f[0];
            ex[0] = fmaf(fmaf(g2, h02, g1 * h01), dot, ex[0]);
            ex[1] = fmaf(fmaf(g2, h12, g0 * h01), dot, ex[1]);
            ex[2] = fmaf(fmaf(g1, h12, g0 * h02), dot, ex[2]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) ex[d] = (ex[d] * s) * s;
    }
  }
  if (DDY && live)
    reinterpret_cast<float2*>(d_dy)[p * n_levels + l] = ddy;
  if (DX) {
#pragma unroll
    for (int d = 0; d < 3; ++d) ex[d] = slot_sum(ex[d], lp);
    if (l == 0 && p < n) {
      d_x[3 * p] = ex[0];
      d_x[3 * p + 1] = ex[1];
      d_x[3 * p + 2] = ex[2];
    }
  }
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + BLOCK - 1) / BLOCK);
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Each entry returns 0, a cudaError_t (> 0) from the launch, or a negative
// code for arguments the kernel does not take (ops/hashgrid.py maps each to
// a message):
//   -1 level count outside [1, MAX_LEVELS]
//   -2 C not 2 (ENCODE, DENSE: the model's level_dim) or not 1, 2, 4, 8
//      (GATHER)
//   -3 element size not 2 or 4 bytes         -4 no rows, or side < 2
//   -5 BWD or BWD2 asked for no output
// Each entry takes the card's index (int) and a stream of that card last;
// the guard makes the card current for the launch (csrc/launch.cuh).
// Pointers are device pointers on that card; `levels` holds n_levels × 8
// int32 words.
int mnerf_hash_encode(const float* x, const float* table, const int* levels,
                      int n_levels, int c, long long n, float* out,
                      int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  const Level* lv = reinterpret_cast<const Level*>(levels);
  if (c != 2) return -2;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  hash_encode_kernel<2><<<blocks(n * n_levels), BLOCK, 0,
                          (cudaStream_t)stream>>>(x, table, lv, n_levels, n,
                                                  out);
  return (int)cudaGetLastError();
}

// BWD: d_table (rows × 2, zeroed by the caller) and dx01 (N × 3) may each
// be null (not computed), not both; `table` is read only for dx01.
int mnerf_hash_bwd(const float* x, const float* table, const int* levels,
                   int n_levels, int c, long long n, const float* dy,
                   float* d_table, float* dx, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  if (c != 2) return -2;
  if (!d_table && !dx) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Level* lv = reinterpret_cast<const Level*>(levels);
  const int lp = slots_log2(n_levels);
  const unsigned b = blocks(n << lp);
  cudaStream_t s = (cudaStream_t)stream;
  if (d_table && dx)
    hash_backward_kernel<true, true><<<b, BLOCK, 0, s>>>(x, table, lv, n_levels,
                                                    lp, n, dy, d_table, dx);
  else if (d_table)
    hash_backward_kernel<true, false><<<b, BLOCK, 0, s>>>(
        x, table, lv, n_levels, lp, n, dy, d_table, dx);
  else
    hash_backward_kernel<false, true><<<b, BLOCK, 0, s>>>(
        x, table, lv, n_levels, lp, n, dy, d_table, dx);
  return (int)cudaGetLastError();
}

// BWD2: d_dy (N × L·2), d_table (rows × 2, zeroed by the caller) and d_x
// (N × 3) may each be null (not computed), not all three.
int mnerf_hash_bwd2(const float* x, const float* table, const int* levels,
                    int n_levels, int c, long long n, const float* dy,
                    const float* g, float* d_dy, float* d_table, float* d_x,
                    int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  if (c != 2) return -2;
  const int which = (d_table ? 4 : 0) | (d_dy ? 2 : 0) | (d_x ? 1 : 0);
  if (!which) return -5;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const Level* lv = reinterpret_cast<const Level*>(levels);
  const int lp = slots_log2(n_levels);
  const unsigned b = blocks(n << lp);
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_BWD2(T, D, X)                                                  \
  hash_backward2_kernel<T, D, X><<<b, BLOCK, 0, s>>>(x, table, lv, n_levels, lp, \
                                                n, dy, g, d_dy, d_table, d_x)
  switch (which) {
    case 1: MNERF_BWD2(false, false, true); break;
    case 2: MNERF_BWD2(false, true, false); break;
    case 3: MNERF_BWD2(false, true, true); break;
    case 4: MNERF_BWD2(true, false, false); break;
    case 5: MNERF_BWD2(true, false, true); break;
    case 6: MNERF_BWD2(true, true, false); break;
    default: MNERF_BWD2(true, true, true); break;
  }
#undef MNERF_BWD2
  return (int)cudaGetLastError();
}

int mnerf_hash_gather(const void* table, long long rows, int c,
                      int elem_bytes, const int* idx, long long n, void* out,
                      int device, void* stream) {
  if (rows < 1) return -4;
  if (elem_bytes != 2 && elem_bytes != 4) return -3;
  if (c != 1 && c != 2 && c != 4 && c != 8) return -2;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const unsigned char* t = static_cast<const unsigned char*>(table);
  unsigned char* o = static_cast<unsigned char*>(out);
  const unsigned g = blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (c * elem_bytes) {
    case 2: hash_gather_kernel<2><<<g, BLOCK, 0, s>>>(t, rows, idx, n, o); break;
    case 4: hash_gather_kernel<4><<<g, BLOCK, 0, s>>>(t, rows, idx, n, o); break;
    case 8: hash_gather_kernel<8><<<g, BLOCK, 0, s>>>(t, rows, idx, n, o); break;
    case 16: hash_gather_kernel<16><<<g, BLOCK, 0, s>>>(t, rows, idx, n, o); break;
    case 32: hash_gather_kernel<32><<<g, BLOCK, 0, s>>>(t, rows, idx, n, o); break;
  }
  return (int)cudaGetLastError();
}

int mnerf_hash_dense(const float* rows, long long n_rows, int c,
                     const float* x, long long n, float scale, int side,
                     float* out, int device, void* stream) {
  if (n_rows < 1 || n_rows > 0xFFFFFFFFll || side < 2) return -4;
  if (c != 2) return -2;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Level L;
  L.offset = 0;
  L.size = (unsigned)n_rows;
  L.scale = scale;
  L.stride[0] = 1;
  L.stride[1] = (unsigned)side;
  L.stride[2] = (unsigned)side * (unsigned)side;
  L.use_hash = 0;
  L.pad = 0;
  hash_dense_kernel<<<blocks((n + DENSE_SPT - 1) / DENSE_SPT), BLOCK, 0,
                      (cudaStream_t)stream>>>(rows, L, x, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
