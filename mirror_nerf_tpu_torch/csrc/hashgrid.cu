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
// BWD and BWD2, redesigned for the table grads' reductions (the first
// design ran one thread a (point, level) with a point's levels as 16 lanes,
// so a warp held two points of a level and every corner of every sample
// went to L2 as its own reduction; at a train batch's coarse levels those
// landed on a few thousand rows and cost ~2× a hashed level's):
//   * a warp holds 32 consecutive points of one level (a block of 16 warps
//     takes one tile of 32 points, warp w level w): neighbouring samples
//     of a ray sit in neighbouring lanes;
//   * a run of lanes in one cell (so at the same eight rows) sums its
//     corners by segmented shuffles and sends one 8-B no-return reduction a
//     corner from its first lane (`scatter_level`); where no two
//     neighbouring lanes share a cell (hashed levels of uniform points) no
//     shuffle runs;
//   * BWD sends a level's reductions, then issues its 8 corner loads for
//     dx01 (loads first measured ~2 % slower); BWD2 loads first (either
//     order measured the same);
//   * x, g and the tile's dy and d_dy rows move through shared memory as
//     whole rows; dx01 and d_x01 are summed over the levels there, in level
//     order, with no atomics. A point outside [0, 1]³ adds nothing and gets
//     zeros.
// The wrapper zeroes d_table. What bounds them on the H100: the reductions
// that remain (12.76M of a 1024 × 128 ray batch's 16.46M pairs,
// `ops/hashgrid.py reduction_plan`), most at the 12 hashed levels, where
// L2's atomic units take them at ~55 G/s; then the gathers.

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

// ---- BWD and BWD2 ----
//
// A block of BWD_WARPS warps takes one tile of TILE = 32 consecutive points:
// lane i takes point i and warp w levels w, w + 16, … (one level a warp at
// the model's 16), so that the 32 lanes of a warp hold 32 consecutive
// samples of one level. x (and g), the tile's dy rows and, for BWD2, its
// d_dy rows go through shared memory as whole coalesced rows; each warp's
// dx01 (d_x01) partial goes to shared memory and one thread a coordinate
// sums the levels in order.
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 32;
constexpr int BWD_WARPS = 16;
constexpr int BWD_THREADS = 32 * BWD_WARPS;

// The block's shared memory, in floats: x (and g) of the tile, its dy rows
// (and d_dy rows) at a row stride of 2L + 2 floats (conflict-free 8-B reads
// down a level) and the warps' dx01 partials.
struct BwdSmem {
  int xs, gs, dys, ddys, part, total;
};

__host__ __device__ constexpr BwdSmem bwd_smem(int n_levels, bool two) {
  BwdSmem s{};
  int o = 0;
  const int row = 2 * n_levels + 2;
  s.xs = o;
  o += 3 * TILE;
  s.gs = o;
  o += two ? 3 * TILE : 0;
  s.dys = o;
  o += TILE * row;
  s.ddys = o;
  o += two ? TILE * row : 0;
  s.part = o;
  o += BWD_WARPS * 3 * TILE;
  s.total = o;
  return s;
}
// sized to the launch's level count, within the 48 KB a launch gets
// without raising the kernel's attribute
static_assert(bwd_smem(MAX_LEVELS, true).total * sizeof(float) <= 48 * 1024,
              "BWD2's shared memory at MAX_LEVELS passes 48 KB");

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

// Corner c's three factors f_d (t_d for bit d set, else 1 − t_d);
// ∂f_d/∂t_d = +1 for bit d set, else −1.
__device__ __forceinline__ void factors(const Cell& k, int c, float (&f)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) f[d] = ((c >> d) & 1) ? k.t[d] : 1.f - k.t[d];
}

// Corner c's row in the flat table.
__device__ __forceinline__ unsigned corner_of(const Level& L, const Cell& k,
                                              int c) {
  return L.offset + corner_row(L, k.g[0] + (c & 1), k.g[1] + ((c >> 1) & 1),
                               k.g[2] + ((c >> 2) & 1));
}

__device__ __forceinline__ float sgn(int c, int d) {
  return ((c >> d) & 1) ? 1.f : -1.f;
}

// One level's table grads from one warp, `val(c)` corner c's value of a
// live lane. A run is a lane and the lanes after it that are live and in
// the same cell (so at the same eight rows); each run's sums leave from its
// first lane, one 8-B no-return reduction a corner into L2. The sums are
// segmented suffix sums by shuffles, as many steps as the warp's longest
// run needs: none where no two neighbouring lanes share a cell (a hashed
// level of uniform points).
template <typename Val>
__device__ __forceinline__ void scatter_level(const Cell& k, bool live,
                                              const unsigned (&row)[8],
                                              Val val,
                                              float2* __restrict__ d_table) {
  const int lane = threadIdx.x & 31;
  const unsigned q0 = __shfl_up_sync(FULL, k.g[0], 1),
                 q1 = __shfl_up_sync(FULL, k.g[1], 1),
                 q2 = __shfl_up_sync(FULL, k.g[2], 1);
  const int qlive = __shfl_up_sync(FULL, (int)live, 1);
  const bool head = lane == 0 || !live || !qlive || q0 != k.g[0] ||
                    q1 != k.g[1] || q2 != k.g[2];
  const unsigned later = __ballot_sync(FULL, head) & (0xFFFFFFFEu << lane);
  const int end = later ? __ffs(later) - 1 : 32;
  const unsigned longest = __reduce_max_sync(FULL, (unsigned)(end - lane));
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float2 a = live ? val(c) : make_float2(0.f, 0.f);
    for (unsigned o = 1; o < longest; o <<= 1) {
      const float ax = __shfl_down_sync(FULL, a.x, o),
                  ay = __shfl_down_sync(FULL, a.y, o);
      if (lane + (int)o < end) {
        a.x += ax;
        a.y += ay;
      }
    }
    if (head && live) atomicAdd(d_table + row[c], a);
  }
}

// The tile's inputs into shared memory: x (and g) as 96 floats each, zero
// past n; the tile's dy rows, one coalesced 8-B load a (point, level).
__device__ __forceinline__ void stage_tile(const float* __restrict__ x,
                                           const float* __restrict__ g,
                                           const float* __restrict__ dy,
                                           long long p0, int np, int n_levels,
                                           float* sm, const BwdSmem& S) {
  const int tid = threadIdx.x;
  if (tid < 3 * TILE)
    sm[S.xs + tid] = tid < 3 * np ? __ldg(x + 3 * p0 + tid) : 0.f;
  else if (g && tid < 6 * TILE)
    sm[S.gs + tid - 3 * TILE] =
        tid - 3 * TILE < 3 * np ? __ldg(g + 3 * p0 + tid - 3 * TILE) : 0.f;
  const int row = 2 * n_levels + 2;
  const float2* src = reinterpret_cast<const float2*>(dy) + p0 * n_levels;
  for (int i = tid; i < np * n_levels; i += BWD_THREADS) {
    const int p = i / n_levels, l = i - p * n_levels;
    *reinterpret_cast<float2*>(sm + S.dys + p * row + 2 * l) = __ldg(src + i);
  }
}

// The warps' partials of a tile's dx01 (or d_x01) summed over the warps in
// order (level order at ≤ 16 levels), one thread a coordinate.
__device__ __forceinline__ void sum_parts(const float* part, long long p0,
                                          int np, float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (tid < 3 * np) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) s += part[w * 3 * TILE + tid];
    out[3 * p0 + tid] = s;
  }
}

// BWD. Per level a lane sends its table grads, then loads its eight
// corner rows (dx01) and uses them (the loads first measured ~2 % slower).
template <bool TABLE, bool DX>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    hash_backward_kernel(const float* __restrict__ x,
                         const float* __restrict__ table,
                         const Level* __restrict__ levels, int n_levels,
                         long long n, const float* __restrict__ dy,
                         float* __restrict__ d_table, float* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdSmem S = bwd_smem(n_levels, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_w = 2 * n_levels + 2;
  float2* dt = reinterpret_cast<float2*>(d_table);
  const float2* t2 = reinterpret_cast<const float2*>(table);
  const long long p0 = (long long)blockIdx.x * TILE;
  const int np = (int)(n - p0 < TILE ? n - p0 : TILE);
  stage_tile(x, nullptr, dy, p0, np, n_levels, sm, S);
  __syncthreads();
  const float x0 = sm[S.xs + 3 * lane], x1 = sm[S.xs + 3 * lane + 1],
              x2 = sm[S.xs + 3 * lane + 2];
  const bool live = lane < np && in_unit_cube(x0, x1, x2);
  float gx[3] = {0.f, 0.f, 0.f};
  for (int l = warp; l < n_levels; l += BWD_WARPS) {
    const Level L = load_level(levels, l);
    const float2 dyl =
        *reinterpret_cast<const float2*>(sm + S.dys + lane * row_w + 2 * l);
    const Cell k = cell_of(L, x0, x1, x2);
    unsigned row[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = corner_of(L, k, c);
    if (TABLE)
      scatter_level(k, live, row, [&](int c) {
        float f[3];
        factors(k, c, f);
        const float w = __fmul_rn(__fmul_rn(f[0], f[1]), f[2]);
        return make_float2(w * dyl.x, w * dyl.y);
      }, dt);
    float2 v[8];
    if (DX) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = live ? __ldg(t2 + row[c]) : make_float2(0.f, 0.f);
    }
    if (DX && live) {
      float gl[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float f[3];
        factors(k, c, f);
        const float dot = fmaf(v[c].y, dyl.y, v[c].x * dyl.x);
        gl[0] = fmaf(sgn(c, 0) * (f[1] * f[2]), dot, gl[0]);
        gl[1] = fmaf(sgn(c, 1) * (f[0] * f[2]), dot, gl[1]);
        gl[2] = fmaf(sgn(c, 2) * (f[0] * f[1]), dot, gl[2]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d] += gl[d] * L.scale;
    }
  }
  float* part = sm + S.part;
  if (DX) {
#pragma unroll
    for (int d = 0; d < 3; ++d) part[warp * 3 * TILE + 3 * lane + d] = gx[d];
  }
  __syncthreads();
  if (DX) sum_parts(part, p0, np, dx);
}

// BWD2, the same threads: u_c = s ∇_t w_c · g; d_dy (N, L·2) is written for
// every level of every point (zero outside [0, 1]³), staged in shared
// memory and stored as the tile's whole rows.
template <bool TABLE, bool DDY, bool DX>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    hash_backward2_kernel(const float* __restrict__ x,
                          const float* __restrict__ table,
                          const Level* __restrict__ levels, int n_levels,
                          long long n, const float* __restrict__ dy,
                          const float* __restrict__ g,
                          float* __restrict__ d_dy,
                          float* __restrict__ d_table,
                          float* __restrict__ d_x) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BwdSmem S = bwd_smem(n_levels, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_w = 2 * n_levels + 2;
  float2* dt = reinterpret_cast<float2*>(d_table);
  const float2* t2 = reinterpret_cast<const float2*>(table);
  const long long p0 = (long long)blockIdx.x * TILE;
  const int np = (int)(n - p0 < TILE ? n - p0 : TILE);
  stage_tile(x, g, dy, p0, np, n_levels, sm, S);
  __syncthreads();
  const float x0 = sm[S.xs + 3 * lane], x1 = sm[S.xs + 3 * lane + 1],
              x2 = sm[S.xs + 3 * lane + 2];
  const float g0 = sm[S.gs + 3 * lane], g1 = sm[S.gs + 3 * lane + 1],
              g2 = sm[S.gs + 3 * lane + 2];
  const bool live = lane < np && in_unit_cube(x0, x1, x2);
  float ex[3] = {0.f, 0.f, 0.f};
  for (int l = warp; l < n_levels; l += BWD_WARPS) {
    const Level L = load_level(levels, l);
    const float s = L.scale;
    const float2 dyl =
        *reinterpret_cast<const float2*>(sm + S.dys + lane * row_w + 2 * l);
    const Cell k = cell_of(L, x0, x1, x2);
    unsigned row[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = corner_of(L, k, c);
    float2 v[8];
    if (DDY || DX) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = live ? __ldg(t2 + row[c]) : make_float2(0.f, 0.f);
    }
    // u_c = s (g0 ∂w/∂t0 + g1 ∂w/∂t1 + g2 ∂w/∂t2)
    auto u_of = [&](int c) {
      float f[3];
      factors(k, c, f);
      return s * fmaf(g2, sgn(c, 2) * (f[0] * f[1]),
                      fmaf(g1, sgn(c, 1) * (f[0] * f[2]),
                           g0 * (sgn(c, 0) * (f[1] * f[2]))));
    };
    if (TABLE)
      scatter_level(k, live, row, [&](int c) {
        const float u = u_of(c);
        return make_float2(u * dyl.x, u * dyl.y);
      }, dt);
    float2 ddy = make_float2(0.f, 0.f);
    if ((DDY || DX) && live) {
      float el[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float u = u_of(c);
        if (DDY) {
          ddy.x = fmaf(u, v[c].x, ddy.x);
          ddy.y = fmaf(u, v[c].y, ddy.y);
        }
        if (DX) {
          float f[3];
          factors(k, c, f);
          const float s0 = sgn(c, 0), s1 = sgn(c, 1), s2 = sgn(c, 2);
          const float dot = fmaf(v[c].y, dyl.y, v[c].x * dyl.x);
          // ∂²w/∂t_d∂t_e = s_d s_e f_other for d ≠ e
          const float h01 = s0 * s1 * f[2], h02 = s0 * s2 * f[1],
                      h12 = s1 * s2 * f[0];
          el[0] = fmaf(fmaf(g2, h02, g1 * h01), dot, el[0]);
          el[1] = fmaf(fmaf(g2, h12, g0 * h01), dot, el[1]);
          el[2] = fmaf(fmaf(g1, h12, g0 * h02), dot, el[2]);
        }
      }
      if (DX) {
#pragma unroll
        for (int d = 0; d < 3; ++d) ex[d] += (el[d] * s) * s;
      }
    }
    if (DDY)
      *reinterpret_cast<float2*>(sm + S.ddys + lane * row_w + 2 * l) = ddy;
  }
  float* part = sm + S.part;
  if (DX) {
#pragma unroll
    for (int d = 0; d < 3; ++d) part[warp * 3 * TILE + 3 * lane + d] = ex[d];
  }
  __syncthreads();
  if (DX) sum_parts(part, p0, np, d_x);
  if (DDY) {
    float2* dst = reinterpret_cast<float2*>(d_dy) + p0 * n_levels;
    for (int i = threadIdx.x; i < np * n_levels; i += BWD_THREADS) {
      const int p = i / n_levels, l = i - p * n_levels;
      dst[i] = *reinterpret_cast<const float2*>(sm + S.ddys + p * row_w +
                                                2 * l);
    }
  }
}

unsigned bwd_blocks(long long n) {
  return (unsigned)((n + TILE - 1) / TILE);
}

template <bool TABLE, bool DX>
int launch_bwd(const float* x, const float* table, const Level* lv,
               int n_levels, long long n, const float* dy, float* d_table,
               float* dx, cudaStream_t s) {
  const size_t smem = bwd_smem(n_levels, false).total * sizeof(float);
  hash_backward_kernel<TABLE, DX><<<bwd_blocks(n), BWD_THREADS, smem, s>>>(
      x, table, lv, n_levels, n, dy, d_table, dx);
  return (int)cudaGetLastError();
}

template <bool TABLE, bool DDY, bool DX>
int launch_bwd2(const float* x, const float* table, const Level* lv,
                int n_levels, long long n, const float* dy, const float* g,
                float* d_dy, float* d_table, float* d_x, cudaStream_t s) {
  const size_t smem = bwd_smem(n_levels, true).total * sizeof(float);
  hash_backward2_kernel<TABLE, DDY, DX>
      <<<bwd_blocks(n), BWD_THREADS, smem, s>>>(x, table, lv, n_levels, n,
                                                dy, g, d_dy, d_table, d_x);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (d_table && dx)
    return launch_bwd<true, true>(x, table, lv, n_levels, n, dy, d_table, dx,
                                  s);
  if (d_table)
    return launch_bwd<true, false>(x, table, lv, n_levels, n, dy, d_table,
                                   dx, s);
  return launch_bwd<false, true>(x, table, lv, n_levels, n, dy, d_table, dx,
                                 s);
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
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_BWD2(T, D, X)                                                \
  return launch_bwd2<T, D, X>(x, table, lv, n_levels, n, dy, g, d_dy,      \
                              d_table, d_x, s)
  switch (which) {
    case 1: MNERF_BWD2(false, false, true);
    case 2: MNERF_BWD2(false, true, false);
    case 3: MNERF_BWD2(false, true, true);
    case 4: MNERF_BWD2(true, false, false);
    case 5: MNERF_BWD2(true, false, true);
    case 6: MNERF_BWD2(true, true, false);
    default: MNERF_BWD2(true, true, true);
  }
#undef MNERF_BWD2
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
