// Fused CP-grid density + σ-gradient for training: a forward kernel and its
// hand-derived backward kernel (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (mirror_nerf_tpu/ops/pallas/fused_cp_train.py:248 and :257, driven by
// `_fwd_call:415` / `_bwd_call:433` under the custom VJPs
// `fused_density_grad:466` and `fused_density:519`). Same function, not the
// same layout: the TPU kernels' hat/slope basis matmuls, lane-major blocks,
// packed 24-row cotangent and VMEM stash answered TPU limits and are gone.
// Here the CP lookup is a gather-lerp, as in fused_cp_composite.cu.
//
// Per sample x (raw world coords), bound b, x01 = (x + b)·(1/2b) and
// inb_a = [0 ≤ x01_a ≤ 1] / 2b. Per level (G, R) and axis a the lerped row
// f_a (R) and its x-derivative g_a = (G−1)·inb_a·(row[i+1] − row[i]).
//   e    = fold^T · ⊕_l (f0 f1 f2)                    (32 features)
//   et_a = fold^T · ⊕_l (the product with f_a → g_a)  (tangent streams)
//   z1 = s1^T e (64), h = relu(z1), sg = s2^T h (16): σ = sg[0], geo = sg[1:]
//   ∇σ_a = s2[:,0] · ([z1 > 0] ⊙ s1^T et_a)
// The density-only variant stops at σ, geo and never builds g or et.
//
// The backward takes σ̄, ḡeo and n̄ (the cotangent of ∇σ) and returns d_x,
// the table grads and d_fold, d_s1, d_s2, second-order terms included. Two
// identities keep it small: with m = [z1 > 0] ⊙ s2[:,0],
//   Σ_a et_a ⊗ (m n̄_a) = u ⊗ m,  u = Σ_a n̄_a et_a = fold^T ⊕_l tpn,
//   tpn = n̄0 g0 f1 f2 + n̄1 f0 g1 f2 + n̄2 f0 f1 g2,
// and the tangent cotangents etbar_a = n̄_a · (s1 m): the three tangent
// streams of the forward collapse into one stream u and one vector v = s1 m.
// So d_s1 = Σ e ⊗ z̄1 + u ⊗ m, d_s2[:,0] += Σ [z1 > 0](s1^T u), d_fold =
// Σ p ⊗ ē + tpn ⊗ v, and per rank, with pb = fold ē and qv = fold v,
//   f̄_a = pb f_b f_c + qv (n̄_b g_b f_c + n̄_c f_b g_c),  ḡ_a = qv n̄_a f_b f_c,
//   rows i, i+1 of table (l, a) += f̄_a (1−w, w) ∓ ḡ_a (G−1) inb_a,
//   d x_a += Σ_r f̄_a g_a   (dg/dx = 0 a.e.; g = 0 outside the bound).
//
// What bounds it on the H100: arithmetic and atomics. A sample costs ~15k
// fp32 FMAs in the forward (the fold is 4 × 192 × 32 with tangents) and the
// backward recomputes that forward (no stash) before ~40k more instructions
// of its own. The design:
//   * fold, s1 and s2 (~37 KB at the default widths) live in shared memory,
//     read at warp-uniform addresses (broadcasts); the CP tables (0.64 MB)
//     are read with __ldg through L1/L2;
//   * one thread per sample; the fold accumulates rank by rank, the hidden
//     layer is streamed unit by unit, so z1, h, t_a never exist as vectors;
//   * the dense weight grads are sums over samples of outer products. Each
//     warp reduces its 32 samples' products with a register transpose-sum
//     (31 shuffles per 32 entries, lane k ends with entry k), then issues one
//     atomicAdd per entry: 9216 per warp at the default widths;
//   * the table grads scatter to rows i and i+1 with atomicAdd (6 per rank),
//     as the reference's grid encoder backward does. Neighbouring samples of
//     a ray hit the same rows, so these atomics contend; warp-level
//     pre-aggregation is the next step. Atomics make the summation order,
//     and the last bits of the grads, vary from run to run.
// Everything is fp32 on the CUDA cores: no position goes through a reduced-
// precision (TF32) product.

#include <cuda_runtime.h>

namespace {

constexpr int F = 32;    // CP fold output features
constexpr int H = 64;    // σ-net hidden width
constexpr int NSG = 16;  // σ-net output: raw σ + 15 geo
constexpr int GEO = 15;
constexpr int MAX_LEVELS = 8;
constexpr int BLOCK = 128;
constexpr int SMEM_LIMIT = 232448;  // 227 KB of dynamic shared memory

struct Levels {
  int n;
  int G[MAX_LEVELS];
  int R[MAX_LEVELS];
  const float* tab[MAX_LEVELS][3];  // (G, R) row-major table of (level, axis)
};

struct TableGrads {
  float* tab[MAX_LEVELS][3];
};

// One axis of one level: the left row, the lerp weight and the slope scale
// (G−1)·inb, which is 0 outside the bound.
struct Axis {
  const float* lo;
  int xi;
  float w;
  float sl;
};

__device__ __forceinline__ Axis locate(const float* tab, int G, int R,
                                       float x01, float inb) {
  Axis ax;
  const float xf = fminf(fmaxf(x01, 0.f), 1.f) * (float)(G - 1);
  ax.xi = min((int)floorf(xf), G - 2);
  ax.w = xf - (float)ax.xi;
  ax.lo = tab + (long long)ax.xi * R;
  ax.sl = (float)(G - 1) * inb;
  return ax;
}

// Sum v[k] over the warp's 32 lanes for all k at once: lane k returns the
// sum of entry k. Each step hands half of the entries to the partner lane.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                    int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool up = (lane & s) != 0;
#pragma unroll
    for (int k = 0; k < s; ++k) {
      const float send = up ? v[k] : v[k + s];
      const float keep = up ? v[k + s] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

__device__ __forceinline__ void load_nets(float* smem, const float* fold,
                                          const float* s1, const float* s2,
                                          int sum_r) {
  const int nf = sum_r * F;
  for (int k = threadIdx.x; k < nf; k += BLOCK) smem[k] = fold[k];
  for (int k = threadIdx.x; k < F * H; k += BLOCK) smem[nf + k] = s1[k];
  for (int k = threadIdx.x; k < H * NSG; k += BLOCK)
    smem[nf + F * H + k] = s2[k];
  __syncthreads();
}

__device__ __forceinline__ void scale_rows(const float* xyz, long long i,
                                           bool active, float bound,
                                           float x01[3], float inb[3]) {
  // (x + b) · (1/2b) with the reciprocal rounded to fp32, as the plain
  // version computes it (TPUGridField.density): every sample falls in the
  // same grid cell. Within an ulp of a grid node a true division can land
  // in the neighbouring cell, whose slope differs (∇σ jumps across nodes).
  const float inv2b = 1.f / (2.f * bound);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = active ? xyz[i * 3 + a] : 0.f;
    x01[a] = __fmul_rn(x + bound, inv2b);
    inb[a] = (x01[a] >= 0.f && x01[a] <= 1.f) ? inv2b : 0.f;
  }
}

template <bool TANGENTS>
__global__ void __launch_bounds__(BLOCK) fwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ fold,
    const float* __restrict__ s1g, const float* __restrict__ s2g,
    const Levels lv, const int sum_r, const int n, const float bound,
    float* __restrict__ sigma, float* __restrict__ geo,
    float* __restrict__ grad) {
  extern __shared__ float smem[];
  load_nets(smem, fold, s1g, s2g, sum_r);
  const float* sfold = smem;
  const float* s1 = smem + sum_r * F;
  const float* s2 = s1 + F * H;

  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float x01[3], inb[3];
  scale_rows(xyz, i, true, bound, x01, inb);

  float e[F], et[3][F];
#pragma unroll
  for (int j = 0; j < F; ++j) {
    e[j] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) et[a][j] = 0.f;
  }
  int roff = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int G = lv.G[l], R = lv.R[l];
    Axis ax[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ax[a] = locate(lv.tab[l][a], G, R, x01[a], inb[a]);
    for (int r = 0; r < R; ++r) {
      float f[3], g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = __ldg(ax[a].lo + r);
        const float t1 = __ldg(ax[a].lo + R + r);
        f[a] = t0 * (1.f - ax[a].w) + t1 * ax[a].w;
        g[a] = ax[a].sl * (t1 - t0);
      }
      const float p = f[0] * f[1] * f[2];
      const float* fr = sfold + (roff + r) * F;
      if (TANGENTS) {
        const float tp0 = g[0] * f[1] * f[2];
        const float tp1 = f[0] * g[1] * f[2];
        const float tp2 = f[0] * f[1] * g[2];
#pragma unroll
        for (int j = 0; j < F; ++j) {
          const float fj = fr[j];
          e[j] = fmaf(p, fj, e[j]);
          et[0][j] = fmaf(tp0, fj, et[0][j]);
          et[1][j] = fmaf(tp1, fj, et[1][j]);
          et[2][j] = fmaf(tp2, fj, et[2][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < F; ++j) e[j] = fmaf(p, fr[j], e[j]);
      }
    }
    roff += R;
  }

  float sg[NSG], gr[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NSG; ++k) sg[k] = 0.f;
#pragma unroll 2
  for (int o = 0; o < H; ++o) {
    float z = 0.f, zt[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const float w1 = s1[j * H + o];
      z = fmaf(e[j], w1, z);
      if (TANGENTS) {
#pragma unroll
        for (int a = 0; a < 3; ++a) zt[a] = fmaf(et[a][j], w1, zt[a]);
      }
    }
    if (z > 0.f) {
#pragma unroll
      for (int k = 0; k < NSG; ++k) sg[k] = fmaf(z, s2[o * NSG + k], sg[k]);
      if (TANGENTS) {
#pragma unroll
        for (int a = 0; a < 3; ++a) gr[a] = fmaf(s2[o * NSG], zt[a], gr[a]);
      }
    }
  }
  sigma[i] = sg[0];
#pragma unroll
  for (int k = 0; k < GEO; ++k) geo[i * GEO + k] = sg[1 + k];
  if (TANGENTS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) grad[i * 3 + a] = gr[a];
  }
}

template <bool TANGENTS, bool NEED_DX>
__global__ void __launch_bounds__(BLOCK) bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ fold,
    const float* __restrict__ s1g, const float* __restrict__ s2g,
    const Levels lv, const int sum_r, const int n, const float bound,
    const float* __restrict__ dsig, const float* __restrict__ dgeo,
    const float* __restrict__ dgrad, float* __restrict__ dx,
    const TableGrads gt, float* __restrict__ d_fold,
    float* __restrict__ d_s1, float* __restrict__ d_s2) {
  extern __shared__ float smem[];
  load_nets(smem, fold, s1g, s2g, sum_r);
  const float* sfold = smem;
  const float* s1 = smem + sum_r * F;
  const float* s2 = s1 + F * H;

  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  // a warp past the end has nothing to add; a partly filled warp keeps its
  // idle lanes, with zero cotangents, for the shuffles
  if (i - lane >= n) return;
  const bool active = i < n;
  constexpr bool NEED_G = TANGENTS || NEED_DX;

  float x01[3], inb[3];
  scale_rows(xyz, i, active, bound, x01, inb);
  float sgbar[NSG], nb[3] = {0.f, 0.f, 0.f};
  sgbar[0] = active ? dsig[i] : 0.f;
#pragma unroll
  for (int k = 0; k < GEO; ++k) sgbar[1 + k] = active ? dgeo[i * GEO + k] : 0.f;
  if (TANGENTS && active) {
#pragma unroll
    for (int a = 0; a < 3; ++a) nb[a] = dgrad[i * 3 + a];
  }

  // --- forward recompute: e and the collapsed tangent stream u ---
  float e[F], u[F];
#pragma unroll
  for (int j = 0; j < F; ++j) e[j] = u[j] = 0.f;
  int roff = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int G = lv.G[l], R = lv.R[l];
    Axis ax[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ax[a] = locate(lv.tab[l][a], G, R, x01[a], inb[a]);
    for (int r = 0; r < R; ++r) {
      float f[3], g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = __ldg(ax[a].lo + r);
        const float t1 = __ldg(ax[a].lo + R + r);
        f[a] = t0 * (1.f - ax[a].w) + t1 * ax[a].w;
        g[a] = ax[a].sl * (t1 - t0);
      }
      const float p = f[0] * f[1] * f[2];
      const float* fr = sfold + (roff + r) * F;
      if (TANGENTS) {
        const float tpn = nb[0] * g[0] * f[1] * f[2]
                          + nb[1] * f[0] * g[1] * f[2]
                          + nb[2] * f[0] * f[1] * g[2];
#pragma unroll
        for (int j = 0; j < F; ++j) {
          e[j] = fmaf(p, fr[j], e[j]);
          u[j] = fmaf(tpn, fr[j], u[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < F; ++j) e[j] = fmaf(p, fr[j], e[j]);
      }
    }
    roff += R;
  }

  // --- σ-net reverse, two hidden units at a time (d_s2 rows o, o+1 are 32
  //     contiguous floats: one transpose-sum) ---
  float ebar[F], v[F], vals[32];
#pragma unroll
  for (int j = 0; j < F; ++j) ebar[j] = v[j] = 0.f;
#pragma unroll 1
  for (int o = 0; o < H; o += 2) {
    float hh[2], tn[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int oo = o + q;
      float z = 0.f, zu = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        z = fmaf(e[j], s1[j * H + oo], z);
        if (TANGENTS) zu = fmaf(u[j], s1[j * H + oo], zu);
      }
      const bool dm = z > 0.f;
      float hbar = 0.f;
#pragma unroll
      for (int k = 0; k < NSG; ++k) hbar = fmaf(s2[oo * NSG + k], sgbar[k], hbar);
      const float z1bar = dm ? hbar : 0.f;
      const float m = (TANGENTS && dm) ? s2[oo * NSG] : 0.f;
      hh[q] = dm ? z : 0.f;
      tn[q] = (TANGENTS && dm) ? zu : 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float w1 = s1[j * H + oo];
        ebar[j] = fmaf(w1, z1bar, ebar[j]);
        if (TANGENTS) v[j] = fmaf(w1, m, v[j]);
        vals[j] = TANGENTS ? fmaf(u[j], m, e[j] * z1bar) : e[j] * z1bar;
      }
      atomicAdd(d_s1 + lane * H + oo, warp_transpose_sum(vals, lane));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < NSG; ++k) vals[q * NSG + k] = hh[q] * sgbar[k];
      vals[q * NSG] += tn[q];
    }
    atomicAdd(d_s2 + o * NSG + lane, warp_transpose_sum(vals, lane));
  }

  // --- per level: d_fold rows, the product rule, table grads, d_x ---
  float dxa[3] = {0.f, 0.f, 0.f};
  roff = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int G = lv.G[l], R = lv.R[l];
    Axis ax[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ax[a] = locate(lv.tab[l][a], G, R, x01[a], inb[a]);
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      float f[3], g[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = __ldg(ax[a].lo + r);
        const float t1 = __ldg(ax[a].lo + R + r);
        f[a] = t0 * (1.f - ax[a].w) + t1 * ax[a].w;
        if (NEED_G) g[a] = ax[a].sl * (t1 - t0);
      }
      const float* fr = sfold + (roff + r) * F;
      float pb = 0.f, qv = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        pb = fmaf(fr[j], ebar[j], pb);
        if (TANGENTS) qv = fmaf(fr[j], v[j], qv);
      }
      const float p = f[0] * f[1] * f[2];
      const float tpn = TANGENTS ? nb[0] * g[0] * f[1] * f[2]
                                   + nb[1] * f[0] * g[1] * f[2]
                                   + nb[2] * f[0] * f[1] * g[2]
                                 : 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j)
        vals[j] = TANGENTS ? fmaf(tpn, v[j], p * ebar[j]) : p * ebar[j];
      atomicAdd(d_fold + (roff + r) * F + lane,
                warp_transpose_sum(vals, lane));

      float fb[3] = {pb * f[1] * f[2], pb * f[0] * f[2], pb * f[0] * f[1]};
      float gb[3] = {0.f, 0.f, 0.f};
      if (TANGENTS) {
        const float qb[3] = {qv * nb[0], qv * nb[1], qv * nb[2]};
        fb[0] += qb[1] * g[1] * f[2] + qb[2] * f[1] * g[2];
        fb[1] += qb[0] * g[0] * f[2] + qb[2] * f[0] * g[2];
        fb[2] += qb[0] * g[0] * f[1] + qb[1] * f[0] * g[1];
        gb[0] = qb[0] * f[1] * f[2];
        gb[1] = qb[1] * f[0] * f[2];
        gb[2] = qb[2] * f[0] * f[1];
      }
      if (active) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float c0 = fb[a] * (1.f - ax[a].w), c1 = fb[a] * ax[a].w;
          if (TANGENTS) {
            c0 -= gb[a] * ax[a].sl;
            c1 += gb[a] * ax[a].sl;
          }
          float* row = gt.tab[l][a] + (long long)ax[a].xi * R + r;
          atomicAdd(row, c0);
          atomicAdd(row + R, c1);
          if (NEED_DX) dxa[a] = fmaf(fb[a], g[a], dxa[a]);
        }
      }
    }
    roff += R;
  }
  if (NEED_DX && active) {
#pragma unroll
    for (int a = 0; a < 3; ++a) dx[i * 3 + a] = dxa[a];
  }
}

// Validates the level description; fills lv and returns ΣR, or a negative
// refusal code.
int make_levels(const float* const* tables, const int* level_g,
                const int* level_r, int n_levels, Levels* lv) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  lv->n = n_levels;
  int sum_r = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (level_g[l] < 2 || level_r[l] < 1) return -3;
    lv->G[l] = level_g[l];
    lv->R[l] = level_r[l];
    for (int a = 0; a < 3; ++a) lv->tab[l][a] = tables[l * 3 + a];
    sum_r += level_r[l];
  }
  if ((long long)(sum_r * F + F * H + H * NSG) * 4 > SMEM_LIMIT) return -5;
  return sum_r;
}

template <typename K>
int prepare(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Forward. Returns 0, a cudaError_t (> 0), or a negative code for arguments
// the kernel does not take (ops/fused_cp_train.py maps each to a message):
//   -1 level count outside [1, MAX_LEVELS]   -3 a level with G < 2 or R < 1
//   -5 the nets exceed the shared memory     -6 n < 1
// Device pointers except `tables` (a host array of n_levels × 3 device
// pointers, axis-minor), level_g and level_r (host arrays). `grad` is
// written only when `tangents` is set.
int mnerf_cp_train_fwd(const float* xyz, const float* fold, const float* s1,
                       const float* s2, const float* const* tables,
                       const int* level_g, const int* level_r, int n_levels,
                       int n, float bound, int tangents, float* sigma,
                       float* geo, float* grad, void* stream) {
  Levels lv;
  const int sum_r = make_levels(tables, level_g, level_r, n_levels, &lv);
  if (sum_r < 0) return sum_r;
  if (n < 1) return -6;
  const size_t smem = (size_t)(sum_r * F + F * H + H * NSG) * sizeof(float);
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  int e;
  if (tangents) {
    if ((e = prepare(fwd_kernel<true>, smem))) return e;
    fwd_kernel<true><<<grid, BLOCK, smem, s>>>(xyz, fold, s1, s2, lv, sum_r,
                                                n, bound, sigma, geo, grad);
  } else {
    if ((e = prepare(fwd_kernel<false>, smem))) return e;
    fwd_kernel<false><<<grid, BLOCK, smem, s>>>(xyz, fold, s1, s2, lv, sum_r,
                                                 n, bound, sigma, geo, grad);
  }
  return (int)cudaGetLastError();
}

// Backward: accumulates into d_tables (host array of device pointers, same
// order as `tables`), d_fold, d_s1 and d_s2, which the caller zeroes; writes
// dx (n, 3) when need_dx is set. dgrad is read only when `tangents` is set.
// Return codes as for the forward.
int mnerf_cp_train_bwd(const float* xyz, const float* fold, const float* s1,
                       const float* s2, const float* const* tables,
                       const int* level_g, const int* level_r, int n_levels,
                       int n, float bound, int tangents, int need_dx,
                       const float* dsig, const float* dgeo,
                       const float* dgrad, float* dx,
                       float* const* d_tables, float* d_fold, float* d_s1,
                       float* d_s2, void* stream) {
  Levels lv;
  const int sum_r = make_levels(tables, level_g, level_r, n_levels, &lv);
  if (sum_r < 0) return sum_r;
  if (n < 1) return -6;
  TableGrads gt;
  for (int l = 0; l < n_levels; ++l)
    for (int a = 0; a < 3; ++a) gt.tab[l][a] = d_tables[l * 3 + a];
  const size_t smem = (size_t)(sum_r * F + F * H + H * NSG) * sizeof(float);
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_BWD(T, D)                                                     \
  do {                                                                      \
    int e = prepare(bwd_kernel<T, D>, smem);                                \
    if (e) return e;                                                        \
    bwd_kernel<T, D><<<grid, BLOCK, smem, s>>>(                             \
        xyz, fold, s1, s2, lv, sum_r, n, bound, dsig, dgeo, dgrad, dx, gt,  \
        d_fold, d_s1, d_s2);                                                \
  } while (0)
  if (tangents) {
    if (need_dx) MNERF_BWD(true, true); else MNERF_BWD(true, false);
  } else {
    if (need_dx) MNERF_BWD(false, true); else MNERF_BWD(false, false);
  }
#undef MNERF_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
