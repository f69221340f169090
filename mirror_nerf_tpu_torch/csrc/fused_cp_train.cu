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
// So z̄1 = [z1 > 0] ⊙ (s2 sḡ), ē = s1 z̄1, d_s1 = Σ e ⊗ z̄1 + u ⊗ m,
// d_s2 = Σ h ⊗ sḡ, d_s2[:,0] += Σ [z1 > 0](s1^T u), d_fold = Σ p ⊗ ē +
// tpn ⊗ v, and per rank, with pb = fold ē and qv = fold v,
//   f̄_a = pb f_b f_c + qv (n̄_b g_b f_c + n̄_c f_b g_c),  ḡ_a = qv n̄_a f_b f_c,
//   rows i, i+1 of table (l, a) += f̄_a (1−w, w) ∓ ḡ_a (G−1) inb_a,
//   d x_a += Σ_r f̄_a g_a   (dg/dx = 0 a.e.; g = 0 outside the bound).
//
// What bounds it on the H100. A tangent forward needs ~17.4k multiply-adds
// a sample: the fold of P (192 × 32), the σ-net, v = s1 m and qv = fold v,
// since ∇σ_a = TP_a · qv; this design folds all four streams (4 × 192 ×
// 32) and takes the three tangent streams through s1, ~34k. The backward
// needs ~51k (the recompute of e and u, the σ-net reverse, pb and qv, and
// the dense grads, each over 192 ranks or 64 hidden units). fp32-accurate
// on the tensor cores as 3×TF32 that is 0.028 ms forward and 0.081 ms
// backward at T = 131072. The first design (one thread a sample, every
// product on the fp32 CUDA cores, scalar table loads, a warp transpose-sum
// and one atomicAdd a dense-grad entry a warp, six scalar table-grad
// atomics a rank) took 0.71 / 5.18 ms there, and 7.27 ms backward on ray-ordered samples:
// without its table-grad atomics 54 % less, without its dense-grad
// transpose-sums and atomics 39 % less on uniform points, and its forward
// 55 % less with 16-B table loads (tools/exp_train_diag.py, PERF.md §6).
// This design:
//   * a warp takes 16 samples at a time, two a lane: one m16 row tile of
//     `mma.sync.m16n8k8` TF32, row g sample 2g and row g + 8 sample 2g + 1
//     of the tile, so a lane's two samples are consecutive (a ray's, on the
//     main path). The grid is persistent: a block stages the nets once and
//     its 8 warps walk the tiles by a stride;
//   * every product runs as 3×TF32 (csrc/tf32.cuh) with fp32 accumulators:
//     the fold of [P; TP0; TP1; TP2] (forward) or [P; TPN] (backward) into
//     32 features, the σ-net 32 → 64 → 16 and its tangent streams, and in
//     the backward s2 sḡ, ē = s1 z̄1, v = s1 m, pb = fold ē, qv = fold v and
//     the dense grads. The tensor cores' sums truncate toward zero (as the
//     flagship kernel found, csrc/fused_mlp_t.cu): each k-tile of the fold
//     and of z1, and every two k-tiles of the other products, is summed
//     apart and added in fp32; σ's and ∇σ's last dots with s2[:,0] (64
//     terms each) run on the CUDA cores, as three layers of tensor-core
//     sums biased σ by −1.9e-7 of its scale. Positions (x01, the cell, the
//     lerp weight, the slope scale) stay fp32 with the first design's
//     roundings: only the rank products f·g and the weights enter a TF32
//     product;
//   * the fold's A fragments come straight from 16-B table loads: A columns
//     t, t + 4 of k-tiles 2p, 2p + 1 are ranks 16p + 4t … 16p + 4t + 3 (the
//     ρ order: the fold's rows are staged in it), so a lane reads a table
//     row's four adjacent ranks of each of its samples as one 16-B load;
//   * a layer's C fragments feed the next layer's A fragments in registers
//     (C columns 2t, 2t + 1 are A columns t, t + 4; the next weight's K rows
//     are staged in that order) in the forward. The backward writes each
//     per-sample vector (e, u, h, tn, z̄1, m, ē, v, and a 16-rank group's p
//     and tpn) to a warp's scratch rows in shared memory and reads it back
//     in whichever operand layout a product needs: the dense grads take the
//     samples as K (eᵀ z̄1, pᵀ ē, ...), the transposes of the forward's;
//   * pb and qv come out in the P fragments' own layout (the fold staged
//     transposed, its ranks in the σ order), so a lane holds f̄, ḡ for the
//     same two samples × four ranks it loaded;
//   * the dense grads (9216 floats) are summed over all of a block's tiles
//     before any write to the outputs: each warp keeps a running sum of its
//     tiles' partial products in its own stretch of a scratch buffer
//     (fragment order, 16-B loads and stores, no atomics; 36 KB a warp,
//     39 MB for 132 SMs, which the L2 holds), and at its end the block adds
//     its warps' sums in warp order and issues one atomicAdd an entry: 1.2M
//     at T = 131072 on 132 SMs in place of the first design's 37.7M. Atomics
//     across blocks, not per-block partials and a second reducing pass: no
//     second launch on a host-bound step, and the grads' last bits vary
//     from run to run, as they did. (Sums in shared memory were the first
//     try: Hopper has no fp32 add for shared memory, its atomicAdd is a
//     compare-and-swap loop, and those took 59 % of the backward.)
//   * the table grads scatter as 16-B vector reductions (atomicAdd on a
//     float4, sm_90): four ranks of row i or i + 1 of a sample at a time.
//     A lane's two consecutive samples are summed first where their rows
//     meet (the same cell, or neighbouring cells sharing a row): 2 or 3
//     reductions in place of 4. 288 vector reductions a sample at most, in
//     place of 1152 scalar atomics.
// Shared memory: the forward's nets split hi/lo in fragment order (74 KB at
// the default ΣR = 192); the backward's unsplit (70 KB: the fold twice, as
// B and as its transpose, s1 twice, s2ᵀ) and 8 warps' scratch rows (117
// KB): one block an SM. Both stage the fold twice, so the ranks of all
// levels (each padded to 16) may sum to 800 in the forward and 768 in the
// backward (its block down to one warp), against 1720 in the first design;
// past that an entry refuses with -5.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6, rows 2, 3),
// in turns with the first design: forward 0.208 ms against 0.707, backward
// 0.734 against 5.274 (uniform) and 0.890 against 8.318 (ray-ordered), at
// T = 131072; 13 % and 11 % of the 3×TF32 bounds. What holds the backward
// (tools/exp_train_diag.py): the tensor pipe (one TF32 product in place of
// three: −21 %), the table loads (−15 %), the dense sums (−11 %) and, on
// ray-ordered samples, the table-grad reductions (−19 %: neighbouring
// lanes' samples share rows, and only a lane's own two are summed). Runs
// summed over the whole tile by 12 lanes in turn cost more than that
// contention: +12 % uniform, +20 % ray-ordered (`run_sums`).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "launch.cuh"
#include "tf32.cuh"

namespace {

constexpr int F = 32;    // CP fold output features
constexpr int H = 64;    // σ-net hidden width
constexpr int NSG = 16;  // σ-net output: raw σ + 15 geo
constexpr int GEO = 15;
constexpr int MAX_LEVELS = 8;
constexpr int WARPS = 8;  // warps a block (the backward takes fewer when
                          // its shared memory does not fit)
constexpr int BLOCK = WARPS * 32;
constexpr int TILE = 16;  // samples a warp takes at a time
constexpr int SMEM_LIMIT = 232448;  // 227 KB of dynamic shared memory

// A backward warp's scratch rows (floats): 16 samples × ld, ld ≡ 4 mod 16
// (every read pattern at most 2-way bank conflicted).
constexpr int LD32 = 36, LD64 = 68, LD16 = 20;
constexpr int SE = 0;                  // e, then ē
constexpr int SU = SE + TILE * LD32;   // u, then v
constexpr int SZ = SU + TILE * LD32;   // h, then z̄1, then a group's p
constexpr int SM = SZ + TILE * LD64;   // tn, then m, then a group's tpn
constexpr int SG = SM + TILE * LD64;   // sḡ = (σ̄, ḡeo)
constexpr int SCR = SG + TILE * LD16;  // 3648 floats a warp

struct Levels {
  int n;
  int sum_r;                 // Σ R, each R a multiple of 16
  int G[MAX_LEVELS];
  int R[MAX_LEVELS];
  int p0[MAX_LEVELS];        // the level's first group of 16 ranks
  const float* tab[MAX_LEVELS][3];  // (G, R) row-major table of (level, axis)
};

struct TableGrads {
  float* tab[MAX_LEVELS][3];
};

struct Args {
  const float *xyz, *fold, *s1, *s2;
  Levels lv;
  long long n;
  float bound;
  float *sigma, *geo, *grad;               // forward
  const float *dsig, *dgeo, *dgrad;        // backward
  float* dx;
  TableGrads gt;
  float *d_fold, *d_s1, *d_s2;
  float* part;  // each warp's running dense-grad sums (fragment order)
};

// ---- index maps (ops/fused_cp_train.py mirrors them) ----------------------
enum Map { IDENT = 0, RHO = 1, SIGMA = 2, CORD = 3 };

// RHO: the rank of the fold's A column c of k-tile blk (16p + 4(c%4) + 2h +
// c/4 for blk = 2p + h); SIGMA: the rank of pb's C column c of n-tile blk
// (16p + 4(c/2) + 2h + c%2), the same rank a lane's A fragment holds there;
// CORD: the feature of A column c of k-tile blk fed from a C fragment
// (C column 2(c%4) + c/4).
__device__ __forceinline__ int remap(int mode, int i) {
  const int blk = i >> 3, c = i & 7;
  if (mode == RHO)
    return ((blk >> 1) << 4) + ((c & 3) << 2) + ((blk & 1) << 1) + (c >> 2);
  if (mode == SIGMA)
    return ((blk >> 1) << 4) + ((c >> 1) << 2) + ((blk & 1) << 1) + (c & 1);
  if (mode == CORD) return (blk << 3) + ((c & 3) << 1) + (c >> 2);
  return i;
}

// A logical (k × n) B matrix into shared memory in fragment order: tile
// (kt, nt), lane (g, t) holds B(8kt + t, 8nt + g) and B(8kt + t + 4,
// 8nt + g), where B(i, j) = w[km(i)][nm(j)] (row stride ldw), or
// w[nm(j)][km(i)] when `trans`. SPLIT stores (hi, hi, lo, lo), one 16-B
// load a fragment; otherwise the two floats, split at the load.
template <bool SPLIT>
__device__ void stage(const float* __restrict__ w, int ldw, bool trans,
                      int km, int nm, int k, int n, float* dst) {
  const int nt_n = n >> 3;
  const int total = (k >> 3) * nt_n * 32;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & 31, tile = idx >> 5;
    const int kt = tile / nt_n, nt = tile - kt * nt_n;
    const int nn = remap(nm, 8 * nt + (lane >> 2));
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = remap(km, 8 * kt + (lane & 3) + 4 * h);
      v[h] = trans ? w[nn * ldw + kk] : w[kk * ldw + nn];
    }
    if (SPLIT) {
      uint32_t h0, l0, h1, l1;
      tf32_split(v[0], h0, l0);
      tf32_split(v[1], h1, l1);
      reinterpret_cast<float4*>(dst)[idx] =
          make_float4(__uint_as_float(h0), __uint_as_float(h1),
                      __uint_as_float(l0), __uint_as_float(l1));
    } else {
      reinterpret_cast<float2*>(dst)[idx] = make_float2(v[0], v[1]);
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ BFrag ldb(const float* s, int nt_n, int kt, int nt,
                                     int lane) {
  const int idx = (kt * nt_n + nt) * 32 + lane;
  BFrag f;
  if (SPLIT) {
    const float4 b = reinterpret_cast<const float4*>(s)[idx];
    f.hi[0] = __float_as_uint(b.x);
    f.hi[1] = __float_as_uint(b.y);
    f.lo[0] = __float_as_uint(b.z);
    f.lo[1] = __float_as_uint(b.w);
  } else {
    const float2 b = reinterpret_cast<const float2*>(s)[idx];
    tf32_split(b.x, f.hi[0], f.lo[0]);
    tf32_split(b.y, f.hi[1], f.lo[1]);
  }
  return f;
}

__device__ __forceinline__ void add4(float acc[4], const float c[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += c[k];
}

// ---- a warp's scratch rows: row s is sample s of the tile ----------------

// C fragment (rows g = sample 2g, g + 8 = sample 2g + 1) at columns col,
// col + 1 of the scratch rows.
__device__ __forceinline__ void put_c(float* s, int ld, int col,
                                      const float c[4], int g) {
  *reinterpret_cast<float2*>(s + 2 * g * ld + col) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(s + (2 * g + 1) * ld + col) =
      make_float2(c[2], c[3]);
}

// A fragment with the samples as rows, K the columns 8kt … 8kt + 7.
__device__ __forceinline__ AFrag get_a(const float* s, int ld, int kt, int g,
                                       int t) {
  const float* r = s + 2 * g * ld + 8 * kt + t;
  return split_a(r[0], r[ld], r[4], r[ld + 4]);
}

// A fragment of the transpose: rows the columns m0 + g, m0 + g + 8, K the
// samples 8kt + t, 8kt + t + 4.
__device__ __forceinline__ AFrag get_at(const float* s, int ld, int m0,
                                        int kt, int g, int t) {
  const float* r = s + (8 * kt + t) * ld + m0 + g;
  return split_a(r[0], r[8], r[4 * ld], r[4 * ld + 8]);
}

// B fragment with the samples as K (8kt + t, 8kt + t + 4), N the column
// n0 + g.
__device__ __forceinline__ BFrag get_b(const float* s, int ld, int kt,
                                       int n0, int g, int t) {
  const float* r = s + (8 * kt + t) * ld + n0 + g;
  BFrag f;
  tf32_split(r[0], f.hi[0], f.lo[0]);
  tf32_split(r[4 * ld], f.hi[1], f.lo[1]);
  return f;
}

// A tile's partial product, C fragment `frag` of a dense grad, into the
// warp's running sum: a lane's four floats side by side (fragment order),
// plain loads and stores (the buffer is the warp's own; its first tile
// writes it). `old` is the running sum, loaded ahead.
__device__ __forceinline__ float4* part_at(float* buf, int frag, int lane) {
  return reinterpret_cast<float4*>(buf) + frag * 32 + lane;
}

__device__ __forceinline__ void sum_frag(float* buf, int frag, int lane,
                                         const float c[4], float4 old) {
  *part_at(buf, frag, lane) =
      make_float4(c[0] + old.x, c[1] + old.y, c[2] + old.z, c[3] + old.w);
}

__device__ __forceinline__ float4 load_part(float* buf, int frag, int lane,
                                            bool first) {
  return first ? make_float4(0.f, 0.f, 0.f, 0.f) : *part_at(buf, frag, lane);
}

// ---- positions and table rows (fp32, the first design's roundings) -------

// One axis of one level: the cell (left row), the lerp weight and the slope
// scale (G−1)·inb, which is 0 outside the bound.
struct Axis {
  int xi;
  float w;
  float sl;
};

__device__ __forceinline__ Axis locate(int G, float x01, float inb) {
  Axis ax;
  const float xf = fminf(fmaxf(x01, 0.f), 1.f) * (float)(G - 1);
  ax.xi = min((int)floorf(xf), G - 2);
  ax.w = xf - (float)ax.xi;
  ax.sl = (float)(G - 1) * inb;
  return ax;
}

// A lane's two samples of the tile starting at t0 (the last sample past the
// end, never written): (x + b) · (1/2b) with the reciprocal rounded to fp32,
// as the plain version computes it (TPUGridField.density): every sample
// falls in the same grid cell. Within an ulp of a grid node a true division
// can land in the neighbouring cell, whose slope differs (∇σ jumps across
// nodes).
__device__ __forceinline__ void tile_rows(const Args& a, long long t0, int g,
                                          long long (&si)[2], bool (&act)[2],
                                          float (&x01)[2][3],
                                          float (&inb)[2][3]) {
  const float inv2b = 1.f / (2.f * a.bound);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    si[q] = t0 + 2 * g + q;
    act[q] = si[q] < a.n;
    const long long i = act[q] ? si[q] : a.n - 1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = a.xyz[i * 3 + k];
      x01[q][k] = __fmul_rn(x + a.bound, inv2b);
      inb[q][k] = (x01[q][k] >= 0.f && x01[q][k] <= 1.f) ? inv2b : 0.f;
    }
  }
}

// f (and g) of one sample at four ranks of a 16-rank group of level l:
// rows xi and xi + 1 of each axis' table, one 16-B load each.
template <bool NEED_G>
__device__ __forceinline__ void load_row(const Levels& lv, int l,
                                         const Axis (&ax)[3], int R, int off,
                                         float (&f)[3][4], float (&g)[3][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* lo = lv.tab[l][k] + ax[k].xi * R + off;
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(lo));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(lo + R));
    const float t0[4] = {a0.x, a0.y, a0.z, a0.w};
    const float t1[4] = {a1.x, a1.y, a1.z, a1.w};
    const float w = ax[k].w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[k][j] = t0[j] * (1.f - w) + t1[j] * w;
      g[k][j] = NEED_G ? ax[k].sl * (t1[j] - t0[j]) : 0.f;
    }
  }
}

// Both of a lane's samples (`load_row` each).
struct Quad {
  float f[2][3][4], g[2][3][4];
};

template <bool NEED_G>
__device__ __forceinline__ void load_quad(const Levels& lv, int l,
                                          const Axis (&ax)[2][3], int R,
                                          int off, Quad& qd) {
  load_row<NEED_G>(lv, l, ax[0], R, off, qd.f[0], qd.g[0]);
  load_row<NEED_G>(lv, l, ax[1], R, off, qd.f[1], qd.g[1]);
}

// The fold over one 16-rank group: per stream s, acc[s] += v[s] · fold for
// the group's k-tiles 2p, 2p + 1, each k-tile summed apart and added in
// fp32. v[s][q][j]: stream s of sample q at rank 16p + 4t + j; A column t
// of k-tile 2p + h is j = 2h, column t + 4 is j = 2h + 1 (the ρ order).
template <int NS, bool SPLIT>
__device__ __forceinline__ void fold_group(const float (&v)[NS][2][4],
                                           const float* sfold, int p,
                                           int lane, float (&acc)[NS][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    BFrag b[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      b[nt] = ldb<SPLIT>(sfold, 4, 2 * p + h, nt, lane);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const AFrag af = split_a(v[s][0][2 * h], v[s][1][2 * h],
                               v[s][0][2 * h + 1], v[s][1][2 * h + 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(c, af, b[nt]);
        add4(acc[s][nt], c);
      }
    }
  }
}

// The σ-net's first layer for one hidden n-tile from A fragments over the
// 32 features, each k-tile summed apart and added in fp32.
template <bool SPLIT>
__device__ __forceinline__ void layer1(const AFrag (&fa)[4], const float* w,
                                       int nt, int lane, float out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(c, fa[kt], ldb<SPLIT>(w, H / 8, kt, nt, lane));
    add4(out, c);
  }
}

template <bool TANGENTS>
__global__ void __launch_bounds__(BLOCK, 1) fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NS = TANGENTS ? 4 : 1;
  const Levels& lv = a.lv;
  const int r32 = lv.sum_r * F;
  float* sfold = smem;                 // ρ order, split
  float* ss1 = smem + 2 * r32;         // K in C order, split
  float* ss2 = ss1 + 2 * F * H;        // K in C order, split
  float* s2c = ss2 + 2 * H * NSG;      // s2[:, 0]
  stage<true>(a.fold, F, false, RHO, IDENT, lv.sum_r, F, sfold);
  stage<true>(a.s1, H, false, CORD, IDENT, F, H, ss1);
  stage<true>(a.s2, NSG, false, CORD, IDENT, H, NSG, ss2);
  for (int k = threadIdx.x; k < H; k += blockDim.x) s2c[k] = a.s2[k * NSG];
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  for (long long t0 = ((long long)blockIdx.x * warps + (threadIdx.x >> 5))
                      * TILE;
       t0 < a.n; t0 += (long long)gridDim.x * warps * TILE) {
    long long si[2];
    bool act[2];
    float x01[2][3], inb[2][3];
    tile_rows(a, t0, g, si, act, x01, inb);

    // ---- e and the tangent streams et_a: the fold of [P; TP0; TP1; TP2] --
    float acc[NS][4][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[s][nt][k] = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int G = lv.G[l], R = lv.R[l];
      Axis ax[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          ax[q][k] = locate(G, x01[q][k], inb[q][k]);
      for (int pl = 0; pl < (R >> 4); ++pl) {
        float v[NS][2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float f[3][4], gs[3][4];
          load_row<TANGENTS>(lv, l, ax[q], R, 16 * pl + 4 * t, f, gs);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[0][q][j] = f[0][j] * f[1][j] * f[2][j];
            if (TANGENTS) {
              v[1 % NS][q][j] = gs[0][j] * f[1][j] * f[2][j];
              v[2 % NS][q][j] = f[0][j] * gs[1][j] * f[2][j];
              v[3 % NS][q][j] = f[0][j] * f[1][j] * gs[2][j];
            }
          }
        }
        fold_group<NS, true>(v, sfold, lv.p0[l] + pl, lane, acc);
      }
    }

    // ---- σ-net: z1 = e·s1, σ and geo = relu(z1)·s2 ----------------------
    float z1[8][4];
    {
      AFrag fe[4];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) fe[kt] = a_from_c(acc[0][kt]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) layer1<true>(fe, ss1, nt, lane, z1[nt]);
    }
    // geo on the tensor cores; raw σ = h · s2[:, 0] on the CUDA cores: its
    // sums round to nearest, where every layer of tensor-core sums biased σ
    // toward zero (a signed mean error of −1.9e-7 of its scale)
    float sg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float sig[2] = {0.f, 0.f};
    uint32_t dm = 0;  // bit 4nt + k: z1 > 0 at C register k of n-tile nt
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int kt = 2 * kc + kk;
        float hr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (z1[kt][k] > 0.f) dm |= 1u << (4 * kt + k);
          hr[k] = fmaxf(z1[kt][k], 0.f);
        }
        const float m0 = s2c[8 * kt + 2 * t], m1 = s2c[8 * kt + 2 * t + 1];
        sig[0] = fmaf(m1, hr[1], fmaf(m0, hr[0], sig[0]));
        sig[1] = fmaf(m1, hr[3], fmaf(m0, hr[2], sig[1]));
        const AFrag ha = a_from_c(hr);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3(c[nt], ha, ldb<true>(ss2, 2, kt, nt, lane));
      }
      add4(sg[0], c[0]);
      add4(sg[1], c[1]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      sig[q] += __shfl_xor_sync(0xffffffffu, sig[q], 1);
      sig[q] += __shfl_xor_sync(0xffffffffu, sig[q], 2);
    }
    if (t == 0) {  // column 0 of rows g, g + 8
      sg[0][0] = sig[0];
      sg[0][2] = sig[1];
    }

    // ---- ∇σ_a = s2[:, 0] · ([z1 > 0] ⊙ et_a·s1) --------------------------
    float gr[3][2];
    if (TANGENTS) {
#pragma unroll
      for (int s = 1; s < 4; ++s) {
        AFrag ft[4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) ft[kt] = a_from_c(acc[s % NS][kt]);
        float r0 = 0.f, r1 = 0.f;
#pragma unroll 2
        for (int nt = 0; nt < 8; ++nt) {
          float zt[4];
          layer1<true>(ft, ss1, nt, lane, zt);
          const float m0 = s2c[8 * nt + 2 * t], m1 = s2c[8 * nt + 2 * t + 1];
          if ((dm >> (4 * nt)) & 1u) r0 = fmaf(m0, zt[0], r0);
          if ((dm >> (4 * nt + 1)) & 1u) r0 = fmaf(m1, zt[1], r0);
          if ((dm >> (4 * nt + 2)) & 1u) r1 = fmaf(m0, zt[2], r1);
          if ((dm >> (4 * nt + 3)) & 1u) r1 = fmaf(m1, zt[3], r1);
        }
        r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
        r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
        gr[s - 1][0] = r0;
        gr[s - 1][1] = r1;
      }
    }

    // ---- outputs: C columns 2t, 2t + 1 of σ-net n-tiles 0, 1 -------------
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!act[q]) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nt + 2 * t + e;
          const float val = sg[nt][2 * q + e];
          if (col == 0)
            a.sigma[si[q]] = val;
          else
            a.geo[si[q] * GEO + col - 1] = val;
        }
      if (TANGENTS && t == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) a.grad[si[q] * 3 + k] = gr[k][q];
      }
    }
  }
}

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 quad4(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// The table-grad rows of a lane's two consecutive samples at four ranks
// (c0 to row xi, c1 to row xi + 1 of each), summed where their rows meet:
// the same cell (2 reductions), neighbouring cells (3), else 4.
__device__ __forceinline__ void scatter_pair(float* tab, int R, int off,
                                             int xi0, int xi1, bool act1,
                                             float4 c00, float4 c01,
                                             float4 c10, float4 c11) {
  float* r0 = tab + (long long)xi0 * R + off;
  if (!act1) {
    red4(r0, c00);
    red4(r0 + R, c01);
    return;
  }
  const int d = xi1 - xi0;
  if (d == 0) {
    red4(r0, f4add(c00, c10));
    red4(r0 + R, f4add(c01, c11));
  } else if (d == 1) {
    red4(r0, c00);
    red4(r0 + R, f4add(c01, c10));
    red4(r0 + 2 * R, c11);
  } else if (d == -1) {
    red4(r0 - R, c10);
    red4(r0, f4add(c11, c00));
    red4(r0 + R, c01);
  } else {
    float* r1 = tab + (long long)xi1 * R + off;
    red4(r0, c00);
    red4(r0 + R, c01);
    red4(r1, c10);
    red4(r1 + R, c11);
  }
}

template <bool TANGENTS, bool NEED_DX>
__global__ void __launch_bounds__(BLOCK, 1) bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool NEED_G = TANGENTS || NEED_DX;
  constexpr int NS = TANGENTS ? 2 : 1;
  const Levels& lv = a.lv;
  const int r32 = lv.sum_r * F;
  float* sfold = smem;                 // B of the recompute, ρ order
  float* sfoldT = sfold + r32;         // B of pb, qv: K features, N σ order
  float* ss1 = sfoldT + r32;           // B of z1, zu
  float* ss1T = ss1 + F * H;           // B of ē, v
  float* ss2T = ss1T + F * H;          // B of s2 sḡ
  float* s2c = ss2T + H * NSG;         // s2[:, 0]
  float* scr = s2c + H + (threadIdx.x >> 5) * SCR;
  stage<false>(a.fold, F, false, RHO, IDENT, lv.sum_r, F, sfold);
  stage<false>(a.fold, F, true, IDENT, SIGMA, F, lv.sum_r, sfoldT);
  stage<false>(a.s1, H, false, IDENT, IDENT, F, H, ss1);
  stage<false>(a.s1, H, true, IDENT, IDENT, H, F, ss1T);
  stage<false>(a.s2, NSG, true, IDENT, IDENT, NSG, H, ss2T);
  for (int k = threadIdx.x; k < H; k += blockDim.x) s2c[k] = a.s2[k * NSG];
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  // this warp's running dense sums: d_fold's (ΣR/16) × 4 fragments, then
  // d_s1's 2 × 8, then d_s2's 4 × 2
  const int per_warp = r32 + F * H + H * NSG;
  float* wp = a.part
              + ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * per_warp;
  float* wp_s1 = wp + r32;
  float* wp_s2 = wp_s1 + F * H;
  bool first = true;
  for (long long t0 = ((long long)blockIdx.x * warps + (threadIdx.x >> 5))
                      * TILE;
       t0 < a.n; t0 += (long long)gridDim.x * warps * TILE) {
    long long si[2];
    bool act[2];
    float x01[2][3], inb[2][3];
    tile_rows(a, t0, g, si, act, x01, inb);
    // the cotangents: sḡ rows into the scratch (0 past the end), n̄
    float nb[2][3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * t + e;
        c[e] = !act[q] ? 0.f
               : col == 0 ? a.dsig[si[q]] : a.dgeo[si[q] * GEO + col - 1];
      }
      *reinterpret_cast<float4*>(scr + SG + (2 * g + q) * LD16 + 4 * t) =
          make_float4(c[0], c[1], c[2], c[3]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        nb[q][k] = (TANGENTS && act[q]) ? a.dgrad[si[q] * 3 + k] : 0.f;
    }

    // ---- recompute: e and u = the fold of [P; TPN] -----------------------
    {
      float acc[NS][4][4];
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[s][nt][k] = 0.f;
      for (int l = 0; l < lv.n; ++l) {
        const int G = lv.G[l], R = lv.R[l];
        Axis ax[2][3];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            ax[q][k] = locate(G, x01[q][k], inb[q][k]);
        for (int pl = 0; pl < (R >> 4); ++pl) {
          Quad qd;
          load_quad<TANGENTS>(lv, l, ax, R, 16 * pl + 4 * t, qd);
          float v[NS][2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float f0 = qd.f[q][0][j], f1 = qd.f[q][1][j],
                          f2 = qd.f[q][2][j];
              v[0][q][j] = f0 * f1 * f2;
              if (TANGENTS)
                v[NS - 1][q][j] = nb[q][0] * qd.g[q][0][j] * f1 * f2
                                  + nb[q][1] * f0 * qd.g[q][1][j] * f2
                                  + nb[q][2] * f0 * f1 * qd.g[q][2][j];
            }
          fold_group<NS, false>(v, sfold, lv.p0[l] + pl, lane, acc);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        put_c(scr + SE, LD32, 8 * nt + 2 * t, acc[0][nt], g);
        if (TANGENTS) put_c(scr + SU, LD32, 8 * nt + 2 * t, acc[NS - 1][nt], g);
      }
    }
    __syncwarp();

    // ---- z1 = e·s1, zu = u·s1: h = relu(z1), tn = [z1 > 0] zu -------------
    uint32_t dm = 0;  // bit 4nt + k: z1 > 0 at C register k of n-tile nt
    {
      AFrag ea[4], ua[4];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        ea[kt] = get_a(scr + SE, LD32, kt, g, t);
        if (TANGENTS) ua[kt] = get_a(scr + SU, LD32, kt, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float z[4], hv[4];
        layer1<false>(ea, ss1, nt, lane, z);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (z[k] > 0.f) dm |= 1u << (4 * nt + k);
          hv[k] = z[k] > 0.f ? z[k] : 0.f;
        }
        put_c(scr + SZ, LD64, 8 * nt + 2 * t, hv, g);
        if (TANGENTS) {
          float zu[4];
          layer1<false>(ua, ss1, nt, lane, zu);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            zu[k] = (dm >> (4 * nt + k)) & 1u ? zu[k] : 0.f;
          put_c(scr + SM, LD64, 8 * nt + 2 * t, zu, g);
        }
      }
    }
    __syncwarp();

    // ---- d_s2 += hᵀ sḡ, and Σ tn into its column 0 -----------------------
    {
      BFrag sb[2][2];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          sb[kt][nt] = get_b(scr + SG, LD16, kt, 8 * nt, g, t);
      BFrag e0;  // every sample's (1, 0, …, 0)
      e0.hi[0] = e0.hi[1] = __float_as_uint(g == 0 ? 1.f : 0.f);
      e0.lo[0] = e0.lo[1] = 0u;
      float4 old[H / 16][2];
#pragma unroll
      for (int mt = 0; mt < H / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          old[mt][nt] = load_part(wp_s2, 2 * mt + nt, lane, first);
#pragma unroll
      for (int mt = 0; mt < H / 16; ++mt) {
        AFrag ha[2], ta[2];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          ha[kt] = get_at(scr + SZ, LD64, 16 * mt, kt, g, t);
          if (TANGENTS) ta[kt] = get_at(scr + SM, LD64, 16 * mt, kt, g, t);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            mma3(c, ha[kt], sb[kt][nt]);
            if (TANGENTS && nt == 0) mma3(c, ta[kt], e0);
          }
          sum_frag(wp_s2, 2 * mt + nt, lane, c, old[mt][nt]);
        }
      }
    }
    __syncwarp();

    // ---- z̄1 = [z1 > 0] ⊙ s2 sḡ, m = [z1 > 0] ⊙ s2[:, 0] --------------------
    {
      AFrag sa[2];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) sa[kt] = get_a(scr + SG, LD16, kt, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float hb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
          mma3(hb, sa[kt], ldb<false>(ss2T, H / 8, kt, nt, lane));
        const float m0 = s2c[8 * nt + 2 * t], m1 = s2c[8 * nt + 2 * t + 1];
        float mv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool pos = (dm >> (4 * nt + k)) & 1u;
          hb[k] = pos ? hb[k] : 0.f;
          mv[k] = pos ? ((k & 1) ? m1 : m0) : 0.f;
        }
        put_c(scr + SZ, LD64, 8 * nt + 2 * t, hb, g);
        if (TANGENTS) put_c(scr + SM, LD64, 8 * nt + 2 * t, mv, g);
      }
    }
    __syncwarp();

    // ---- d_s1 += eᵀ z̄1 + uᵀ m --------------------------------------------
    {
      AFrag ea[2][2], ua[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          ea[mt][kt] = get_at(scr + SE, LD32, 16 * mt, kt, g, t);
          if (TANGENTS) ua[mt][kt] = get_at(scr + SU, LD32, 16 * mt, kt, g, t);
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 old[2] = {load_part(wp_s1, nt, lane, first),
                               load_part(wp_s1, 8 + nt, lane, first)};
        BFrag zb[2], mb[2];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          zb[kt] = get_b(scr + SZ, LD64, kt, 8 * nt, g, t);
          if (TANGENTS) mb[kt] = get_b(scr + SM, LD64, kt, 8 * nt, g, t);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            mma3(c, ea[mt][kt], zb[kt]);
            if (TANGENTS) mma3(c, ua[mt][kt], mb[kt]);
          }
          sum_frag(wp_s1, 8 * mt + nt, lane, c, old[mt]);
        }
      }
    }

    // ---- ē = s1 z̄1, v = s1 m (the hidden units as K, chunks of two) ------
    {
      float eb[4][4], vv[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) eb[nt][k] = vv[nt][k] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        AFrag za[2], ma[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          za[kk] = get_a(scr + SZ, LD64, 2 * kc + kk, g, t);
          if (TANGENTS) ma[kk] = get_a(scr + SM, LD64, 2 * kc + kk, g, t);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const BFrag b = ldb<false>(ss1T, F / 8, 2 * kc + kk, nt, lane);
            mma3(c, za[kk], b);
            if (TANGENTS) mma3(d, ma[kk], b);
          }
          add4(eb[nt], c);
          if (TANGENTS) add4(vv[nt], d);
        }
      }
      __syncwarp();  // every lane has read e and u
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        put_c(scr + SE, LD32, 8 * nt + 2 * t, eb[nt], g);
        if (TANGENTS) put_c(scr + SU, LD32, 8 * nt + 2 * t, vv[nt], g);
      }
    }
    __syncwarp();

    // ---- per 16-rank group: pb, qv, the product rule, table grads, d_x,
    //      d_fold += pᵀ ē + tpnᵀ v ---------------------------------------
    float dxa[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float* sp = scr + SZ;   // the group's p rows (16 × LD16)
    float* stp = scr + SM;  // the group's tpn rows
    for (int l = 0; l < lv.n; ++l) {
      const int G = lv.G[l], R = lv.R[l];
      Axis ax[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          ax[q][k] = locate(G, x01[q][k], inb[q][k]);
      for (int pl = 0; pl < (R >> 4); ++pl) {
        const int p = lv.p0[l] + pl;
        float4 old[4];  // d_fold's running sums of group p, loaded ahead
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          old[nt] = load_part(wp, 4 * p + nt, lane, first);
        Quad qd;
        load_quad<NEED_G>(lv, l, ax, R, 16 * pl + 4 * t, qd);
        // pb and qv at this lane's (sample, rank) pairs: C fragments of
        // n-tiles 2p, 2p + 1 (columns in the σ order)
        float pb[2][4], qv[2][4];
        AFrag ea[4], va[4];
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          ea[kt] = get_a(scr + SE, LD32, kt, g, t);
          if (TANGENTS) va[kt] = get_a(scr + SU, LD32, kt, g, t);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 4; ++kt) {
            const BFrag b = ldb<false>(sfoldT, lv.sum_r / 8, kt, 2 * p + h,
                                       lane);
            mma3(kt < 2 ? c0 : c1, ea[kt], b);
            if (TANGENTS) mma3(kt < 2 ? d0 : d1, va[kt], b);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            pb[h][k] = c0[k] + c1[k];
            qv[h][k] = d0[k] + d1[k];
          }
        }
        float pv[2][4], tpv[2][4];
        float c0v[2][3][4], c1v[2][3][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float f0 = qd.f[q][0][j], f1 = qd.f[q][1][j],
                        f2 = qd.f[q][2][j];
            const float g0 = qd.g[q][0][j], g1 = qd.g[q][1][j],
                        g2 = qd.g[q][2][j];
            const float pbv = pb[j >> 1][2 * q + (j & 1)];
            float fb[3] = {pbv * f1 * f2, pbv * f0 * f2, pbv * f0 * f1};
            float gb[3] = {0.f, 0.f, 0.f};
            if (TANGENTS) {
              const float qvv = qv[j >> 1][2 * q + (j & 1)];
              const float qb[3] = {qvv * nb[q][0], qvv * nb[q][1],
                                   qvv * nb[q][2]};
              fb[0] += qb[1] * g1 * f2 + qb[2] * f1 * g2;
              fb[1] += qb[0] * g0 * f2 + qb[2] * f0 * g2;
              fb[2] += qb[0] * g0 * f1 + qb[1] * f0 * g1;
              gb[0] = qb[0] * f1 * f2;
              gb[1] = qb[1] * f0 * f2;
              gb[2] = qb[2] * f0 * f1;
              tpv[q][j] = nb[q][0] * g0 * f1 * f2 + nb[q][1] * f0 * g1 * f2
                          + nb[q][2] * f0 * f1 * g2;
            }
            pv[q][j] = f0 * f1 * f2;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float w = ax[q][k].w;
              float u0 = fb[k] * (1.f - w), u1 = fb[k] * w;
              if (TANGENTS) {
                u0 -= gb[k] * ax[q][k].sl;
                u1 += gb[k] * ax[q][k].sl;
              }
              c0v[q][k][j] = u0;
              c1v[q][k][j] = u1;
              if (NEED_DX) dxa[q][k] = fmaf(fb[k], qd.g[q][k][j], dxa[q][k]);
            }
          }
        if (act[0]) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            scatter_pair(a.gt.tab[l][k], R, 16 * pl + 4 * t, ax[0][k].xi,
                         ax[1][k].xi, act[1], quad4(c0v[0][k]),
                         quad4(c1v[0][k]), quad4(c0v[1][k]),
                         quad4(c1v[1][k]));
        }
        // d_fold rows 16p … 16p + 15: the group's p (and tpn) as Aᵀ with
        // the samples as K, ē (and v) as B
        __syncwarp();  // the previous group's reads are done
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          *reinterpret_cast<float4*>(sp + (2 * g + q) * LD16 + 4 * t) =
              make_float4(pv[q][0], pv[q][1], pv[q][2], pv[q][3]);
          if (TANGENTS)
            *reinterpret_cast<float4*>(stp + (2 * g + q) * LD16 + 4 * t) =
                make_float4(tpv[q][0], tpv[q][1], tpv[q][2], tpv[q][3]);
        }
        __syncwarp();
        AFrag pa[2], ta[2];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          pa[kt] = get_at(sp, LD16, 0, kt, g, t);
          if (TANGENTS) ta[kt] = get_at(stp, LD16, 0, kt, g, t);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < 2; ++kt) {
            mma3(c, pa[kt], get_b(scr + SE, LD32, kt, 8 * nt, g, t));
            if (TANGENTS)
              mma3(c, ta[kt], get_b(scr + SU, LD32, kt, 8 * nt, g, t));
          }
          sum_frag(wp, 4 * p + nt, lane, c, old[nt]);
        }
      }
    }
    if (NEED_DX) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = dxa[q][k];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && act[q]) a.dx[si[q] * 3 + k] = v;
        }
    }
    first = false;
    __syncwarp();  // the scratch is the next tile's
  }

  // the block's dense sums: its warps' running sums added in warp order,
  // then one atomicAdd an entry a block
  __syncthreads();
  const long long w0 = (long long)blockIdx.x * warps;
  int took = 0;  // the block's warps that took a tile
  for (int w = 0; w < warps; ++w)
    if ((w0 + w) * TILE < a.n) took = w + 1;
  for (int k = threadIdx.x; k < per_warp; k += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < took; ++w) v += a.part[(w0 + w) * per_warp + k];
    // fragment f, lane (gg, tt), register e: row gg + 8(e / 2), column
    // 2tt + e % 2 of the fragment's 16 × 8 tile
    const int f = k >> 7, ln = (k >> 2) & 31, e = k & 3;
    const int row = (ln >> 2) + 8 * (e >> 1), col = 2 * (ln & 3) + (e & 1);
    if (k < r32)
      atomicAdd(a.d_fold + (16 * (f >> 2) + row) * F + 8 * (f & 3) + col, v);
    else if (k < r32 + F * H) {
      const int f1 = f - r32 / 128;
      atomicAdd(a.d_s1 + (16 * (f1 >> 3) + row) * H + 8 * (f1 & 7) + col, v);
    } else {
      const int f2 = f - (r32 + F * H) / 128;
      atomicAdd(a.d_s2 + (16 * (f2 >> 1) + row) * NSG + 8 * (f2 & 1) + col,
                v);
    }
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
    if (level_r[l] % 16) return -8;
    lv->G[l] = level_g[l];
    lv->R[l] = level_r[l];
    lv->p0[l] = sum_r / 16;
    for (int a = 0; a < 3; ++a) lv->tab[l][a] = tables[l * 3 + a];
    sum_r += level_r[l];
  }
  lv->sum_r = sum_r;
  return sum_r;
}

size_t fwd_smem(int sum_r) {
  return (size_t)(2 * sum_r * F + 2 * F * H + 2 * H * NSG + H) * sizeof(float);
}

size_t bwd_smem(int sum_r, int warps) {
  return (size_t)(2 * sum_r * F + 2 * F * H + H * NSG + H + warps * SCR)
         * sizeof(float);
}

// Per instance and card: the largest dynamic shared memory the kernel's
// attribute was raised to there, and the grid for the block and size last
// asked for. The entry drops Python's lock, so callers on two cards may
// launch at once: one mutex an instance guards its cards' slots.
struct Launch {
  size_t attr = 0;
  size_t smem = 0;
  int block = 0;
  int grid = 0;  // blocks resident on the card at once
};
constexpr int MAX_DEVICES = 64;

template <void (*KERN)(const Args)>
int launch(const Args& a, int block, size_t smem, int device,
           cudaStream_t stream, long long max_blocks = 1LL << 30) {
  static Launch cached[MAX_DEVICES];
  static std::mutex mu;
  if (device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  int resident;
  {
    std::lock_guard<std::mutex> lock(mu);
    Launch& c = cached[device];
    if (c.smem != smem || c.block != block) {
      // raised only: a launch of a smaller size in flight stays valid
      cudaError_t e = cudaSuccess;
      if (smem > c.attr)
        e = cudaFuncSetAttribute(
            KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      int per_sm = 0, sms = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERN,
                                                          block, smem);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      if (smem > c.attr) c.attr = smem;
      c.smem = smem;
      c.block = block;
      c.grid = per_sm * sms;
    }
    resident = c.grid;
  }
  const long long per_block = (long long)(block / 32) * TILE;
  const long long want = (a.n + per_block - 1) / per_block;
  long long grid = want < resident ? want : resident;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  KERN<<<(int)grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
//   -8 a level's rank not a multiple of 16 (the wrapper pads it)
// Device pointers except `tables` (a host array of n_levels × 3 device
// pointers, axis-minor, each table 16-B aligned), level_g and level_r (host
// arrays). `grad` is written only when `tangents` is set. Each entry takes
// the card's index (int) and a stream of that card last; the guard makes
// the card current for the launch (csrc/launch.cuh).
int mnerf_cp_train_fwd(const float* xyz, const float* fold, const float* s1,
                       const float* s2, const float* const* tables,
                       const int* level_g, const int* level_r, int n_levels,
                       int n, float bound, int tangents, float* sigma,
                       float* geo, float* grad, int device, void* stream) {
  Args a{xyz, fold, s1, s2};
  const int sum_r = make_levels(tables, level_g, level_r, n_levels, &a.lv);
  if (sum_r < 0) return sum_r;
  const size_t smem = fwd_smem(sum_r);
  if (smem > (size_t)SMEM_LIMIT) return -5;
  if (n < 1) return -6;
  a.n = n;
  a.bound = bound;
  a.sigma = sigma;
  a.geo = geo;
  a.grad = grad;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  return tangents ? launch<fwd_kernel<true>>(a, BLOCK, smem, device, s)
                  : launch<fwd_kernel<false>>(a, BLOCK, smem, device, s);
}

// Backward: accumulates into d_tables (host array of device pointers, same
// order as `tables`, each 16-B aligned), d_fold, d_s1 and d_s2, which the
// caller zeroes; writes dx (n, 3) when need_dx is set. dgrad is read only
// when `tangents` is set. `part` is scratch of part_floats floats for the
// warps' running dense sums, ΣR·32 + 3072 a warp: the grid takes at most as
// many blocks as it holds (ops/fused_cp_train.py sizes it for 8 warps an
// SM). Return codes as for the forward. The block has 8 warps, or 4, 2, 1
// when their scratch does not fit beside the nets.
int mnerf_cp_train_bwd(const float* xyz, const float* fold, const float* s1,
                       const float* s2, const float* const* tables,
                       const int* level_g, const int* level_r, int n_levels,
                       int n, float bound, int tangents, int need_dx,
                       const float* dsig, const float* dgeo,
                       const float* dgrad, float* dx,
                       float* const* d_tables, float* d_fold, float* d_s1,
                       float* d_s2, float* part, long long part_floats,
                       int device, void* stream) {
  Args a{xyz, fold, s1, s2};
  const int sum_r = make_levels(tables, level_g, level_r, n_levels, &a.lv);
  if (sum_r < 0) return sum_r;
  int warps = WARPS;
  while (warps > 1 && bwd_smem(sum_r, warps) > (size_t)SMEM_LIMIT) warps /= 2;
  const size_t smem = bwd_smem(sum_r, warps);
  if (smem > (size_t)SMEM_LIMIT) return -5;
  if (n < 1) return -6;
  a.n = n;
  a.bound = bound;
  a.dsig = dsig;
  a.dgeo = dgeo;
  a.dgrad = dgrad;
  a.dx = dx;
  for (int l = 0; l < n_levels; ++l)
    for (int k = 0; k < 3; ++k) a.gt.tab[l][k] = d_tables[l * 3 + k];
  a.d_fold = d_fold;
  a.d_s1 = d_s1;
  a.d_s2 = d_s2;
  a.part = part;
  const long long max_blocks =
      part_floats / ((long long)warps * (sum_r * F + F * H + H * NSG));
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const int block = warps * 32;
  if (tangents)
    return need_dx ? launch<bwd_kernel<true, true>>(a, block, smem, device, s,
                                                    max_blocks)
                   : launch<bwd_kernel<true, false>>(a, block, smem, device,
                                                     s, max_blocks);
  return need_dx ? launch<bwd_kernel<false, true>>(a, block, smem, device, s,
                                                   max_blocks)
                 : launch<bwd_kernel<false, false>>(a, block, smem, device, s,
                                                    max_blocks);
}

}  // extern "C"
