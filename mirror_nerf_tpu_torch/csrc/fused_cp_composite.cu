// Fused CP-grid field + per-ray alpha compositing, one kernel (sm_90a), in
// three modes (the MODE template argument):
//
//   COMPOSITE replaces the Pallas TPU kernel `_kernel_composite_rays`
//     (mirror_nerf_tpu/ops/pallas/fused_cp.py:363, driven by
//     fused_cp_forward_composite_rays:427 and the adapter
//     fused_cp_rays_composite:554): per-ray o, d, view dir and depths z in.
//   ROWS replaces `_kernel` (fused_cp.py:314; fused_cp_forward:481 → :494,
//     adapter fused_cp_rays_eval:657): the same per-ray inputs, and per
//     sample 8 floats out [raw σ, rgb (3), unit normal (3), mirror] (raw σ
//     alone when σ-only), no compositing: the σ-noise passes add the noise
//     to raw σ and composite outside.
//   SAMPLES replaces `_kernel_composite` (fused_cp.py:335;
//     fused_cp_forward_composite:507 → :538 σ-only, :543; reached from
//     fused_cp_rays_composite:612-623): the composite from per-sample
//     inputs, world position x, view dir, z and δ (δ_inf = 1e10 given by
//     the caller), in place of per-ray o, d and z.
// It computes the same functions, not the same layout: the TPU kernels'
// hat-basis table matmuls, one-hot ray expand, lane-roll scan and hi/lo
// bf16 split answered TPU limits and are gone.
//
// Per ray (o, d, view dir) and its S sorted depths z:
//   x01 = (o + d·z + bound) / 2·bound
//   CP encode: per level (G, R) and axis, lerp two rows of the (G, R) table
//     (clamp to [0,1], xi = min(floor, G-2)), multiply the three axes
//     rank-wise, fold the ΣR rank products into 32 features
//   σ-net 32→64 relu →16 (raw σ + 15 geo); SH4 of the normalized view dir;
//   color [sh16; geo15] →64 relu →64 relu →3 sigmoid; normal geo →64 relu
//   →3, L2-normalized; mirror geo →32 (+b) leaky 0.01 →1 (+b) sigmoid
//   δ_i = z_{i+1} − z_i, 1e10 on the ray's last sample; sd = δ·act(σ)
//   w_i = exp(−Σ_{j<i} sd_j)·(1 − exp(−sd_i)), the prefix an EXCLUSIVE scan
//     (never inclusive-minus-self: that cancels against δ_inf = 1e10)
//   per ray: Σw, Σw·rgb, Σw·n, Σw·mirror, Σw·z; the σ-only variant stops at w.
// (SAMPLES reads x and δ where the list computes them from o + d·z; ROWS
// stops after the mirror and writes the sample's row.)
//
// What bounds it on the H100: arithmetic. A sample costs ~17k multiply-adds
// (6k in the CP fold at the default 3×64 ranks, 11k in the nets) against
// 1152 4-byte table reads that mostly hit L1/L2 (neighbouring samples of a
// ray read neighbouring rows), and 4 B in + 4 B out of device memory. The
// first version ran every multiply-add on the fp32 CUDA cores with its
// weight operand a scalar shared-memory load and read the tables with six
// scalar loads a rank: one load per FMA held it at 15 % of the fp32 peak
// (7.52 ms at S = 128 full, 16384 rays, H100 80GB HBM3 at 700 W). This
// design moves the products onto the tensor cores:
//   * a warp walks eight neighbouring rays together, four samples of each
//     a chunk: two m16 row tiles of `mma.sync.m16n8k8` TF32, row 8q + g
//     sample q of ray g. A lane's four rows are all of its own ray, and the
//     eight rows one table load serves are the same sample of eight
//     neighbouring rays (a ray's own consecutive samples read different
//     rows at the fine levels);
//     each ray's running transmittance is a register, so no block barrier
//     and no cross-warp scan remain;
//   * every product (the fold, K = ΣR, N = 32; σ-net 32→64→16; color
//     32→64→64→8; normal 16→64→8; mirror 16→32→8) runs as 3×TF32 with fp32
//     accumulators, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each hi and lo a
//     `cvt.rna.tf32.f32` (lo of x − hi): fp32-level accuracy. Single-pass
//     TF32 misses the 1e-4 bar (tools/exp_cp_diag.py `one_tf32` holds it
//     against the plain version). Positions (o + d·z, x01, the lerp weights)
//     stay fp32 on the CUDA cores with the first version's roundings;
//   * a layer's C fragments are the next layer's A fragments in registers:
//     a lane holds C columns 2t, 2t+1 of each n-tile, which it feeds as A
//     columns t, t+4, so the wrapper (ops/fused_cp.py `_pack_nets`) stores
//     each such weight matrix with its K rows in that order; hidden layers
//     are streamed n-tile by n-tile into the next layer's accumulators;
//   * the CP encode writes the fold's A fragments directly: A columns t,
//     t+4 of k-tiles 2p, 2p+1 are ranks 16p + 4t … 16p + 4t + 3 (the fold's
//     rows stored in that order, each level's ranks padded to a multiple of
//     16 with zero tables and zero rows), so a lane reads a table row's four
//     adjacent ranks as one 16-B load: 72 vector loads a sample in place of
//     1152 scalar ones. The tables (0.64 MB by default) stay in L2;
//   * weights live in shared memory in fragment order, split into hi/lo
//     once as each block stages them: one 16-B load a lane per B fragment
//     and no instruction to split it (splitting at every load costs 20 %
//     more time); 146 KB for the full variant (one 8-warp block an SM),
//     74 KB σ-only (two);
//   * the grid is persistent (every block stages the weights once and walks
//     rays by a stride); bias, ReLU, leaky ReLU, sigmoid, softplus, SH4 and
//     the normal's L2 norm run in fp32 on the fragment registers.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6, rows 1, 7,
// 8): 1.63–1.81 ms for S = 128 full on 16384 rays (7.12 ms before, in the
// same process), 0.51 ms σ-only at S = 64 (3.77): 24–27 % of its bound
// with 3×TF32 products on the tensor cores (0.436 ms: 3 × the products'
// operations at 495 TFLOP/s, the lerps on the CUDA cores beside them);
// 63–70 % of the first design's fp32 CUDA-core bound (1.140 ms).
// What bounds it now (tools/exp_cp_diag.py): the tensor pipe of
// `mma.sync` and the table loads, in turn: with one TF32 product in place
// of three the full variant takes 39 % less time, without the table loads
// 26 % less, without both 61 %. `wgmma` (a warpgroup's 64-row tiles, B from
// shared memory) is the next step; the table rows' L2 traffic after it.
//
// The same body, with the hash grid's encoder in place of the CP fold, is
// the fused NGP composite (`hash_field_kernel`, the C entry
// mnerf_fused_hash_composite; ops/fused_hash.py): `NGPField`'s field (16
// levels × 2 features, the nets above) and the COMPOSITE mode's
// compositing, for the hash-grid model's noise-free passes. It replaces
// ENCODE (csrc/hashgrid.cu, the port's kernel for the XLA gathers of
// mirror_nerf_tpu/ops/hashgrid.py:139) followed by the PyTorch nets and
// compositing, which the JAX package leaves to XLA. ENCODE's device
// functions (csrc/hashgrid.cuh) write the σ-net's A fragments directly, so
// the (N·S, 32) encoding never goes to memory, and x01 is the plain
// version's (o + d·z + b)·fp32(1/2b), rounded as it rounds.
// What bounds it on the H100: the 3×TF32 products, 11k multiply-adds a
// sample full (0.28 ms for 2,097,152 samples at 495 TFLOP/s), beside 128
// corner loads a sample (16 levels × 8 corners of 8 B; ~80 distinct 32-B
// L2 sectors, the x-neighbours sharing theirs) from a 52.9 MB table that
// does not fit the 50 MB L2. Its nets take 96 KB of shared memory full,
// 25 KB σ-only (no fold). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md §6, row 9): 1.64 ms for S = 128 full on 16384 rays (ENCODE
// alone took 1.06 ms, before the nets), 0.54–0.57 σ-only at S = 64;
// without the corner loads 51 % / 68 % less time, with one TF32 product in
// place of three 32 % / 0 % less (tools/exp_hash_diag.py): the gathers
// hold both variants, the tensor pipe the full one beside them.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hashgrid.cuh"
#include "launch.cuh"
#include "tf32.cuh"

namespace {

constexpr int F = 32;            // CP fold output features
constexpr int H = 64;            // σ / color / normal hidden width
constexpr int NSG = 16;          // σ-net output: raw σ + 15 geo
constexpr int HM = 32;           // mirror hidden width
constexpr int MAX_LEVELS = 8;
constexpr int MAX_HASH_LEVELS = 16;  // 2 features a level fill K = 32
constexpr int MAX_S = 256;
constexpr int RAYS = 8;          // rays a warp walks together
constexpr int JB = 4;            // hidden n-tiles computed together
constexpr int NOUT = 9;          // opacity, rgb(3), normal(3), mirror, depth
constexpr int NROW = 8;          // ROWS: σ, rgb(3), normal(3), mirror
constexpr int SMEM_LIMIT = 232448;

enum Mode { COMPOSITE = 0, ROWS = 1, SAMPLES = 2 };
// the encoder in front of the σ-net: the CP fold (`cp_field_kernel`) or the
// hash grid's levels (`hash_field_kernel`, COMPOSITE only)
enum Enc { CP_GRID = 0, HASH_GRID = 1 };

// The nets' float offsets, in the packed buffer after the fold (ΣR × 32)
// and in shared memory before it. Each matrix is (K, N) with K and N padded
// to multiples of 8 (the wrapper zero-fills); shared memory holds it in
// fragment order. ops/fused_cp.py `NET_LAYOUT` lists the same.
constexpr int S1 = 0;                  // 32 × 64
constexpr int S2 = S1 + F * H;         // 64 × 16
constexpr int SIGMA_NETS = S2 + H * NSG;
constexpr int C1 = SIGMA_NETS;         // [sh 16; σ 1 (zero row); geo 15] × 64
constexpr int C2 = C1 + 32 * H;        // 64 × 64
constexpr int C3 = C2 + H * H;         // 64 × 8 (3 used)
constexpr int N1 = C3 + H * 8;         // [σ 1 (zero row); geo 15] × 64
constexpr int N2 = N1 + 16 * H;        // 64 × 8 (3 used)
constexpr int M1 = N2 + H * 8;         // [σ; geo] 16 × 32
constexpr int M2 = M1 + 16 * HM;       // 32 × 8 (1 used)
constexpr int M1B = M2 + HM * 8;       // 32
constexpr int M2B = M1B + HM;          // 1
constexpr int NETS = M2B + 1;          // floats after the fold
// Shared memory: each matrix split into TF32 hi and lo once, in fragment
// order, a lane's (hi, hi, lo, lo) side by side: twice its packed floats at
// twice its packed offset; then the biases, then the fold (split too).
constexpr int SM_BIAS = 2 * M1B;       // m1 b (32), m2 b (1)
constexpr int SM_SIGMA = 2 * SIGMA_NETS;  // the σ-only variant's fold
constexpr int SM_FULL = SM_BIAS + 36;     // the full variant's, 16-B aligned

// 8-warp blocks; an SM holds two σ-only blocks (≤ 128 registers, 74 KB of
// weights each) or one full block (≤ 255 registers; 146 KB). At 128
// registers the full variant spills and takes 27 % longer, in 4-warp blocks
// 42 % (tools/exp_cp_diag.py).
constexpr int WARPS = 8;
constexpr int BLOCK = WARPS * 32;

struct Levels {
  int n;
  int sum_r;                 // Σ R (each R a multiple of 16)
  int G[MAX_LEVELS];
  int R[MAX_LEVELS];         // the packed table's row stride
  int kt0[MAX_LEVELS];       // the level's first k-tile of the fold
  int off[MAX_LEVELS][3];    // float offset of the (level, axis) table
};

struct Args {
  const float *pos, *rays_d, *vdir, *z_vals, *deltas, *tables, *nets;
  Levels lv;                  // CP_GRID
  const Level* hash_levels;   // HASH_GRID: the (rows, 2) table's levels
  int n_hash_levels;
  float inv_2b;               // HASH_GRID: fp32(1 / 2·bound)
  int n_rays, n_samples;
  float bound;
  float *weights, *per_ray, *rows;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// B fragment (kt, nt) of a (K, N) matrix staged at float offset `base` of
// shared memory: one 16-B load a lane, split at staging.
__device__ __forceinline__ BFrag load_b(const float* smem, int base, int nt_n,
                                        int kt, int nt, int lane) {
  const float4 b = reinterpret_cast<const float4*>(smem + base)
      [(kt * nt_n + nt) * 32 + lane];
  BFrag f;
  f.hi[0] = __float_as_uint(b.x);
  f.hi[1] = __float_as_uint(b.y);
  f.lo[0] = __float_as_uint(b.z);
  f.lo[1] = __float_as_uint(b.w);
  return f;
}

// A (K, N) matrix of the packed buffer into shared memory in fragment
// order, split: tile (kt, nt), lane (g, t) holds rows 8kt + t and
// 8kt + t + 4 of column 8nt + g, as (hi, hi, lo, lo).
__device__ __forceinline__ void stage(const float* __restrict__ w, int k,
                                      int n, float* dst) {
  const int nt_n = n >> 3;
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int idx = threadIdx.x; idx < (k >> 3) * nt_n * 32; idx += BLOCK) {
    const int lane = idx & 31, tile = idx >> 5;
    const int kt = tile / nt_n, nt = tile - kt * nt_n;
    const float* col = w + (8 * kt + (lane & 3)) * n + 8 * nt + (lane >> 2);
    uint32_t h0, l0, h1, l1;
    tf32_split(col[0], h0, l0);
    tf32_split(col[4 * n], h1, l1);
    d4[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(l0), __uint_as_float(l1));
  }
}

// SH degree 4 of a unit direction: the four values a lane feeds as A
// columns (SH index 4t + j; the wrapper orders c1's SH rows so).
__device__ __forceinline__ void sh_quad(float dx, float dy, float dz, int t,
                                        float out[4]) {
  const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
  dx *= inv; dy *= inv; dz *= inv;
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
  const float s[16] = {
      0.28209479177387814f,
      -0.4886025119029199f * dy,
      0.4886025119029199f * dz,
      -0.4886025119029199f * dx,
      1.0925484305920792f * xy,
      -1.0925484305920792f * yz,
      0.31539156525252005f * (2.f * zz - xx - yy),
      -1.0925484305920792f * xz,
      0.5462742152960396f * (xx - yy),
      -0.5900435899266435f * dy * (3.f * xx - yy),
      2.890611442640554f * xy * dz,
      -0.4570457994644658f * dy * (4.f * zz - xx - yy),
      0.3731763325901154f * dz * (2.f * zz - 3.f * xx - 3.f * yy),
      -0.4570457994644658f * dx * (4.f * zz - xx - yy),
      1.445305721320277f * dz * (xx - yy),
      -0.5900435899266435f * dx * (xx - 3.f * yy)};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = t == 0 ? s[j] : t == 1 ? s[4 + j] : t == 2 ? s[8 + j]
                                                        : s[12 + j];
}

// Σ over the JB chains of a narrow output layer's accumulators.
__device__ __forceinline__ float sum_parts(const float part[JB][2][4], int m,
                                           int k) {
  float v = part[0][m][k];
#pragma unroll
  for (int jj = 1; jj < JB; ++jj) v += part[jj][m][k];
  return v;
}

// The CP encode straight into the fold's A fragments (A columns t, t+4 of
// k-tiles 2p, 2p+1 are ranks 16p + 4t … 16p + 4t + 3: one 16-B table load),
// then the fold's C fragments as the σ-net's A fragments. x: this lane's
// four rows' x01.
__device__ __forceinline__ void cp_encode(const Args& a, const float* smem,
                                          int fold_base,
                                          const float (&x)[4][3], int t,
                                          int lane, AFrag (&feat)[2][4]) {
  const Levels& lv = a.lv;
  float fold[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) fold[m][nt][k] = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int G = lv.G[l], R = lv.R[l];
    int row[4][3];
    float w[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float xf = fminf(fmaxf(x[q][k], 0.f), 1.f) * (float)(G - 1);
        const int xi = min((int)floorf(xf), G - 2);
        w[q][k] = xf - (float)xi;
        row[q][k] = lv.off[l][k] + xi * R + 4 * t;
      }
    for (int p = 0; p < (R >> 4); ++p) {
      // f[q][j]: rank 16p + 4t + j of row q
      float f[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* r0 = a.tables + row[q][k] + 16 * p;
          const float4 t0 = __ldg(reinterpret_cast<const float4*>(r0));
          const float4 t1 = __ldg(reinterpret_cast<const float4*>(r0 + R));
          const float u = 1.f - w[q][k], v = w[q][k];
          const float e[4] = {t0.x * u + t1.x * v, t0.y * u + t1.y * v,
                              t0.z * u + t1.z * v, t0.w * u + t1.w * v};
#pragma unroll
          for (int j = 0; j < 4; ++j) f[q][j] = k == 0 ? e[j] : f[q][j] * e[j];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kt = lv.kt0[l] + 2 * p + h;
        AFrag af[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          af[m] = split_a(f[2 * m][2 * h], f[2 * m + 1][2 * h],
                          f[2 * m][2 * h + 1], f[2 * m + 1][2 * h + 1]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const BFrag b = load_b(smem, fold_base, 4, kt, nt, lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(fold[m][nt], af[m], b);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) feat[m][kt] = a_from_c(fold[m][kt]);
}

// The hash-grid encode straight into the σ-net's A fragments. The packed
// s1 reads its K rows in c_order, so A columns t and t + 4 of k-tile kt are
// input features 8kt + 2t and 8kt + 2t + 1: the two features of level
// 4kt + t. Lane (g, t) interpolates levels t, t+4, t+8 and t+12 of its four
// rows' samples (ENCODE's `interp_level`, each corner one 8-B load that
// holds both of its A entries); a level past the spec's, or a sample
// outside [0, 1]³, gives zeros. Every corner is loaded (an out-of-bound
// sample's rows are still rows of its level, reduced modulo its size) and
// the zeros selected after, so the loads of a level's four samples issue
// together.
__device__ __forceinline__ void hash_encode(const Args& a,
                                            const float (&x)[4][3], int t,
                                            AFrag (&feat)[2][4]) {
  bool in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) in[q] = in_unit_cube(x[q][0], x[q][1], x[q][2]);
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const int l = 4 * kt + t;
    float f[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q][0] = f[q][1] = 0.f;
    if (l < a.n_hash_levels) {
      const Level L = load_level(a.hash_levels, l);
      const float* rows = a.tables + (size_t)L.offset * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[2];
        interp_level<2>(rows, L, x[q][0], x[q][1], x[q][2], v);
        f[q][0] = in[q] ? v[0] : 0.f;
        f[q][1] = in[q] ? v[1] : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
      feat[m][kt] = split_a(f[2 * m][0], f[2 * m + 1][0], f[2 * m][1],
                            f[2 * m + 1][1]);
  }
}

// pos: ray origins (N, 3), or world positions (N, S, 3) in SAMPLES mode;
// vdir: view dirs (N, 3), or (N, S, 3) in SAMPLES mode; rays_d is read in
// COMPOSITE and ROWS, deltas (N, S) in SAMPLES only.
template <int ENC, int MODE, bool SIGMA_ONLY, bool SOFTPLUS>
__device__ __forceinline__ void field_body(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FOLD = SIGMA_ONLY ? SM_SIGMA : SM_FULL;
  constexpr bool RAY_DIRS = MODE != SAMPLES;  // one view dir a ray
  const Levels& lv = a.lv;

  // the weights, staged once a block (the grid is persistent)
  {
    const float* nets = a.nets + lv.sum_r * F;  // the hash grid's sum_r is 0
    if constexpr (ENC == CP_GRID) stage(a.nets, lv.sum_r, F, smem + FOLD);
    stage(nets + S1, F, H, smem + 2 * S1);
    stage(nets + S2, H, NSG, smem + 2 * S2);
    if (!SIGMA_ONLY) {
      stage(nets + C1, 32, H, smem + 2 * C1);
      stage(nets + C2, H, H, smem + 2 * C2);
      stage(nets + C3, H, 8, smem + 2 * C3);
      stage(nets + N1, 16, H, smem + 2 * N1);
      stage(nets + N2, H, 8, smem + 2 * N2);
      stage(nets + M1, 16, HM, smem + 2 * M1);
      stage(nets + M2, HM, 8, smem + 2 * M2);
      for (int k = threadIdx.x; k < HM + 1; k += BLOCK)
        smem[SM_BIAS + k] = nets[M1B + k];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.n_samples;
  const int chunks = (S + 3) >> 2;
  const float two_b = 2.f * a.bound;
  // lane L's sample in the one-a-lane layout: ray L % 8, sample L / 8
  const int lg = lane & 7, lq = lane >> 3;

  for (long long r0 = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5))
                      * RAYS;
       r0 < a.n_rays; r0 += (long long)gridDim.x * WARPS * RAYS) {
    // this lane's fragment rows are all of ray r0 + g (rays past the last
    // evaluate the last, weighted 0 and never written)
    const bool has_ray = r0 + g < a.n_rays;
    const long long ray = min(r0 + g, (long long)a.n_rays - 1);
    const long long ray0 = ray * S;  // the ray's first sample
    float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
    if (MODE != SAMPLES) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = a.pos[ray * 3 + k];
        d[k] = a.rays_d[ray * 3 + k];
      }
    }
    AFrag sh_ray[2];  // the ray's SH columns (k-tiles 0, 1 of c1)
    if (!SIGMA_ONLY && RAY_DIRS) {
      float q4[4];
      sh_quad(a.vdir[ray * 3], a.vdir[ray * 3 + 1], a.vdir[ray * 3 + 2], t,
              q4);
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
        sh_ray[kt] = split_a(q4[2 * kt], q4[2 * kt], q4[2 * kt + 1],
                             q4[2 * kt + 1]);
    }
    const long long lray = r0 + lg;  // the one-a-lane layout's ray
    float carry = 0.f;      // Σ sd over lane lg's ray's earlier chunks
    float acc[NOUT];        // per-ray sums (lanes t = 0)
#pragma unroll
    for (int k = 0; k < NOUT; ++k) acc[k] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      const int i0 = c * 4;
      // this lane's fragment rows: sample i0 + q of ray r0 + g
      // (q = 2·m-tile + half; row 8q + g)
      float x[4][3], zq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // samples past the ray's end evaluate its last, weighted 0
        const long long zi = ray0 + min(i0 + q, S - 1);
        zq[q] = a.z_vals[zi];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // unfused mul/add: the same roundings as the plain version
          const float p = MODE == SAMPLES
              ? a.pos[zi * 3 + k]
              : __fadd_rn(o[k], __fmul_rn(d[k], zq[q]));
          // NGPField.density: (p + b)·fp32(1/2b), two roundings
          x[q][k] = ENC == CP_GRID
              ? (p + a.bound) / two_b
              : __fmul_rn(__fadd_rn(p, a.bound), a.inv_2b);
        }
      }

      // ---- the encoder, straight into the σ-net's A fragments ----------
      AFrag feat[2][4];
      if constexpr (ENC == CP_GRID)
        cp_encode(a, smem, FOLD, x, t, lane, feat);
      else
        hash_encode(a, x, t, feat);

      // ---- σ-net: 32 → 64 relu → 16 -----------------------------------
      // JB hidden n-tiles at a time (2·JB independent accumulators), each
      // streamed into the output as soon as it is activated; the output
      // sums even and odd hidden tiles apart (two chains a tile)
      float sg[2][2][4];
      {
        float part[2][2][2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int k = 0; k < 4; ++k) part[e][m][nt][k] = 0.f;
#pragma unroll
        for (int jb = 0; jb < H / 8; jb += JB) {
          float hc[JB][2][4];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int k = 0; k < 4; ++k) hc[jj][m][k] = 0.f;
#pragma unroll
          for (int kt = 0; kt < 4; ++kt)
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const BFrag b = load_b(smem, 2 * S1, H / 8, kt, jb + jj, lane);
#pragma unroll
              for (int m = 0; m < 2; ++m) mma3(hc[jj][m], feat[m][kt], b);
            }
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            AFrag ha[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                hc[jj][m][k] = fmaxf(hc[jj][m][k], 0.f);
              ha[m] = a_from_c(hc[jj][m]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const BFrag b = load_b(smem, 2 * S2, 2, jb + jj, nt, lane);
#pragma unroll
              for (int m = 0; m < 2; ++m) mma3(part[jj & 1][m][nt], ha[m], b);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              sg[m][nt][k] = part[0][m][nt][k] + part[1][m][nt][k];
      }

      // raw σ (column 0, lanes t = 0) to one sample a lane: lane L holds
      // row L, sample i0 + L / 8 of ray r0 + L % 8
      const int src = lg << 2;
      const float s00 = __shfl_sync(0xffffffffu, sg[0][0][0], src);
      const float s02 = __shfl_sync(0xffffffffu, sg[0][0][2], src);
      const float s10 = __shfl_sync(0xffffffffu, sg[1][0][0], src);
      const float s12 = __shfl_sync(0xffffffffu, sg[1][0][2], src);
      const float sigma = lq == 0 ? s00 : lq == 1 ? s02 : lq == 2 ? s10
                                                                 : s12;
      const int i = i0 + lq;
      const bool active = lray < a.n_rays && i < S;
      const long long zi = lray * S + i;
      if (MODE == ROWS && SIGMA_ONLY && active) a.rows[zi] = sigma;

      float wt = 0.f;
      if (MODE != ROWS) {
        float sd = 0.f;
        if (active) {
          const float z = a.z_vals[zi];
          const float delta = MODE == SAMPLES
              ? a.deltas[zi]
              : (i == S - 1 ? 1e10f : a.z_vals[zi + 1] - z);
          const float act = SOFTPLUS
              ? fmaxf(sigma, 0.f) + log1pf(expf(-fabsf(sigma)))
              : fmaxf(sigma, 0.f);
          sd = delta * act;
        }
        // EXCLUSIVE prefix of sd along each ray (lanes lg, lg + 8, …): a
        // lane's prefix never holds its own sd, so the 1e10 sentinel on the
        // last sample cancels nothing
        float incl = sd;
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += y;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 8);
        if (lane < 8) excl = 0.f;
        excl = carry + excl;
        carry += __shfl_sync(0xffffffffu, incl, 24 + lg);
        if (active) {
          wt = expf(-excl) * (1.f - expf(-sd));
          a.weights[zi] = wt;
        }
      }
      if (SIGMA_ONLY) continue;

      // ---- the heads, from geo (σ-net columns 1..15) -------------------
      AFrag geo[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) geo[m][kt] = a_from_c(sg[m][kt]);
      AFrag sh[2][2];
      if (RAY_DIRS) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          sh[m][0] = sh_ray[0];
          sh[m][1] = sh_ray[1];
        }
      } else {
        float q4[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long vi = (ray0 + min(i0 + q, S - 1)) * 3;
          sh_quad(a.vdir[vi], a.vdir[vi + 1], a.vdir[vi + 2], t, q4[q]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
            sh[m][kt] = split_a(q4[2 * m][2 * kt], q4[2 * m + 1][2 * kt],
                                q4[2 * m][2 * kt + 1],
                                q4[2 * m + 1][2 * kt + 1]);
      }

      // color: [sh; σ; geo] → 64 relu → 64 relu → 3 (sigmoid below). The
      // narrow output layers (N = 8) sum JB interleaved chains a row tile.
      float rgb[2][4], nrm[2][4], mir[2][4];
      {
        float c2[2][8][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) c2[m][nt][k] = 0.f;
#pragma unroll
        for (int jb = 0; jb < H / 8; jb += JB) {
          float hc[JB][2][4];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int k = 0; k < 4; ++k) hc[jj][m][k] = 0.f;
#pragma unroll
          for (int kt = 0; kt < 4; ++kt)
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const BFrag b = load_b(smem, 2 * C1, H / 8, kt, jb + jj, lane);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma3(hc[jj][m], kt < 2 ? sh[m][kt] : geo[m][kt - 2], b);
            }
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            AFrag ha[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                hc[jj][m][k] = fmaxf(hc[jj][m][k], 0.f);
              ha[m] = a_from_c(hc[jj][m]);
            }
#pragma unroll
            for (int nt = 0; nt < H / 8; ++nt) {
              const BFrag b = load_b(smem, 2 * C2, H / 8, jb + jj, nt, lane);
#pragma unroll
              for (int m = 0; m < 2; ++m) mma3(c2[m][nt], ha[m], b);
            }
          }
        }
        float part[JB][2][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int k = 0; k < 4; ++k) part[jj][m][k] = 0.f;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const BFrag b = load_b(smem, 2 * C3, 1, j, 0, lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int k = 0; k < 4; ++k) c2[m][j][k] = fmaxf(c2[m][j][k], 0.f);
            mma3(part[j % JB][m], a_from_c(c2[m][j]), b);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            rgb[m][k] = sum_parts(part, m, k);
      }

      // normal: [σ; geo] → 64 relu → 3 (normalized below)
      {
        float part[JB][2][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int k = 0; k < 4; ++k) part[jj][m][k] = 0.f;
#pragma unroll
        for (int jb = 0; jb < H / 8; jb += JB) {
          float hc[JB][2][4];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int k = 0; k < 4; ++k) hc[jj][m][k] = 0.f;
#pragma unroll
          for (int kt = 0; kt < 2; ++kt)
#pragma unroll
            for (int jj = 0; jj < JB; ++jj) {
              const BFrag b = load_b(smem, 2 * N1, H / 8, kt, jb + jj, lane);
#pragma unroll
              for (int m = 0; m < 2; ++m) mma3(hc[jj][m], geo[m][kt], b);
            }
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            const BFrag b = load_b(smem, 2 * N2, 1, jb + jj, 0, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                hc[jj][m][k] = fmaxf(hc[jj][m][k], 0.f);
              mma3(part[jj][m], a_from_c(hc[jj][m]), b);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            nrm[m][k] = sum_parts(part, m, k);
      }

      // mirror: [σ; geo] → 32 (+b) leaky 0.01 → 1 (+b, sigmoid below)
      {
        float hc[HM / 8][2][4];
#pragma unroll
        for (int j = 0; j < HM / 8; ++j)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int k = 0; k < 4; ++k) hc[j][m][k] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt)
#pragma unroll
          for (int j = 0; j < HM / 8; ++j) {
            const BFrag b = load_b(smem, 2 * M1, HM / 8, kt, j, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma3(hc[j][m], geo[m][kt], b);
          }
        float part[HM / 8][2][4];
#pragma unroll
        for (int j = 0; j < HM / 8; ++j) {
          const float b0 = smem[SM_BIAS + 8 * j + 2 * t];
          const float b1 = smem[SM_BIAS + 8 * j + 2 * t + 1];
          const BFrag b = load_b(smem, 2 * M2, 1, j, 0, lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float v = hc[j][m][k] + ((k & 1) ? b1 : b0);
              hc[j][m][k] = v >= 0.f ? v : 0.01f * v;
              part[j][m][k] = 0.f;
            }
            mma3(part[j][m], a_from_c(hc[j][m]), b);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            mir[m][k] = (part[0][m][k] + part[1][m][k])
                        + (part[2][m][k] + part[3][m][k]);
      }

      // column 2 of rgb and normal lives in lane t = 1: to lane t = 0,
      // which then holds every output of its four rows
      float rgb2[2][2], nrm2[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          rgb2[m][h] = __shfl_down_sync(0xffffffffu, rgb[m][2 * h], 1);
          nrm2[m][h] = __shfl_down_sync(0xffffffffu, nrm[m][2 * h], 1);
        }
      const float m2b = smem[SM_BIAS + HM];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = q >> 1, h = q & 1;
        const float r[3] = {sigmoidf(rgb[m][2 * h]),
                            sigmoidf(rgb[m][2 * h + 1]),
                            sigmoidf(rgb2[m][h])};
        float n[3] = {nrm[m][2 * h], nrm[m][2 * h + 1], nrm2[m][h]};
        const float nsq = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
        const float ninv = rsqrtf(fmaxf(nsq, 1.1920929e-07f));
#pragma unroll
        for (int k = 0; k < 3; ++k) n[k] *= ninv;
        const float mr = sigmoidf(mir[m][2 * h] + m2b);
        const int iq = i0 + q;
        if (MODE == ROWS) {
          if (t == 0 && has_ray && iq < S) {
            float4* out = reinterpret_cast<float4*>(a.rows +
                                                    (ray0 + iq) * NROW);
            out[0] = make_float4(sg[m][0][2 * h], r[0], r[1], r[2]);
            out[1] = make_float4(n[0], n[1], n[2], mr);
          }
        } else {
          // this row's weight, from the lane that holds its sample (0 past
          // the ray's end); the row's ray is this lane's own
          const float wq = __shfl_sync(0xffffffffu, wt, 8 * q + g);
          const float v[NOUT] = {1.f, r[0], r[1], r[2], n[0], n[1], n[2],
                                 mr, zq[q]};
#pragma unroll
          for (int k = 0; k < NOUT; ++k) acc[k] += wq * v[k];
        }
      }
    }
    if (MODE != ROWS && !SIGMA_ONLY && t == 0 && has_ray) {
#pragma unroll
      for (int k = 0; k < NOUT; ++k) a.per_ray[ray * NOUT + k] = acc[k];
    }
  }
}

template <int MODE, bool SIGMA_ONLY, bool SOFTPLUS>
__global__ void __launch_bounds__(BLOCK, SIGMA_ONLY ? 2 : 1)
    cp_field_kernel(const Args a) {
  field_body<CP_GRID, MODE, SIGMA_ONLY, SOFTPLUS>(a);
}

// The fused NGP composite: the hash grid's 16 levels into the σ-net, the
// heads and the composite of the CP kernel. Its nets take 96 KB of shared
// memory (full) or 25 KB (σ-only), so two full blocks an SM, or more
// σ-only ones, would fit; the registers decide. One 8-warp block an SM,
// both variants, measured (tools/exp_hash_diag.py, H100 80GB HBM3 at
// 700 W): held to 128 registers the full variant spills ~850 B and takes
// 1.7× as long; the σ-only variant, at 183 registers, is 7 % faster than
// two blocks at 128 with ~60 B of spills, and three blocks (80 registers)
// take 1.5× as long.
constexpr int HASH_BLOCKS_FULL = 1;
constexpr int HASH_BLOCKS_SIGMA = 1;
template <bool SIGMA_ONLY, bool SOFTPLUS>
__global__ void __launch_bounds__(BLOCK, SIGMA_ONLY ? HASH_BLOCKS_SIGMA
                                                    : HASH_BLOCKS_FULL)
    hash_field_kernel(const Args a) {
  field_body<HASH_GRID, COMPOSITE, SIGMA_ONLY, SOFTPLUS>(a);
}

// Per instance and card: the largest dynamic shared memory the kernel's
// attribute was raised to there, and the grid for the size last asked for.
// The entry drops Python's lock, so callers on two cards may launch at once:
// one mutex an instance guards its cards' slots.
struct Launch {
  size_t attr = 0;
  size_t smem = 0;
  int grid = 0;  // blocks resident on the card at once
};
constexpr int MAX_DEVICES = 64;

template <int ENC, int MODE, bool SIGMA_ONLY, bool SOFTPLUS>
int launch(const Args& a, int device, cudaStream_t stream) {
  void (*kern)(const Args);
  if constexpr (ENC == HASH_GRID)
    kern = hash_field_kernel<SIGMA_ONLY, SOFTPLUS>;
  else
    kern = cp_field_kernel<MODE, SIGMA_ONLY, SOFTPLUS>;
  static Launch cached[MAX_DEVICES];
  static std::mutex mu;
  if (device < 0 || device >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  const size_t smem =
      (size_t)((SIGMA_ONLY ? SM_SIGMA : SM_FULL) + 2 * a.lv.sum_r * F) *
      sizeof(float);
  int resident;
  {
    std::lock_guard<std::mutex> lock(mu);
    Launch& c = cached[device];
    if (c.smem != smem) {
      // raised only: a launch of a smaller size in flight stays valid
      cudaError_t e = cudaSuccess;
      if (smem > c.attr)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      int per_sm = 0, sms = 0;
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          BLOCK, smem);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
      if (smem > c.attr) c.attr = smem;
      c.smem = smem;
      c.grid = per_sm * sms;
    }
    resident = c.grid;
  }
  const long long want =
      ((long long)a.n_rays + WARPS * RAYS - 1) / (WARPS * RAYS);
  const int grid = (int)(want < resident ? want : resident);
  kern<<<grid, BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int ENC, int MODE>
int launch_variant(const Args& a, bool sigma_only, bool softplus, int device,
                   cudaStream_t s) {
  if (sigma_only)
    return softplus ? launch<ENC, MODE, true, true>(a, device, s)
                    : launch<ENC, MODE, true, false>(a, device, s);
  return softplus ? launch<ENC, MODE, false, true>(a, device, s)
                  : launch<ENC, MODE, false, false>(a, device, s);
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_cp.py turns into a message:
//   -1 level count outside [1, MAX_LEVELS]   -2 S outside [1, MAX_S]
//   -3 a level with G < 2 or R < 1           -4 n_nets is not the layout's
//   -5 the nets exceed the shared memory     -6 n_rays < 1
//   -7 mode outside {0, 1, 2}
//   -8 a level's packed rank not a multiple of 16, or tables of 2³¹ floats
// mode 0 (COMPOSITE): pos = rays_o (N, 3), rays_d (N, 3), vdir (N, 3);
// writes weights (N, S) and, unless σ-only, per_ray (N, 9). mode 1 (ROWS):
// the same inputs; writes rows (N, S, 8), or (N, S) raw σ when σ-only, and
// ignores softplus. mode 2 (SAMPLES): pos (N, S, 3), vdir (N, S, 3),
// deltas (N, S); writes what mode 0 writes. vdir is unread when σ-only.
// All pointers are device pointers except level_g, level_r and table_off,
// which are host arrays of n_levels entries (table_off: 3 per level,
// axis-minor); level_r is each level's packed rank (its tables' row
// stride, a multiple of 16), and nets the fold (Σ level_r × 32) and the
// nets in the layout above, as ops/fused_cp.py `_pack_nets` writes them.
// The entry takes the card's index (int) and a stream of that card last;
// the guard makes the card current for the launch (csrc/launch.cuh).
int mnerf_fused_cp_composite(
    const float* pos, const float* rays_d, const float* vdir,
    const float* z_vals, const float* deltas, const float* tables,
    const float* nets, long long n_nets, const int* level_g,
    const int* level_r, const long long* table_off, int n_levels, int n_rays,
    int n_samples, float bound, int mode, int sigma_only, int softplus,
    float* weights, float* per_ray, float* rows, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  if (n_samples < 1 || n_samples > MAX_S) return -2;
  if (mode < COMPOSITE || mode > SAMPLES) return -7;
  Args a{pos, rays_d, vdir, z_vals, deltas, tables, nets};
  a.lv.n = n_levels;
  int sum_r = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (level_g[l] < 2 || level_r[l] < 1) return -3;
    if (level_r[l] % 16) return -8;
    a.lv.G[l] = level_g[l];
    a.lv.R[l] = level_r[l];
    a.lv.kt0[l] = sum_r / 8;
    for (int k = 0; k < 3; ++k) {
      const long long off = table_off[l * 3 + k];
      if (off < 0 || off + (long long)level_g[l] * level_r[l] > 0x7fffffffll)
        return -8;
      a.lv.off[l][k] = (int)off;
    }
    sum_r += level_r[l];
  }
  a.lv.sum_r = sum_r;
  if (n_nets != (long long)sum_r * F + NETS) return -4;
  if (((long long)(sigma_only ? SM_SIGMA : SM_FULL) + 2LL * sum_r * F) * 4 >
      SMEM_LIMIT)
    return -5;
  if (n_rays < 1) return -6;
  a.n_rays = n_rays;
  a.n_samples = n_samples;
  a.bound = bound;
  a.weights = weights;
  a.per_ray = per_ray;
  a.rows = rows;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == ROWS)  // raw σ out: no activation, one instance per variant
    return sigma_only ? launch<CP_GRID, ROWS, true, false>(a, device, s)
                      : launch<CP_GRID, ROWS, false, false>(a, device, s);
  if (mode == SAMPLES)
    return launch_variant<CP_GRID, SAMPLES>(a, sigma_only, softplus, device,
                                            s);
  return launch_variant<CP_GRID, COMPOSITE>(a, sigma_only, softplus, device,
                                            s);
}

// The fused NGP composite (COMPOSITE semantics; ops/fused_hash.py). Returns
// 0, a cudaError_t (> 0), or a negative code for arguments the kernel does
// not take, which ops/fused_hash.py turns into a message:
//   -1 level count outside [1, MAX_HASH_LEVELS]   -2 S outside [1, MAX_S]
//   -4 n_nets is not the layout's                 -6 n_rays < 1
// rays_o, rays_d, vdir (N, 3), z (N, S); table the flat (rows, 2) table;
// levels its n_levels × 8 int32 words (ops/hashgrid.py `_level_table`), a
// device array; nets the layout above without the fold (ops/fused_hash.py
// `_pack_nets`); inv_2b = fp32(1 / 2·bound). Writes weights (N, S) and,
// unless σ-only, per_ray (N, 9). vdir is unread when σ-only. The card's
// index and a stream of that card come last (csrc/launch.cuh).
int mnerf_fused_hash_composite(
    const float* rays_o, const float* rays_d, const float* vdir,
    const float* z_vals, const float* table, const int* levels, int n_levels,
    const float* nets, long long n_nets, int n_rays, int n_samples,
    float bound, float inv_2b, int sigma_only, int softplus, float* weights,
    float* per_ray, int device, void* stream) {
  if (n_levels < 1 || n_levels > MAX_HASH_LEVELS) return -1;
  if (n_samples < 1 || n_samples > MAX_S) return -2;
  if (n_nets != NETS) return -4;
  if (n_rays < 1) return -6;
  Args a{rays_o, rays_d, vdir, z_vals, nullptr, table, nets};
  a.hash_levels = reinterpret_cast<const Level*>(levels);
  a.n_hash_levels = n_levels;
  a.inv_2b = inv_2b;
  a.n_rays = n_rays;
  a.n_samples = n_samples;
  a.bound = bound;
  a.weights = weights;
  a.per_ray = per_ray;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return launch_variant<HASH_GRID, COMPOSITE>(
      a, sigma_only, softplus, device, (cudaStream_t)stream);
}

}  // extern "C"
