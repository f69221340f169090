// The flagship PE-MLP field per sample for trunks wider than 4096, layer by
// layer: each layer one 3×TF32 `wgmma` GEMM over all the samples of a chunk
// (sm_90a), the activations in global memory between layers.
//
// Replaces, for every `FusedSpec` the JAX adapters build wider than 4096
// (`FusedSpec(width=field.width, depth=field.depth, skips=field.skips)`: a
// multiple of 128, any depth, any skips, ≤ 20 posenc frequencies each,
// either head), the two per-sample Pallas TPU kernels of
// mirror_nerf_tpu/ops/pallas/fused_mlp.py: `_kernel_rays:238` (rays;
// fused_forward_rays:310 → pallas_call :348, adapter fused_rays_eval:367)
// and `_kernel:223` (points; fused_forward:266 → :290, adapters
// fused_packed_eval:416, fused_field_eval:448). Trunks up to width 4096
// take csrc/fused_mlp_rows_tc.cu (ops/fused_mlp.py `rows_route`); the entry
// takes any width that is a multiple of 128, so that it can be timed there
// too.
//
// For each sample (ray r, depth index i; a point is a one-sample ray with
// o = x, d = 0, z = 0):
//   x = o + d·z (a rounded multiply, then a rounded add: no FMA)
//   pe = [x, sin(f·x), sin(f·x + π/2)] for f = 2^0..2^(F-1), fp32 sinf
//   trunk: depth × (Linear W + ReLU); layer 0 reads pe, a skip layer
//     [pe, h] (posenc rows first), the others h
//   σ = h·w_σ + b_σ (raw)
//   unless σ-only:
//     rgb = sigmoid(relu([h W_xf + b_xf, posenc(v)] W_d + b_d) W_rgb + b_rgb)
//     n = (h W_n0 + b_n0) W_n1 + b_n1, times rsqrt(max(|n|², ε_f32))
//     m = sigmoid(leaky_0.01(h W_m0 + b_m0) W_m1 + b_m1)
// and writes 8 floats a sample [σ, rgb, n, m] (0 for a head the field
// lacks), or raw σ alone when σ-only.
//
// What bounds it on the H100: the products, 3 × 2·(pe·W + (depth−1)·W² +
// skips·pe·W + W² + (W + dpe)·W/2 + 2·W·W/2 + …) operations a sample in
// 3×TF32 over the 495 TFLOP/s TF32 peak: 4.46 ms for 64 rays × 128 samples
// at width 4224, depth 1. Above the L2 (one layer's weights are 143 MB as
// TF32 hi/lo planes at width 4224), a kernel that keeps a pass's samples
// on chip and streams every layer for each pass reads ~16 operations a byte
// from device memory, against the ~148 the 3×TF32 products need. So the
// design is the ordinary one, each layer a tiled matrix product over many
// samples at once:
//   * the entry (`mnerf_mlp_layers`) walks the samples in chunks on the
//     caller's stream and launches, a chunk: `posenc_kernel` (the chunk's
//     xyz posenc and, unless σ-only, the view-dir posenc, as the first
//     GEMMs' A operand), one `gemm_kernel` a layer from a plan the wrapper
//     writes (ops/fused_mlp.py `layers_plan`: the trunk, then the heads'
//     GEMM h → [xyz_final | normal 0 | mirror 0] and the dir GEMM [xf |
//     posenc(v)] → W/2), and `finish_kernel` (the 1- and 3-wide heads);
//   * a GEMM is Y = act([A_0 | A_1]·B + b) with one or two K segments
//     (posenc rows first in a skip layer, as JAX's `_trunk`) and up to
//     three column ranges, each with its own bias, activation and
//     destinations: the next GEMM's A operand, and/or fp32 rows for the
//     final dots. Output tiles of 128 samples × 128 columns; persistent
//     CTAs walk them in groups of 8 row tiles, so that a wave's tiles
//     share their A row panels and B column panels through L2;
//   * a CTA is two consumer warpgroups (64 rows each, m64n128k8) and a
//     producer warpgroup of which one thread fills a ring of 6 stages by
//     two 1-D bulk copies (`cp.async.bulk`) a stage: a 16-KB A tile and a
//     16-KB B tile, each two k-steps (16 K values) of TF32 hi and lo
//     planes, K-major in the 32-byte swizzle the `wgmma` descriptor reads;
//     an `mbarrier` transaction count says a stage has arrived, and each
//     consumer warpgroup releases it when its products are done;
//   * 3×TF32: every product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the
//     small terms first; hi and lo are `cvt.rna.tf32.f32` (lo of x − hi).
//     Both operands come from shared memory by descriptor: the wrapper
//     splits the weights once (cached per params), and the epilogue that
//     writes an activation writes it as the hi and lo planes of the next
//     GEMM's A tiles, so that the main loop holds no conversion and no
//     A-fragment loads (the price: A's bytes twice, 8 a value). Posenc
//     rows, the raw position rows among them, enter as 3×TF32 like every
//     other operand: never through one TF32 product;
//   * the tensor cores' fp32 sums truncate, so a tensor-core sum spans one
//     stage (two k-steps) and each thread adds it into its fp32 sum on
//     the CUDA cores: a layer of K = 4224 is 264 such sums, not one;
//   * the final dots (σ, rgb, normal, mirror) are fp32 on the CUDA cores,
//     a warp a sample, each lane's strided terms in k order, then a fixed
//     butterfly of shuffles; sigmoid, the unit normal, and the rows;
//   * the workspace (activations of one chunk) comes from the wrapper,
//     through torch's allocator, under a cap (ops/fused_mlp.py
//     `WORKSPACE_CAP`, 2 GiB): the chunk is the largest multiple of 128
//     samples whose buffers fit (`chunk_rows`).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23,
// PERF.md §6 rows 5f, 6f): width 4224, depth 1, 64 rays × 128 samples,
// 9.10 ms full (49.0 % of the 3×TF32 bound, 1.91× the plain route's
// 17.37; the fp32 FMA kernel before it took 236.7), 0.295 ms σ-only
// (2.64×), 4096 points 4.28 ms (52.1 %, 2.04×); the 16×12 level-2 view
// 0.42 s (9.44 before). At width 4096, depth 2 (256 rays × 128, full)
// 50.4–50.6 ms against the cluster instance's 79.8–80.5 (46.6 % and
// 29.4 % of the bound). Not profiled; by count a stage moves 32 KB from
// L2 for 128·128·16 multiply-adds, ~5 TB/s of L2 reads at 9.1 ms:
// clusters that multicast A or B would halve them (untried).

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128;          // samples an output tile
constexpr int BN = 128;          // columns an output tile
constexpr int KT = 16;           // K values a stage: two k-steps of 8
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer's
constexpr int PLANE = 128 * 8;   // floats of a k-step plane of a tile
constexpr int TILE = 4 * PLANE;  // a tile: [hi, lo] × two k-steps
constexpr int TILE_BYTES = TILE * 4;
constexpr int STAGES = 6;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // an A tile, a B tile
constexpr int FULL = STAGES * STAGE_BYTES;
constexpr int EMPTY = FULL + 8 * STAGES;
constexpr int ALIGN = 256;       // a 32-byte-swizzled plane's alignment
constexpr int SMEM = EMPTY + 8 * STAGES + ALIGN;
constexpr int GROUP = 8;         // row tiles of a group in the tile order
constexpr int MAX_SEGS = 2;      // K segments of a GEMM
constexpr int MAX_RANGES = 3;    // column ranges of a GEMM
constexpr int MAX_GEMMS = 64;
constexpr int MAX_NF = 20;       // posenc frequencies, x or v
constexpr int NROW = 8;          // σ, rgb (3), normal (3), mirror
constexpr float HALF_PI = 1.57079637f;  // fp32(π/2), as the JAX phase
static_assert(SMEM <= 232448, "shared memory");

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

// The plan (int64, on the host; ops/fused_mlp.py `layers_plan` writes it):
// a header of HEADER entries, then REC entries a GEMM.
constexpr int HEADER = 24, REC = 40;
enum {
  H_ROWS = 0,   // samples a chunk (a multiple of BM; < BM: refused)
  H_GEMMS,      // GEMMs a chunk
  H_KT_X,       // K tiles of the xyz posenc buffer
  H_PE_X,       // its float offset in the workspace
  H_KT_V,       // K tiles of the view-dir posenc buffer (0 when σ-only)
  H_PE_V,       // its offset (−1 when σ-only)
  H_H, H_C, H_N0, H_M0,  // the final dots' fp32 inputs (−1: absent)
  H_SW, H_SB, H_RW, H_RB, H_N1W, H_N1B, H_M1W, H_M1B,  // their leaves
  H_WS          // floats of workspace the plan takes
};
// a GEMM's record: B tiles' offset, N tiles, K tiles, K segments (buffer
// offset, K tiles) × 2, column ranges (first column, columns, activation,
// K tiles of the split destination (0: none), its offset, fp32
// destination's offset (−1: none), its row stride, bias offset) × 3
enum { G_B = 0, G_NT, G_KT, G_NSEG, G_SEG, G_NRANGE = G_SEG + 2 * MAX_SEGS,
       G_RANGE, R_FIELDS = 8 };
static_assert(G_RANGE + R_FIELDS * MAX_RANGES <= REC, "record");

struct Range {
  int n0;           // first column of the GEMM's B (a multiple of BN)
  int n;            // columns
  int act;
  int split_kt;     // K tiles a row tile of the split destination holds
  long long split;  // its float offset in the workspace
  long long f32;    // the fp32 destination's offset (−1: none)
  int ld;           // its row stride in floats
  long long bias;   // the bias's float offset in nets
};

struct Gemm {
  long long b;      // float offset of the B tiles in nets
  int n_tiles, k_tiles, nseg, nrange;
  long long a[MAX_SEGS];  // float offset of each K segment's A tiles
  int a_kt[MAX_SEGS];     // K tiles of each
  Range r[MAX_RANGES];
};

struct Finish {
  long long h, c, n0, m0;  // workspace offsets (−1: absent)
  long long sw, sb, rw, rb, n1w, n1b, m1w, m1b;  // nets offsets (−1: absent)
  int width;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_LEAKY) return y >= 0.f ? y : 0.01f * y;
  return y;
}

// x = hi + lo, each rounded to TF32 (lo of x − hi)
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(h));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(rest));
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// The float offset, within a tile, of row r's K value k (< KT) of the hi
// plane (the lo plane's is 2·PLANE further): the tile is [hi, lo] × two
// k-steps of 128 rows × 8 values, K-major in the 32-byte swizzle (the 16-B
// half h of row r holds the k-step's values 4(h ^ (r/4 mod 2)) … + 3).
__device__ __forceinline__ int tile_at(int r, int k) {
  const int q = k & 7;
  return (k >> 3) * PLANE + r * 8 + ((((q >> 2) ^ (r >> 2)) & 1) << 2) +
         (q & 3);
}

// Descriptor of a k-step plane (rows of 8 TF32, K-major) at shared address
// `addr` (256-B aligned): 32-byte swizzle (layout 3), rows 32 B apart,
// 8-row groups (SBO) 256 B apart; LBO is not read in a swizzled K-major
// layout.
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// d (+)= A·B, m64n128k8 TF32, both operands by descriptor; d is
// overwritten when `scale` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// `bytes` from global `src` to shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The output tile `tile` of an m_tiles × n_tiles grid in grouped order:
// GROUP row tiles at a time, the group's row tiles fastest, so that the
// tiles in flight at once share a few A row panels and B column panels.
__device__ __forceinline__ void tile_of(int tile, int m_tiles, int n_tiles,
                                        int& mt, int& nt) {
  const int per_group = GROUP * n_tiles;
  const int group = tile / per_group;
  const int first = group * GROUP;
  const int gm = min(m_tiles - first, GROUP);
  const int in = tile - group * per_group;
  mt = first + in % gm;
  nt = in / gm;
}

// Y = act([A_0 | A_1]·B + b) for the chunk's m_tiles row tiles, each
// column range to its destinations (see Gemm, Range).
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const float* __restrict__ nets, float* __restrict__ ws,
                const Gemm g, const int m_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const int tid = threadIdx.x;
  const int tiles = m_tiles * g.n_tiles;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + FULL + 8 * s, 1);
      mbar_init(base + EMPTY + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * CONSUMERS) {
    // ---- producer: one thread copies each tile's A and B k-tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * CONSUMERS) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, nt;
        tile_of(tile, m_tiles, g.n_tiles, mt, nt);
        const float* b = nets + g.b + (long long)nt * g.k_tiles * TILE;
        for (int kb = 0; kb < g.k_tiles; ++kb) {
          // k-tile kb of A: of the first K segment, or of the second
          const bool second = kb >= g.a_kt[0];
          const int akt = second ? g.a_kt[1] : g.a_kt[0];
          const float* a = ws + (second ? g.a[1] : g.a[0]) +
                           ((long long)mt * akt + (second ? kb - g.a_kt[0]
                                                          : kb)) * TILE;
          const uint32_t st = base + stage * STAGE_BYTES;
          mbar_wait(base + EMPTY + 8 * stage, phase ^ 1);
          mbar_expect_tx(base + FULL + 8 * stage, STAGE_BYTES);
          bulk_load(st, a, TILE_BYTES, base + FULL + 8 * stage);
          bulk_load(st + TILE_BYTES, b + (long long)kb * TILE, TILE_BYTES,
                    base + FULL + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes rows 64·wg … + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7, wtid = tid & 127;
  const int gq = (wtid & 31) >> 2, t = wtid & 3;
  const int r0 = 64 * wg + 16 * (wtid >> 5) + gq;  // rows r0, r0 + 8
  int stage = 0, phase = 0;
  float s[64], d[64];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt;
    tile_of(tile, m_tiles, g.n_tiles, mt, nt);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    for (int kb = 0; kb < g.k_tiles; ++kb) {
      mbar_wait(base + FULL + 8 * stage, phase);
      // A's planes: hi k-step 0, 1, lo k-step 0, 1 (this warpgroup's 64
      // rows, 2 KB into each); then B's, all 128 rows
      const uint64_t da = plane_desc(base + stage * STAGE_BYTES + 2048 * wg);
      const uint64_t db = plane_desc(base + stage * STAGE_BYTES + TILE_BYTES);
      constexpr uint64_t P1 = PLANE * 4 >> 4;  // a plane, 16-B units
      wgmma_fence();
      wgmma_ss(d, da + 2 * P1, db, 0);           // a_lo·b_hi, k-step 0
      wgmma_ss(d, da, db + 2 * P1, 1);           // a_hi·b_lo
      wgmma_ss(d, da + 3 * P1, db + P1, 1);      // k-step 1
      wgmma_ss(d, da + P1, db + 3 * P1, 1);
      wgmma_ss(d, da, db, 1);                    // a_hi·b_hi
      wgmma_ss(d, da + P1, db + P1, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(d);
      if (wtid == 0) mbar_arrive(base + EMPTY + 8 * stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] += d[i];
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: s[4q + 2h + e] is row r0 + 8h, column 8q + 2t + e of
    // the tile; its range's bias and activation, then its destinations
    Range R = g.r[0];
#pragma unroll
    for (int i = 1; i < MAX_RANGES; ++i)
      if (i < g.nrange && nt * BN >= g.r[i].n0) R = g.r[i];
    const int c0 = nt * BN - R.n0;  // the tile's first column of the range
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int c = c0 + 8 * q + 2 * t;
      if (c >= R.n) continue;  // R.n is a multiple of 64: c + 1 < R.n too
      const float2 bias =
          __ldg(reinterpret_cast<const float2*>(nets + R.bias + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float v0 = activate(s[4 * q + 2 * h] + bias.x, R.act);
        const float v1 = activate(s[4 * q + 2 * h + 1] + bias.y, R.act);
        const long long row = (long long)mt * BM + r;
        if (R.f32 >= 0)
          *reinterpret_cast<float2*>(ws + R.f32 + row * R.ld + c) =
              make_float2(v0, v1);
        if (R.split_kt) {
          float hi0, lo0, hi1, lo1;
          tf32_split(v0, hi0, lo0);
          tf32_split(v1, hi1, lo1);
          float* at = ws + R.split +
                      ((long long)mt * R.split_kt + c / KT) * TILE +
                      tile_at(r, c % KT);
          *reinterpret_cast<float2*>(at) = make_float2(hi0, hi1);
          *reinterpret_cast<float2*>(at + 2 * PLANE) = make_float2(lo0, lo1);
        }
      }
    }
  }
}

// posenc row k (< rows; 0 past them, the padding) of one coordinate
// triple: k < 3 the raw value, then per frequency band a sin block and a
// cos block of 3 rows each.
__device__ __forceinline__ float posenc_row(float c0, float c1, float c2,
                                            int k, int rows) {
  if (k >= rows) return 0.f;
  const int a = k < 3 ? k : (k - 3) % 3;
  const float v = a == 0 ? c0 : (a == 1 ? c1 : c2);
  if (k < 3) return v;
  const int j = k - 3;
  const int band = j / 6, within = j % 6;
  // f·x is exact (f = 2^band); the phase add rounds as the JAX x @ M + phase
  const float fx = __fmul_rn((float)(1 << band), v);
  return sinf(within < 3 ? fx : __fadd_rn(fx, HALF_PI));
}

// The chunk's posenc as A tiles: xyz (kt_x K tiles, `pe` rows, zeros past
// them and past the samples) and, when kt_v > 0, the view dirs'. One
// thread a (row, K value).
__global__ void posenc_kernel(const float* __restrict__ rays_o,
                              const float* __restrict__ rays_d,
                              const float* __restrict__ view_dirs,
                              const float* __restrict__ z_vals,
                              const long long start, const long long n_total,
                              const int n_samples, const int rows,
                              const int pe, const int kt_x,
                              const long long pe_x, const int dpe,
                              const int kt_v, const long long pe_v,
                              float* __restrict__ ws) {
  const int kx = kt_x * KT, kv = kt_v * KT;
  const long long n = (long long)rows * (kx + kv);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / (kx + kv));
    int k = (int)(i % (kx + kv));
    const bool view = k >= kx;
    if (view) k -= kx;
    const long long sample = start + r;
    float v[3] = {0.f, 0.f, 0.f};
    if (sample < n_total) {
      const long long ray = sample / n_samples;
      if (view) {
#pragma unroll
        for (int a = 0; a < 3; ++a) v[a] = view_dirs[ray * 3 + a];
      } else {
        const float z = z_vals[sample];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          v[a] = __fadd_rn(rays_o[ray * 3 + a],
                           __fmul_rn(rays_d[ray * 3 + a], z));
      }
    }
    float hi, lo;
    tf32_split(posenc_row(v[0], v[1], v[2], k, view ? dpe : pe), hi, lo);
    const int kt = view ? kt_v : kt_x;
    float* at = ws + (view ? pe_v : pe_x) +
                ((long long)(r / BM) * kt + k / KT) * TILE +
                tile_at(r % BM, k % KT);
    at[0] = hi;
    at[2 * PLANE] = lo;
  }
}

// sum over a warp in a fixed order (a butterfly: every lane holds it)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rows of the chunk's samples from the last layers' fp32 outputs: a
// warp a sample, each lane's terms k ≡ lane (mod 32) in k order, then
// `warp_sum`. σ-only: raw σ alone.
__global__ void finish_kernel(const float* __restrict__ nets,
                              const float* __restrict__ ws, const Finish f,
                              const int sigma_only, const int rows,
                              float* __restrict__ out) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int w = f.width, wh = f.width / 2;
  const float* h = ws + f.h + (long long)r * w;
  const float* sw = nets + f.sw;
  float sigma = 0.f;
  for (int k = lane; k < w; k += 32) sigma = fmaf(h[k], __ldg(sw + k), sigma);
  sigma = warp_sum(sigma) + __ldg(nets + f.sb);
  if (sigma_only) {
    if (lane == 0) out[r] = sigma;
    return;
  }
  float y[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // rgb, normal, mirror
  const float* c = ws + f.c + (long long)r * wh;
  const float* rw = nets + f.rw;
  for (int k = lane; k < wh; k += 32) {
    const float a = c[k];
#pragma unroll
    for (int o = 0; o < 3; ++o) y[o] = fmaf(a, __ldg(rw + 3 * k + o), y[o]);
  }
  if (f.n0 >= 0) {
    const float* n0 = ws + f.n0 + (long long)r * wh;
    const float* nw = nets + f.n1w;
    for (int k = lane; k < wh; k += 32) {
      const float a = n0[k];
#pragma unroll
      for (int o = 0; o < 3; ++o)
        y[3 + o] = fmaf(a, __ldg(nw + 3 * k + o), y[3 + o]);
    }
  }
  if (f.m0 >= 0) {
    const float* m0 = ws + f.m0 + (long long)r * wh;
    const float* mw = nets + f.m1w;
    for (int k = lane; k < wh; k += 32) y[6] = fmaf(m0[k], __ldg(mw + k), y[6]);
  }
#pragma unroll
  for (int o = 0; o < 7; ++o) y[o] = warp_sum(y[o]);
  if (lane) return;
  float4 lo = make_float4(sigma, 0.f, 0.f, 0.f), hi = make_float4(0.f, 0.f,
                                                                  0.f, 0.f);
  lo.y = sigmoidf(y[0] + __ldg(nets + f.rb));
  lo.z = sigmoidf(y[1] + __ldg(nets + f.rb + 1));
  lo.w = sigmoidf(y[2] + __ldg(nets + f.rb + 2));
  if (f.n0 >= 0) {
    const float n0 = y[3] + __ldg(nets + f.n1b),
                n1 = y[4] + __ldg(nets + f.n1b + 1),
                n2 = y[5] + __ldg(nets + f.n1b + 2);
    const float inv =
        rsqrtf(fmaxf(n0 * n0 + n1 * n1 + n2 * n2, 1.1920929e-07f));
    hi.x = n0 * inv;
    hi.y = n1 * inv;
    hi.z = n2 * inv;
  }
  if (f.m0 >= 0) hi.w = sigmoidf(y[6] + __ldg(nets + f.m1b));
  float4* o = reinterpret_cast<float4*>(out + (long long)r * NROW);
  o[0] = lo;
  o[1] = hi;
}

// the card's SMs, and whether gemm_kernel's shared memory is set there
int sm_count[64];
bool smem_set[64];

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_mlp.py turns into a message:
//   -2 n_samples < 1      -3 a posenc frequency count outside [0, 20]
//   -4 the width is not a positive multiple of 128
//   -6 no rays            -7 the plan is malformed
//   -8 not one tile of 128 samples fits the workspace cap (the plan's
//      chunk is below 128 samples)
//   -9 the workspace is smaller than the plan takes
// All pointers but `plan` (host memory) are device pointers; view_dirs may
// be null when σ-only. `nets` is the packed weights (ops/fused_mlp.py
// `pack_layers`), `ws` the workspace of `ws_floats` floats. Writes rows
// (n_rays·n_samples, 8), or (n_rays·n_samples,) raw σ when σ-only.
int mnerf_mlp_layers(const float* rays_o, const float* rays_d,
                     const float* view_dirs, const float* z_vals,
                     const float* nets, const long long* plan, float* ws,
                     long long ws_floats, int width, int n_emb_xyz,
                     int n_emb_dir, int sigma_only, long long n_rays,
                     int n_samples, float* rows, int device, void* stream) {
  if (n_samples < 1) return -2;
  if (n_emb_xyz < 0 || n_emb_xyz > MAX_NF || n_emb_dir < 0 ||
      n_emb_dir > MAX_NF)
    return -3;
  if (width < 128 || width % 128) return -4;
  if (n_rays < 1) return -6;
  const long long chunk = plan[H_ROWS];
  const int n_gemms = (int)plan[H_GEMMS];
  if (n_gemms < 1 || n_gemms > MAX_GEMMS || plan[H_KT_X] < 1 ||
      (!sigma_only && plan[H_KT_V] < 1) || plan[H_H] < 0 ||
      (!sigma_only && plan[H_C] < 0) || chunk % BM)
    return -7;
  if (chunk < BM) return -8;
  if (plan[H_WS] > ws_floats) return -9;
  Gemm gemms[MAX_GEMMS];
  for (int i = 0; i < n_gemms; ++i) {
    const long long* p = plan + HEADER + (long long)REC * i;
    Gemm& g = gemms[i];
    g.b = p[G_B];
    g.n_tiles = (int)p[G_NT];
    g.k_tiles = (int)p[G_KT];
    g.nseg = (int)p[G_NSEG];
    g.nrange = (int)p[G_NRANGE];
    if (g.n_tiles < 1 || g.k_tiles < 1 || g.nseg < 1 || g.nseg > MAX_SEGS ||
        g.nrange < 1 || g.nrange > MAX_RANGES)
      return -7;
    int kt = 0;
    for (int s = 0; s < MAX_SEGS; ++s) {
      g.a[s] = p[G_SEG + 2 * s];
      g.a_kt[s] = s < g.nseg ? (int)p[G_SEG + 2 * s + 1] : 0;
      kt += g.a_kt[s];
    }
    if (kt != g.k_tiles) return -7;
    for (int r = 0; r < MAX_RANGES; ++r) {
      const long long* q = p + G_RANGE + R_FIELDS * r;
      Range& R = g.r[r];
      R = Range{(int)q[0], (int)q[1], (int)q[2], (int)q[3], q[4], q[5],
                (int)q[6], q[7]};
      if (r < g.nrange && (R.n0 % BN || R.n % 64 || R.n < 64 ||
                           (R.split_kt && R.n % BN)))
        return -7;
    }
  }
  Finish f;
  f.h = plan[H_H];
  f.c = plan[H_C];
  f.n0 = plan[H_N0];
  f.m0 = plan[H_M0];
  f.sw = plan[H_SW];
  f.sb = plan[H_SB];
  f.rw = plan[H_RW];
  f.rb = plan[H_RB];
  f.n1w = plan[H_N1W];
  f.n1b = plan[H_N1B];
  f.m1w = plan[H_M1W];
  f.m1b = plan[H_M1B];
  f.width = width;

  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  cudaError_t e;
  if (!sm_count[device]) {
    e = cudaDeviceGetAttribute(&sm_count[device],
                               cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  if (!smem_set[device]) {
    e = cudaFuncSetAttribute(gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_total = n_rays * n_samples;
  const int pe = 3 * (1 + 2 * n_emb_xyz), dpe = 3 * (1 + 2 * n_emb_dir);
  const int kt_x = (int)plan[H_KT_X], kt_v = sigma_only ? 0 : (int)plan[H_KT_V];
  for (long long start = 0; start < n_total; start += chunk) {
    const int n = (int)(n_total - start < chunk ? n_total - start : chunk);
    const int m_tiles = (n + BM - 1) / BM;
    const long long pe_elems = (long long)m_tiles * BM * (kt_x + kt_v) * KT;
    const int pe_blocks =
        (int)((pe_elems + 255) / 256 < 8 * sm_count[device]
                  ? (pe_elems + 255) / 256
                  : 8 * sm_count[device]);
    posenc_kernel<<<pe_blocks, 256, 0, s>>>(
        rays_o, rays_d, view_dirs, z_vals, start, n_total, n_samples,
        m_tiles * BM, pe, kt_x, plan[H_PE_X], dpe, kt_v, plan[H_PE_V], ws);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int i = 0; i < n_gemms; ++i) {
      const int tiles = m_tiles * gemms[i].n_tiles;
      gemm_kernel<<<tiles < sm_count[device] ? tiles : sm_count[device],
                    THREADS, SMEM, s>>>(nets, ws, gemms[i], m_tiles);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    finish_kernel<<<(n + 7) / 8, 256, 0, s>>>(
        nets, ws, f, sigma_only, n, rows + start * (sigma_only ? 1 : NROW));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
