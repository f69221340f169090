// Fused flagship PE-MLP field + per-ray alpha compositing, one kernel
// (sm_90a).
//
// It replaces the Pallas TPU kernel `_kernel` of
// mirror_nerf_tpu/ops/pallas/fused_mlp_t.py:276 (driven by fused_t_forward:352,
// σ-only at :384, full at :393; adapter fused_t_rays_eval:418), in both its
// variants. It computes the same function, not the same layout: the TPU
// kernel's transposed lanes, its `E @ x3` posenc matmul with the hi/lo bf16
// split, the roll scan, the SUM-matrix composite and the packed 8-row output
// answered TPU limits and are gone. The per-sample rows of the same trunk
// (the σ-noise passes, the point queries) are csrc/fused_mlp_rows_tc.cu's,
// which computes them bit for bit as this kernel's rows mode did before
// that mode was retired.
//
// For each sample i of each ray (o, d, view dir v, sorted depths z):
//   x = o + d·z (a rounded multiply, then a rounded add: no FMA contraction)
//   pe = [x, sin(f·x), sin(f·x + π/2)] for f = 2^0..2^(F-1) (3·(1 + 2F)
//     rows, 63 at the default F = 10), sinf with full range reduction
//     (arguments reach ~4096 rad)
//   trunk: 8 × (Linear 256 + ReLU); layer 0 reads pe, layer 4 reads [pe, h]
//   σ = h·w_σ + b_σ;  sd = δ·act(σ), δ = z_{i+1} − z_i, 1e10 on the last
//   w_i = exp(−Σ_{j<i} sd_j)·(1 − exp(−sd_i)), the prefix EXCLUSIVE (never
//     inclusive-minus-self: that cancels against δ_inf = 1e10)
//   σ-only variant: stops at w. Full variant, per sample:
//     rgb = sigmoid(relu([h W_xf + b_xf, posenc(v)] W_d + b_d) W_rgb + b_rgb)
//     n = (h W_n0 + b_n0) W_n1 + b_n1, normalized by rsqrt(max(|n|², ε_f32))
//     m = sigmoid(leaky_0.01(h W_m0 + b_m0) W_m1 + b_m1)
//   and per ray Σw, Σw·rgb, Σw·n, Σw·m, Σw·z.
// The normal and mirror heads are optional (template flags, as the TPU
// kernel's packing takes them); a missing head's per-ray sums are 0. The
// posenc frequencies (F ≤ 20 for x, likewise for v: at most 123 rows, the
// TPU kernel's 128-lane limit) are arguments.
//
// What bounds it on the H100: the products. A sample costs 659,456 multiply-
// adds (full; 491,264 σ-only) against 4 B of depth in and 4 B of weight out.
// The first design ran them on the fp32 CUDA cores at 53 % of that peak
// (78.5 ms at S = 128 full on 16384 rays, H100 80GB HBM3 at 700 W), and no
// CUDA-core design goes below its 41.3 ms bound. This design runs every
// product of the trunk and of the 256→256, 283→128 and 256→128 heads on the
// tensor cores with `wgmma`, in 3×TF32 at fp32 accuracy (bound: 3 × the
// products over the 495 TFLOP/s TF32 peak, 16.8 ms there):
//   * a CTA owns whole rays, up to 256 samples (rays_per_block = 256 / S),
//     and walks them in passes of 128 samples: two consumer warpgroups of
//     64 rows each (`wgmma` m64n64k8) and one producer warpgroup, of which
//     one thread issues the weight copies (`setmaxnreg`: 40 registers for
//     it, 232 for the consumers);
//   * every product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the small terms
//     first; hi and lo are `cvt.rna.tf32.f32` (lo of x − hi). A (the
//     activations) comes from registers and is split at its use, B (the
//     weights) from shared memory, split by the wrapper;
//   * the tensor cores' fp32 sums truncate toward zero: summed over a whole
//     256-row layer (96 wgmma into one accumulator) they biased raw σ by
//     −1e-6 of its scale against a float64 plain version (the fp32 plain
//     version: +2e-9) and moved a depth of the σ-noise flagship view by
//     2.3e-3 against the plain version (bar 1e-3). So a tensor-core sum
//     spans two k-steps and 64 columns (wgmma m64n64k8, the chunk's small
//     products first), and each thread adds the chunks into its fp32 layer
//     output on the CUDA cores (`gemm`): σ's bias −1.4e-8;
//   * a layer's accumulator fragment is the next layer's A fragment: a lane
//     holds C columns 2t, 2t+1 of each 8-column tile, which it feeds as A
//     columns t, t+4, so the wrapper (ops/fused_mlp_t.py `_pack`) stores the
//     K rows of each weight fed by a hidden layer in that order
//     (ops/fused_cp.py `c_order`). Between layers each thread parks its own
//     fragments in its own 512 B of shared memory (64 KB a warpgroup: 64
//     rows × 256 columns), read back one float4 a k-step: no barrier, no
//     exchange between threads;
//   * posenc rows are computed where they enter a product (layer 0, the
//     skip layer 4, and posenc(v) in the color layer), each thread its own
//     A fragment elements, in fp32 `sinf` with the `__fadd_rn` phase. The
//     raw position rows 0–2 enter as 3×TF32 like every other operand:
//     never through a single TF32 product;
//   * the weights (5.3 MB as TF32 hi/lo planes) do not fit in shared memory
//     and every pass streams all of them from L2: a ring of 5 stages of one
//     k-step each (8 K rows × N × hi and lo, 16 KB at N = 256), each stage
//     laid out as the `wgmma` descriptor reads it (K-major, 32-byte swizzle:
//     a stage is one 8-row k-step, so a finer swizzle than 128 B keeps the
//     ring inside the 80 KB beside the 128 KB of activations). The wrapper
//     packs the stages in stream order, so a 1-D bulk copy (`cp.async.bulk`,
//     no tensor map) places each ready; an `mbarrier` transaction count says
//     it has arrived;
//   * the CTAs run in clusters of 2: each copies one plane of a stage (hi or
//     lo) and multicasts it to both, so a stage leaves L2 once for 256
//     samples; a stage is refilled when the four consumer warpgroups of the
//     cluster have released it;
//   * the heads' 256/128 → 3/1 dot products (σ, rgb, normal, mirror) read
//     the accumulators through quad shuffles in fp32; bias, ReLU, leaky
//     ReLU, sigmoid, softplus and the normal's norm run in fp32 on the
//     fragment registers;
//   * per-sample sd, rgb, n, m of the block's rays collect in shared memory;
//     one thread per ray then runs the exclusive prefix and the sums in
//     sample order.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6, row 4):
// 26.0 ms at S = 128 full on 16384 rays (76.8 before, in the same process),
// 9.1 ms σ-only at S = 64 (28.9): 64–69 % of the 3×TF32 bound. What bounds
// it now (tools/exp_mlp_diag.py): one TF32 product in place of three takes
// 32 % less time, no weight loads 2 % less, no multicast none: the tensor
// pipe and the work between its chunks (waits, fp32 adds; whole-layer
// tensor-core sums are 5 % faster, one-k-step chunks 11 % slower), not L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 rows each
constexpr int CLUSTER = 2;         // CTAs that share each weight stage
constexpr int STAGES = 5;          // weight ring depth, one k-step a stage
constexpr int PROMOTE = 2;         // k-steps a tensor-core sum spans
constexpr int PART = 64;           // columns a tensor-core sum spans
constexpr int PASS = 64 * CONSUMERS;       // samples a pass
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer's
constexpr int MAXS = 256;          // samples per block
constexpr int W = 256;             // trunk width
constexpr int WH = 128;            // head width
constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int MAX_NF = 20;                 // posenc frequencies, x or v
constexpr int NOUT = 9;  // opacity, rgb(3), normal(3), mirror, depth
constexpr int MAX_LAYERS = DEPTH + 4;      // trunk, n0, m0, xf, dir
constexpr int STAGE_BYTES = 2 * 8 * W * 4;        // hi + lo, 8 K rows
constexpr int ACT_BYTES = (W / 8) * 128 * 16;     // a warpgroup's fragments
constexpr int IO = 8;    // floats a row of the pass's inputs: x, v, δ
constexpr float HALF_PI = 1.57079637f;     // fp32(π/2), as the JAX phase

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

// rows of a 3-d posenc with n_freqs frequencies
__host__ __device__ constexpr int posenc_rows(int n_freqs) {
  return 3 * (1 + 2 * n_freqs);
}

// The packed buffer (ops/fused_mlp_t.py `_pack` writes exactly this):
// first the weight stream, every layer a product runs, in the order the
// kernel runs them (trunk 0..7, then n0, m0 where the field has them, xf,
// dir); a layer of K (padded to 8) rows and N columns is K/8 stages of 16·N
// floats, [hi plane, lo plane], a plane N rows of 8 TF32 values, K-major in
// the 32-byte swizzle. Then the fp32 leaves the CUDA cores read, each
// padded to 4 floats: the trunk's biases, σ's weight and bias, xf's, dir's
// and the heads' biases, the 128→3/1 heads' weights.
struct Nets {
  int nl;                          // layers of the stream (full variant)
  int off[MAX_LAYERS], ks[MAX_LAYERS], n[MAX_LAYERS];  // float offset,
                                   // k-steps, N of each streamed layer
  int trunk_end;                   // floats of the trunk's stream
  int tb[DEPTH], sw, sb, xb, db, rw, rb;
  int n0b, n1w, n1b, m0b, m1w, m1b;
  int total;
};

// input rows of trunk layer i (padded), for pe8 posenc rows padded to 8
__host__ __device__ constexpr int trunk_in(int i, int pe8) {
  return i == 0 ? pe8 : (i == SKIP ? pe8 + W : W);
}

Nets net_offsets(int pe, int dpe, bool has_n, bool has_m) {
  Nets o{};
  o.n0b = o.n1w = o.n1b = o.m0b = o.m1w = o.m1b = -1;
  int p = 0;
  auto layer = [&](int k, int n) {
    o.off[o.nl] = p;
    o.ks[o.nl] = k / 8;
    o.n[o.nl] = n;
    ++o.nl;
    p += 2 * k * n;
  };
  for (int i = 0; i < DEPTH; ++i) layer(trunk_in(i, pad8(pe)), W);
  o.trunk_end = p;
  if (has_n) layer(W, WH);
  if (has_m) layer(W, WH);
  layer(W, W);                   // xf
  layer(W + pad8(dpe), WH);      // dir: [xf, posenc(v)]
  auto take = [&p](int n) { const int at = p; p += pad4(n); return at; };
  for (int i = 0; i < DEPTH; ++i) o.tb[i] = take(W);
  o.sw = take(W);
  o.sb = take(1);
  o.xb = take(W);
  o.db = take(WH);
  o.rw = take(WH * 3);
  o.rb = take(3);
  if (has_n) {
    o.n0b = take(WH);
    o.n1w = take(WH * 3);
    o.n1b = take(3);
  }
  if (has_m) {
    o.m0b = take(WH);
    o.m1w = take(WH);
    o.m1b = take(1);
  }
  o.total = p;
  return o;
}

// Shared memory (bytes from a 1024-aligned base): the weight ring, each
// consumer warpgroup's parked fragments, the pass's sample inputs (x, v, δ
// of each row), the per-sample results of the block's rays, the ring's
// barriers.
struct Smem {
  int ring, act, io, sd, rgb, nrm, mir, full, empty, total;
};

__host__ __device__ constexpr Smem smem_layout(bool sigma_only) {
  Smem l{};
  l.ring = 0;
  l.act = l.ring + STAGES * STAGE_BYTES;
  l.io = l.act + CONSUMERS * ACT_BYTES;
  l.sd = l.io + 4 * IO * PASS;
  l.rgb = l.sd + 4 * MAXS;
  l.nrm = l.rgb + (sigma_only ? 0 : 4 * 3 * MAXS);
  l.mir = l.nrm + (sigma_only ? 0 : 4 * 3 * MAXS);
  l.full = l.mir + (sigma_only ? 0 : 4 * MAXS);
  l.empty = l.full + 8 * STAGES;
  l.total = l.empty + 8 * STAGES;
  return l;
}
// + 1024: the dynamic window is aligned up to 1024 B in the kernel
static_assert(smem_layout(false).total + 1024 <= 232448, "shared memory");

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- the cluster (mbarriers, wgmma fences: csrc/sm90.cuh) -----------------

// arrive on the barrier at the same offset in every CTA of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
#pragma unroll
  for (int c = 0; c < CLUSTER; ++c) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(bar), "r"(c));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote)
                 : "memory");
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// `bytes` from global `src` to shared `dst` of every CTA of the cluster
// (the same offset in each), completing on `bar` in each
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  if (CLUSTER == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  } else {
    const uint16_t mask = (1u << CLUSTER) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src),
        "r"(bytes), "r"(bar), "h"(mask) : "memory");
  }
}

// ---- 3×TF32 on wgmma -------------------------------------------------------

// A fragment (this thread's 4 values), split: hi and lo as TF32
struct AFrag {
  uint32_t hi[4], lo[4];
};

// x = hi + lo, each rounded to TF32. The cvts are volatile, so that they
// stay after the wgmma_wait_all that frees the registers they write (an
// in-flight wgmma reads its A registers until the wait that retires it).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void split(const float4 a, AFrag& f) {
  tf32_split(a.x, f.hi[0], f.lo[0]);
  tf32_split(a.y, f.hi[1], f.lo[1]);
  tf32_split(a.z, f.hi[2], f.lo[2]);
  tf32_split(a.w, f.hi[3], f.lo[3]);
}

// Descriptor of an N × 8 K-major TF32 plane at shared address `addr`
// (256-B aligned): 32-byte swizzle (layout 3), rows 32 B apart, 8-row groups
// (SBO) 256 B apart; LBO is not read in a swizzled K-major layout.
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(float (&d)[PART / 2]) {
#pragma unroll
  for (int i = 0; i < PART / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A·B, m64n64k8 TF32: A from registers, B by descriptor; d is
// overwritten when `scale` is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[PART / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
}

// The consumer's view of the weight ring: stage and phase advance in the
// order the producer fills it, the same for every consumer warpgroup.
struct Ring {
  uint32_t base, full, empty;
  int stage, phase;
};

// s += A·B over NK k-steps from kt (a chunk): the tensor cores sum the
// chunk a PART of the columns at a time, its small products first, into d;
// each thread adds d into its fp32 s on the CUDA cores. The chunk's A is
// split once for all parts; it is rewritten (the next chunk) only after the
// wait that retires its last products, since an in-flight wgmma reads its
// A registers until then. Its stages are released when they are done.
template <int N, int NK, class AOf>
__device__ __forceinline__ void chunk(float (&s)[128], const int kt,
                                      AOf&& a_of, Ring& r,
                                      const bool signal) {
  AFrag f[NK];
  uint64_t desc[NK];
  int stage[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split(a_of(kt + j), f[j]);
    mbar_wait(r.full + 8 * r.stage, r.phase);
    stage[j] = r.stage;
    desc[j] = plane_desc(r.base + r.stage * STAGE_BYTES);
    if (++r.stage == STAGES) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  float d[PART / 2];
#pragma unroll
  for (int q = 0; q < N / PART; ++q) {
    // part q: B rows 64q … 64q + 63 of each plane (2 KB apart)
    const uint64_t at = (q * PART * 32) >> 4, lo = (N * 32) >> 4;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      wgmma_n64(d, f[j].lo, desc[j] + at, j > 0);
      wgmma_n64(d, f[j].hi, desc[j] + lo + at, 1);
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) wgmma_n64(d, f[j].hi, desc[j] + at, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
#pragma unroll
    for (int i = 0; i < PART / 2; ++i) s[q * PART / 2 + i] += d[i];
  }
  if (signal) {
#pragma unroll
    for (int j = 0; j < NK; ++j) mbar_arrive_cluster(r.empty + 8 * stage[j]);
  }
}

// s = A·B for one streamed layer of `ksteps` k-steps: A's fp32 fragment for
// k-step kt from `a_of(kt)` (this thread's rows g, g+8 of columns t, t+4),
// B from the ring, s (this thread's C fragments of all N columns) summed in
// fp32 on the CUDA cores. The tensor cores' fp32 sums truncate toward zero
// (a bias of ~½ ulp of the running sum each wgmma), so they sum only
// PROMOTE k-steps of a PART of the columns at a time: each truncation is
// then ~½ ulp of a chunk's share of the output, and s takes the chunks
// with rounded adds.
template <int N, class AOf>
__device__ __forceinline__ void gemm(float (&s)[128], const int ksteps,
                                     AOf&& a_of, Ring& r, const bool signal) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  int kt = 0;
  for (; kt + PROMOTE <= ksteps; kt += PROMOTE)
    chunk<N, PROMOTE>(s, kt, a_of, r, signal);
  for (; kt < ksteps; ++kt) chunk<N, 1>(s, kt, a_of, r, signal);
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.f);
  if (ACT == ACT_LEAKY) return y >= 0.f ? y : 0.01f * y;
  return y;
}

// act(d + b) parked as the next layer's A fragments: k-tile j of this
// thread at act[j·128 + lane of the warpgroup], (row g col 2t, row g+8 col
// 2t, row g col 2t+1, row g+8 col 2t+1)
template <int N, int ACT>
__device__ __forceinline__ void park(const float (&d)[128],
                                     const float* __restrict__ bias,
                                     float4* act, const int wtid) {
  const int t = wtid & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j) + t);
    act[j * 128 + wtid] = make_float4(
        activate<ACT>(d[4 * j] + b.x), activate<ACT>(d[4 * j + 2] + b.x),
        activate<ACT>(d[4 * j + 1] + b.y), activate<ACT>(d[4 * j + 3] + b.y));
  }
}

// A 128/256 → NO head on act(d + b): y[h][o] for this thread's rows g
// (h = 0) and g+8 (h = 1), summed over the quad by shuffles (all four lanes
// hold it), plus the head's bias.
template <int N, int ACT, int NO>
__device__ __forceinline__ void head(const float (&d)[128],
                                     const float* __restrict__ bias,
                                     const float* __restrict__ w,
                                     const float* __restrict__ wb,
                                     const int t, float (&y)[2][NO]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) y[h][o] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t + c;
      const float b = __ldg(bias + n);
      const float h0 = activate<ACT>(d[4 * j + c] + b);
      const float h1 = activate<ACT>(d[4 * j + 2 + c] + b);
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const float wv = __ldg(w + n * NO + o);
        y[0][o] = fmaf(h0, wv, y[0][o]);
        y[1][o] = fmaf(h1, wv, y[1][o]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 1);
      y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 2);
      y[h][o] += __ldg(wb + o);
    }
}

// posenc row r (< rows; 0 past them, the padding) of one coordinate
// triple: r < 3 the raw value, then per frequency band a sin block and a
// cos block of 3 rows each.
__device__ __forceinline__ float posenc_row(float c0, float c1, float c2,
                                            const int r, const int rows) {
  if (r >= rows) return 0.f;
  const int a = r < 3 ? r : (r - 3) % 3;
  const float v = a == 0 ? c0 : (a == 1 ? c1 : c2);
  if (r < 3) return v;
  const int j = r - 3;
  const int band = j / 6, within = j % 6;
  const float f = (float)(1 << band);
  // f·x is exact (f = 2^band); the phase add rounds as the JAX x @ M + phase
  const float fx = __fmul_rn(f, v);
  return sinf(within < 3 ? fx : __fadd_rn(fx, HALF_PI));
}

// k-tile kt of a posenc as this thread's A fragment: rows g, g+8 (the two
// coordinate triples a and b, in shared memory) of posenc rows 8kt + t and
// 8kt + t + 4
__device__ __forceinline__ float4 posenc_frag(const float* a, const float* b,
                                              const int rows, const int kt,
                                              const int t) {
  const int r0 = 8 * kt + t, r1 = r0 + 4;
  return make_float4(posenc_row(a[0], a[1], a[2], r0, rows),
                     posenc_row(b[0], b[1], b[2], r0, rows),
                     posenc_row(a[0], a[1], a[2], r1, rows),
                     posenc_row(b[0], b[1], b[2], r1, rows));
}

template <bool SIGMA_ONLY, bool SOFTPLUS, bool HAS_N, bool HAS_M>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, 1) mlp_field_kernel(
        const float* __restrict__ rays_o, const float* __restrict__ rays_d,
        const float* __restrict__ view_dirs,
        const float* __restrict__ z_vals, const float* __restrict__ nets,
        const Nets no, const int pe, const int dpe, const int n_rays,
        const int n_samples, const int rays_per_block,
        float* __restrict__ weights, float* __restrict__ per_ray) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  constexpr Smem L = smem_layout(SIGMA_ONLY);
  const uint32_t base = smem_u32(smem);
  float* s_sd = reinterpret_cast<float*>(smem + L.sd);
  float* s_rgb = reinterpret_cast<float*>(smem + L.rgb);
  float* s_nrm = reinterpret_cast<float*>(smem + L.nrm);
  float* s_mir = reinterpret_cast<float*>(smem + L.mir);

  const long long ray0 = (long long)blockIdx.x * rays_per_block;
  const int n_here = (int)max(0LL, min((long long)rays_per_block,
                                       n_rays - ray0));
  const int nt = n_here * n_samples;  // samples this block holds
  // every CTA runs the same passes, so that a cluster streams in step
  const int npass = (rays_per_block * n_samples + PASS - 1) / PASS;
  const int nl = SIGMA_ONLY ? DEPTH : no.nl;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + L.full + 8 * s, 1);
      mbar_init(base + L.empty + 8 * s, CONSUMERS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid >= 128 * CONSUMERS) {
    // ---- producer: one thread streams the weights, pass after pass
    if (CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * CONSUMERS) {
      const uint32_t rank = CLUSTER == 1 ? 0 : cluster_rank();
      int stage = 0, phase = 0;
      for (int p = 0; p < npass; ++p) {
        for (int l = 0; l < nl; ++l) {
          const int bytes = 64 * no.n[l];         // one k-step, hi + lo
          const int part = bytes / CLUSTER;       // this CTA's share
          const char* src = reinterpret_cast<const char*>(nets + no.off[l]);
          for (int k = 0; k < no.ks[l]; ++k, src += bytes) {
            mbar_wait(base + L.empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(base + L.full + 8 * stage, bytes);
            bulk_copy(base + L.ring + stage * STAGE_BYTES + rank * part,
                      src + rank * part, part, base + L.full + 8 * stage);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the peer's copies into this CTA have all landed
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64·wg … 64·wg + 63 of a pass
  if (CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7, wtid = tid & 127;
  const int g = (wtid & 31) >> 2, t = wtid & 3;
  const int row0 = 64 * wg + 16 * (wtid >> 5) + g;  // and row0 + 8
  float4* act = reinterpret_cast<float4*>(smem + L.act + wg * ACT_BYTES);
  float* io0 = reinterpret_cast<float*>(smem + L.io) + IO * row0;
  float* io1 = io0 + 8 * IO;
  Ring ring{base + L.ring, base + L.full, base + L.empty, 0, 0};
  const bool signal = wtid == 0;
  const int pe8 = pad8(pe) / 8;  // posenc k-tiles
  const int dpe8 = pad8(dpe) / 8;
  float d[128];  // a layer's output, this thread's C fragments

  for (int p = 0; p < npass; ++p) {
    // this thread's two samples (rows row0, row0 + 8): x, v, δ, zeros past
    // the block's samples, kept in shared memory by the quad's first lane
    const int ts[2] = {p * PASS + row0, p * PASS + row0 + 8};
    __syncwarp();  // the quad has read the previous pass's inputs
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* in = h ? io1 : io0;
#pragma unroll
        for (int c = 0; c < IO; ++c) in[c] = 0.f;
        if (ts[h] < nt) {
          const long long ray = ray0 + ts[h] / n_samples;
          const int i = ts[h] % n_samples;
          const long long zi = ray * n_samples + i;
          const float z = z_vals[zi];
          in[6] = (i == n_samples - 1) ? 1e10f : z_vals[zi + 1] - z;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            in[a] = __fadd_rn(rays_o[ray * 3 + a],
                              __fmul_rn(rays_d[ray * 3 + a], z));
            if (!SIGMA_ONLY) in[3 + a] = view_dirs[ray * 3 + a];
          }
        }
      }
    }
    __syncwarp();
    auto from_act = [&](int kt) { return act[kt * 128 + wtid]; };
    auto pe_x = [&](int kt) { return posenc_frag(io0, io1, pe, kt, t); };

    // trunk: layer 0 on pe, layer 4 on [pe, h], the others on h
    gemm<W>(d, pe8, pe_x, ring, signal);
    for (int i = 1; i < DEPTH; ++i) {
      park<W, ACT_RELU>(d, nets + no.tb[i - 1], act, wtid);
      if (i == SKIP)
        gemm<W>(d, pe8 + W / 8, [&](int kt) {
          return kt < pe8 ? pe_x(kt) : from_act(kt - pe8);
        }, ring, signal);
      else
        gemm<W>(d, W / 8, from_act, ring, signal);
    }
    {
      float s[2][1];
      head<W, ACT_RELU, 1>(d, nets + no.tb[DEPTH - 1], nets + no.sw,
                           nets + no.sb, t, s);
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sg = s[h][0];
          const float a = SOFTPLUS
              ? fmaxf(sg, 0.f) + log1pf(expf(-fabsf(sg)))
              : fmaxf(sg, 0.f);
          s_sd[ts[h]] = (h ? io1 : io0)[6] * a;
        }
    }
    if (SIGMA_ONLY) continue;
    park<W, ACT_RELU>(d, nets + no.tb[DEPTH - 1], act, wtid);

    if (HAS_N) {  // normal: two linears, then normalized
      gemm<WH>(d, W / 8, from_act, ring, signal);
      float n[2][3];
      head<WH, ACT_NONE, 3>(d, nets + no.n0b, nets + no.n1w, nets + no.n1b,
                            t, n);
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float inv = rsqrtf(fmaxf(
              n[h][0] * n[h][0] + n[h][1] * n[h][1] + n[h][2] * n[h][2],
              1.1920929e-07f));
#pragma unroll
          for (int c = 0; c < 3; ++c)
            s_nrm[c * MAXS + ts[h]] = n[h][c] * inv;
        }
    }
    if (HAS_M) {  // mirror: leaky 0.01, then sigmoid
      gemm<WH>(d, W / 8, from_act, ring, signal);
      float m[2][1];
      head<WH, ACT_LEAKY, 1>(d, nets + no.m0b, nets + no.m1w, nets + no.m1b,
                             t, m);
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) s_mir[ts[h]] = sigmoidf(m[h][0]);
    }
    // color: xf (parked over h), then [xf, posenc(v)] → 128 relu → rgb
    gemm<W>(d, W / 8, from_act, ring, signal);
    park<W, ACT_NONE>(d, nets + no.xb, act, wtid);
    gemm<WH>(d, W / 8 + dpe8, [&](int kt) {
      return kt < W / 8 ? from_act(kt)
                        : posenc_frag(io0 + 3, io1 + 3, dpe, kt - W / 8, t);
    }, ring, signal);
    {
      float c3[2][3];
      head<WH, ACT_RELU, 3>(d, nets + no.db, nets + no.rw, nets + no.rb, t,
                            c3);
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            s_rgb[c * MAXS + ts[h]] = sigmoidf(c3[h][c]);
    }
  }
  // the consumers' per-sample results are complete
  asm volatile("bar.sync 1, %0;" ::"n"(128 * CONSUMERS) : "memory");

  if (tid < n_here) {
    // one thread per ray: the exclusive prefix and the per-ray sums, in
    // sample order. The prefix never holds a sample's own sd, so the 1e10
    // on the last sample cancels nothing.
    const long long ray = ray0 + tid;
    const float* sd = s_sd + tid * n_samples;
    float excl = 0.f;
    float acc[NOUT] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n_samples; ++i) {
      const float w = expf(-excl) * (1.f - expf(-sd[i]));
      excl += sd[i];
      weights[ray * n_samples + i] = w;
      if (!SIGMA_ONLY) {
        const int ti = tid * n_samples + i;
        acc[0] += w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[1 + c] += w * s_rgb[c * MAXS + ti];
          if (HAS_N) acc[4 + c] += w * s_nrm[c * MAXS + ti];
        }
        if (HAS_M) acc[7] += w * s_mir[ti];
        acc[8] += w * z_vals[ray * n_samples + i];
      }
    }
    if (!SIGMA_ONLY) {
#pragma unroll
      for (int k = 0; k < NOUT; ++k) per_ray[ray * NOUT + k] = acc[k];
    }
  }
  cluster_sync();  // no CTA leaves while its peer may still signal it
}

struct Args {
  const float *rays_o, *rays_d, *view_dirs, *z_vals, *nets;
  Nets no;
  int pe, dpe, n_rays, n_samples;
  float *weights, *per_ray;
};

template <bool SIGMA_ONLY, bool SOFTPLUS, bool HAS_N, bool HAS_M>
int launch(const Args& a, cudaStream_t stream) {
  const int rays_per_block = MAXS / a.n_samples;
  int grid = (a.n_rays + rays_per_block - 1) / rays_per_block;
  grid = (grid + CLUSTER - 1) / CLUSTER * CLUSTER;
  const int smem = smem_layout(SIGMA_ONLY).total + 1024;
  auto kern = mlp_field_kernel<SIGMA_ONLY, SOFTPLUS, HAS_N, HAS_M>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, THREADS, smem, stream>>>(
      a.rays_o, a.rays_d, a.view_dirs, a.z_vals, a.nets, a.no, a.pe, a.dpe,
      a.n_rays, a.n_samples, rays_per_block, a.weights, a.per_ray);
  return (int)cudaGetLastError();
}

// the σ-only variant reads no head; the full one one instance per head set
template <bool SOFTPLUS>
int launch_variant(const Args& a, bool sigma_only, bool has_n, bool has_m,
                   cudaStream_t stream) {
  if (sigma_only) return launch<true, SOFTPLUS, false, false>(a, stream);
  if (has_n && has_m) return launch<false, SOFTPLUS, true, true>(a, stream);
  if (has_n) return launch<false, SOFTPLUS, true, false>(a, stream);
  if (has_m) return launch<false, SOFTPLUS, false, true>(a, stream);
  return launch<false, SOFTPLUS, false, false>(a, stream);
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_mlp_t.py turns into a message:
//   -2 S outside [1, MAXS]   -3 a posenc frequency count outside
//   [0, MAX_NF]   -4 n_nets is not the layout's   -6 n_rays < 1
// All pointers are device pointers; view_dirs may be null for the σ-only
// variant. It writes weights (N, S) and, unless σ-only, per_ray (N, 9).
// nets holds every leaf of the
// field, heads included, whichever the variant, in the layout of
// `net_offsets` (16-B aligned). The entry takes the card's index (int) and
// a stream of that card last; the guard makes the card current for the
// launch (csrc/launch.cuh).
int mnerf_fused_mlp_t(const float* rays_o, const float* rays_d,
                      const float* view_dirs, const float* z_vals,
                      const float* nets, long long n_nets, int n_rays,
                      int n_samples, int n_emb_xyz, int n_emb_dir,
                      int has_normal, int has_mirror, int sigma_only,
                      int softplus, float* weights, float* per_ray,
                      int device,
                      void* stream) {
  if (n_samples < 1 || n_samples > MAXS) return -2;
  if (n_emb_xyz < 0 || n_emb_xyz > MAX_NF || n_emb_dir < 0 ||
      n_emb_dir > MAX_NF)
    return -3;
  const int pe = posenc_rows(n_emb_xyz), dpe = posenc_rows(n_emb_dir);
  const Args a{rays_o, rays_d, view_dirs, z_vals, nets,
               net_offsets(pe, dpe, has_normal, has_mirror), pe, dpe,
               n_rays, n_samples, weights, per_ray};
  if (n_nets != a.no.total) return -4;
  if (n_rays < 1) return -6;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  return softplus
      ? launch_variant<true>(a, sigma_only, has_normal, has_mirror, s)
      : launch_variant<false>(a, sigma_only, has_normal, has_mirror, s);
}

}  // extern "C"
