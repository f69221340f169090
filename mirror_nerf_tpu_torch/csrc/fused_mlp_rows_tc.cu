// The flagship PE-MLP field per sample for every trunk but the default one,
// on Hopper's tensor cores (sm_90a): 3×TF32 `wgmma` with the trunk's depth
// and skip set given at run time and its width a template parameter (128,
// 256, 384, 512).
//
// Replaces, for every `FusedSpec` the JAX adapters build with a width of at
// most 512 (`MirrorNeRFField.supports_fused_tc`: width 128, 256, 384 or 512,
// any depth, any skips, ≤ 20 posenc frequencies each, either head), the two
// per-sample Pallas TPU kernels of mirror_nerf_tpu/ops/pallas/fused_mlp.py:
// `_kernel_rays:238` (rays; fused_forward_rays:310, adapter
// fused_rays_eval:367) and `_kernel:223` (points; fused_forward:266, adapters
// fused_packed_eval:416, fused_field_eval:448). The default trunk keeps the
// tuned rows mode of csrc/fused_mlp_t.cu; wider trunks (640 and up) keep the
// fp32 kernel csrc/fused_mlp_rows.cu (ops/fused_mlp.py `rows_route`).
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
// 3×TF32 over the 495 TFLOP/s TF32 peak (65.2 ms for 16384 rays × 128
// samples at width 512, depth 8). The design is csrc/fused_mlp_t.cu's (see
// its header for the reasons), with the trunk read from a plan:
//   * a CTA is two consumer warpgroups and a producer warpgroup, of which
//     one thread issues the weight copies (`setmaxnreg` 40 / 232);
//   * every product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the small terms
//     first; hi and lo are `cvt.rna.tf32.f32` (lo of x − hi). A comes from
//     registers, split at its use; B from shared memory, split by the
//     wrapper. Posenc rows, the raw position rows 0–2 among them, enter as
//     3×TF32 like every other operand: never through one TF32 product;
//   * the tensor cores' fp32 sums truncate toward zero, so a tensor-core
//     sum spans at most two k-steps × 64 columns (one at W = 512) and each
//     thread adds the chunks into fp32 on the CUDA cores (`gemm`). Each
//     k-step's sum still truncates once, which shrinks a layer's output by
//     ~2e-8 of itself: raw σ leans by that times the depth, as in the tuned
//     kernel (PERF.md §6, PR 20);
//   * where the activations live. A thread holds its C fragments of all the
//     columns it computes, and parks them for the next layer in its own
//     slots of shared memory in the layout of its A fragments (the wrapper
//     orders the K rows fed by a hidden layer in `c_order`). At W ≤ 256 each
//     consumer warpgroup owns 64 samples (128 a pass) and every column: W/2
//     accumulators a thread, 64·W floats parked a warpgroup. At W = 384 and
//     512 that is 192 or 256 accumulators (the consumers have 232
//     registers) and 96 or 128 KB parked a warpgroup, so the two warpgroups
//     share 64 samples and split each layer's 64-column parts, part q to
//     warpgroup q mod 2: W/4 accumulators a thread, 64·W floats parked in
//     all (128 KB at 512), each warpgroup reading the other's parked half
//     for its next layer; a named barrier between the two before and after
//     each park. One CTA and split columns keep the exchange in shared
//     memory (no cluster-wide barrier between layers) at the price of half
//     the samples a weight stage serves (64 against 128);
//   * the weights do not fit in shared memory and every pass streams them
//     from L2: a ring of one-k-step stages (8 K rows × N × hi and lo; 3
//     stages at W = 512, 5 at 384 and 256, 10 at 128, beside the parked
//     activations), each laid out as the `wgmma` descriptor reads it
//     (K-major, 32-byte swizzle). The wrapper packs the stages in stream
//     order (ops/fused_mlp_t.py `_pack`) and writes a plan (`stream_plan`):
//     each streamed layer's offset, k-steps, N and bias, then the heads'
//     fp32 leaves; the depth and the skips are the plan's, the width the
//     template's. A 1-D bulk copy (`cp.async.bulk`) places each stage; the
//     CTAs run in clusters of 2, each copying half a stage and multicasting
//     it to both; an `mbarrier` transaction count says it has arrived;
//   * the 1- and 3-wide heads (σ, rgb, normal, mirror) are fp32 dots on the
//     CUDA cores from the accumulators, summed over a quad by shuffles; the
//     quad's four lanes then hold a row's [σ, rgb] or [normal, mirror] each
//     and write it as one 16-B store. With split columns each warpgroup sums
//     its own and the second hands its sums to the first through shared
//     memory at the end of the pass;
//   * persistent CTAs: as many clusters as the card holds at once, each CTA
//     walking passes blockIdx + i·gridDim; every CTA of a cluster runs the
//     same passes (zeros past the last sample), so that they stream in step.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23,
// PERF.md §6 rows 5g, 6g): 129.5 ms at width 512, depth 8 (16384 rays × S =
// 128, full; the fp32 kernel before it 486), 50 % of the 3×TF32 bound;
// 9.75 ms at width 128, depth 6 (39 %). What bounds it now
// (tools/exp_rows_tc_diag.py): one TF32 product in place of three takes 37 %
// less time, no weight loads 1 %: the tensor pipe and the waits between
// its chunks, as in the tuned kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int CLUSTER = 2;       // CTAs that share each weight stage
constexpr int PART = 64;         // columns a tensor-core sum spans
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer's
constexpr int MAX_NF = 20;       // posenc frequencies, x or v
constexpr int NROW = 8;          // σ, rgb (3), normal (3), mirror
constexpr int IO = 8;            // floats a row of the pass's inputs: x, v
constexpr int ALIGN = 256;       // a 32-byte-swizzled plane's alignment
constexpr float HALF_PI = 1.57079637f;  // fp32(π/2), as the JAX phase

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

// The plan (int64, ops/fused_mlp_t.py `stream_plan` writes it): per
// streamed layer, in stream order (trunk 0 … depth−1, then normal0 and
// mirror0 where the field has them, xyz_final, dir_enc), 4 entries:
// its float offset in the packed buffer, its k-steps, N, its bias's float
// offset; then the heads' fp32 leaves (−1 for a head the field lacks):
enum { P_SW = 0, P_SB, P_RW, P_RB, P_N1W, P_N1B, P_M1W, P_M1B };

__host__ __device__ constexpr int posenc_rows(int n_freqs) {
  return 3 * (1 + 2 * n_freqs);
}

// The shape of the instance of width W: how the warpgroups split the
// samples and the columns, and the shared memory (bytes from a 256-aligned
// base): the weight ring, the parked activations, the pass's inputs, the
// ring's barriers. The split warpgroups' head sums use the activations'
// first 2 KB at the end of a pass.
template <int W>
struct Cfg {
  static constexpr int NSPLIT = W > 256 ? 2 : 1;  // warpgroups on a sample
  static constexpr int ROWS = 64 * CONSUMERS / NSPLIT;  // samples a pass
  static constexpr int NPT = W / PART / NSPLIT;   // trunk parts a warpgroup
  static constexpr int NPH = (W / 2 / PART + NSPLIT - 1) / NSPLIT;  // heads'
  static constexpr int NT = NPT * PART / 2;       // accumulators a thread
  static constexpr int STAGE_BYTES = 64 * W;      // hi + lo, 8 K rows × W
  static constexpr int STAGES = W == 512 ? 3 : (W == 128 ? 10 : 5);
  // k-steps a tensor-core sum spans: one where the ring holds only three
  static constexpr int PROMOTE = W == 512 ? 1 : 2;
  static constexpr int RING = 0;
  static constexpr int ACT = RING + STAGES * STAGE_BYTES;
  static constexpr int IOS = ACT + ROWS * W * 4;
  static constexpr int FULL = IOS + ROWS * IO * 4;
  static constexpr int EMPTY = FULL + 8 * STAGES;
  static constexpr int SMEM = EMPTY + 8 * STAGES + ALIGN;
  static_assert(W % 128 == 0 && W >= 128 && W <= 512, "width");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(NSPLIT == 1 || ROWS * NROW * 4 <= ROWS * W * 4, "sums");
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.f);
  if (ACT == ACT_LEAKY) return y >= 0.f ? y : 0.01f * y;
  return y;
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
  const uint16_t mask = (1u << CLUSTER) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src),
      "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

// The two warpgroups that share a sample's columns (NSPLIT 2) meet here:
// before a park (both have read the parked inputs) and after it (both have
// parked their outputs). Named barrier 1, the 256 consumer threads.
template <int NSPLIT>
__device__ __forceinline__ void pair_sync() {
  if constexpr (NSPLIT == 2) asm volatile("bar.sync 1, 256;" ::: "memory");
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

// s += A·B over NK k-steps from kt (a chunk) for this warpgroup's parts of
// a layer of n columns: parts q = q0, q0 + NSPLIT, … (np of them, at most
// NP), local part lq in s[32·lq …]. The tensor cores sum the chunk a part
// at a time, its small products first, into d; each thread adds d into its
// fp32 s on the CUDA cores. The chunk's A is split once for all parts; it
// is rewritten (the next chunk) only after the wait that retires its last
// products. Its stages are released when they are done.
template <int W, int NP, int NK, class AOf>
__device__ __forceinline__ void chunk(float (&s)[Cfg<W>::NT], const int kt,
                                      AOf&& a_of, Ring& r, const bool signal,
                                      const int np, const int q0,
                                      const int n) {
  AFrag f[NK];
  uint64_t desc[NK];
  int stage[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    split(a_of(kt + j), f[j]);
    mbar_wait(r.full + 8 * r.stage, r.phase);
    stage[j] = r.stage;
    desc[j] = plane_desc(r.base + r.stage * Cfg<W>::STAGE_BYTES);
    if (++r.stage == Cfg<W>::STAGES) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  const uint64_t lo = (uint64_t)(n * 32) >> 4;  // the lo plane, 16-B units
  float d[PART / 2];
#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < np) {
      // part q: B rows 64q … 64q + 63 of each plane (2 KB apart)
      const uint64_t at =
          (uint64_t)((q0 + Cfg<W>::NSPLIT * lq) * PART * 32) >> 4;
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
      for (int i = 0; i < PART / 2; ++i) s[lq * PART / 2 + i] += d[i];
    }
  }
  if (signal) {
#pragma unroll
    for (int j = 0; j < NK; ++j) mbar_arrive_cluster(r.empty + 8 * stage[j]);
  }
}

// s = A·B for one streamed layer of `ksteps` k-steps and n columns: A's
// fp32 fragment for k-step kt from `a_of(kt)` (this thread's rows g, g+8
// of columns t, t+4), B from the ring, s (this thread's C fragments of its
// parts) summed in fp32 on the CUDA cores, PROMOTE k-steps of a part at a
// time on the tensor cores (1 at W = 512: with three stages a chunk of two
// held two of them until its end, and the ring ran dry; measured 11 %
// faster, tools/exp_rows_tc_diag.py).
template <int W, int NP, class AOf>
__device__ __forceinline__ void gemm(float (&s)[Cfg<W>::NT], const int ksteps,
                                     AOf&& a_of, Ring& r, const bool signal,
                                     const int np, const int q0,
                                     const int n) {
#pragma unroll
  for (int i = 0; i < NP * PART / 2; ++i) s[i] = 0.f;
  int kt = 0;
  constexpr int PROMOTE = Cfg<W>::PROMOTE;
  for (; kt + PROMOTE <= ksteps; kt += PROMOTE)
    chunk<W, NP, PROMOTE>(s, kt, a_of, r, signal, np, q0, n);
  for (; kt < ksteps; ++kt) chunk<W, NP, 1>(s, kt, a_of, r, signal, np, q0, n);
}

// act(d + b) of this warpgroup's trunk parts (a W-column layer) parked as
// the next layer's A fragments: k-tile j of this thread at act[j·128 + lane
// of the warpgroup], (row g col 2t, row g+8 col 2t, row g col 2t+1, row g+8
// col 2t+1) of the layer's columns 8j …
template <int W, int ACT>
__device__ __forceinline__ void park(const float (&d)[Cfg<W>::NT],
                                     const float* __restrict__ bias,
                                     float4* act, const int wtid,
                                     const int ch) {
  const int t = wtid & 3;
#pragma unroll
  for (int lq = 0; lq < Cfg<W>::NPT; ++lq) {
#pragma unroll
    for (int jj = 0; jj < PART / 8; ++jj) {
      const int j = (ch + Cfg<W>::NSPLIT * lq) * (PART / 8) + jj;
      const int e = lq * PART / 2 + 4 * jj;
      const float2 b =
          __ldg(reinterpret_cast<const float2*>(bias + 8 * j) + t);
      act[j * 128 + wtid] = make_float4(
          activate<ACT>(d[e] + b.x), activate<ACT>(d[e + 2] + b.x),
          activate<ACT>(d[e + 1] + b.y), activate<ACT>(d[e + 3] + b.y));
    }
  }
}

// A → NO head on act(d + b) over this warpgroup's parts (np of at most NP,
// part q = ch + NSPLIT·lq): y[h][o] for this thread's rows g (h = 0) and
// g+8 (h = 1), summed over the quad by shuffles (all four lanes hold it),
// without the head's bias.
template <int W, int NP, int ACT, int NO>
__device__ __forceinline__ void head(const float (&d)[Cfg<W>::NT],
                                     const float* __restrict__ bias,
                                     const float* __restrict__ w,
                                     const int t, const int np, const int ch,
                                     float (&y)[2][NO]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) y[h][o] = 0.f;
#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < np) {
      const int q = ch + Cfg<W>::NSPLIT * lq;
#pragma unroll
      for (int jj = 0; jj < PART / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = q * PART + 8 * jj + 2 * t + c;
          const float b = __ldg(bias + n);
          const float h0 = activate<ACT>(d[lq * PART / 2 + 4 * jj + c] + b);
          const float h1 =
              activate<ACT>(d[lq * PART / 2 + 4 * jj + 2 + c] + b);
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            const float wv = __ldg(w + n * NO + o);
            y[0][o] = fmaf(h0, wv, y[0][o]);
            y[1][o] = fmaf(h1, wv, y[1][o]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 1);
      y[h][o] += __shfl_xor_sync(0xffffffffu, y[h][o], 2);
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

// one of a head's two rows, the row of this lane's share (h is per lane)
template <int NO>
__device__ __forceinline__ float row_of(const float (&y)[2][NO], int h,
                                        int o) {
  return h ? y[1][o] : y[0][o];
}

template <int W>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(THREADS, 1) mlp_rows_tc_kernel(
        const float* __restrict__ rays_o, const float* __restrict__ rays_d,
        const float* __restrict__ view_dirs,
        const float* __restrict__ z_vals, const float* __restrict__ nets,
        const long long* __restrict__ plan, const int depth, const int pe,
        const int dpe, const int has_n, const int has_m,
        const int sigma_only, const long long n_total, const int n_samples,
        const int npass, float* __restrict__ rows) {
  using C = Cfg<W>;
  constexpr int NS = C::NSPLIT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + (((raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int nl_full = depth + has_n + has_m + 2;
  const int nl = sigma_only ? depth : nl_full;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(base + C::FULL + 8 * s, 1);
      mbar_init(base + C::EMPTY + 8 * s, CONSUMERS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid >= 128 * CONSUMERS) {
    // ---- producer: one thread streams the plan's layers, pass after pass
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * CONSUMERS) {
      const uint32_t rank = cluster_rank();
      int stage = 0, phase = 0;
      for (int p = 0; p < npass; ++p) {
        for (int l = 0; l < nl; ++l) {
          const long long off = __ldg(plan + 4 * l);
          const int ks = (int)__ldg(plan + 4 * l + 1);
          const int bytes = 64 * (int)__ldg(plan + 4 * l + 2);  // a k-step
          const int part = bytes / CLUSTER;       // this CTA's share
          const char* src = reinterpret_cast<const char*>(nets + off);
          for (int k = 0; k < ks; ++k, src += bytes) {
            mbar_wait(base + C::EMPTY + 8 * stage, phase ^ 1);
            mbar_expect_tx(base + C::FULL + 8 * stage, bytes);
            bulk_copy(base + C::RING + stage * C::STAGE_BYTES + rank * part,
                      src + rank * part, part, base + C::FULL + 8 * stage);
            if (++stage == C::STAGES) {
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

  // ---- consumers: warpgroup wg computes columns part q ≡ ch (mod NS) of
  // the 64 samples of block rb of a pass
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7, wtid = tid & 127;
  const int g = (wtid & 31) >> 2, t = wtid & 3;
  const int ch = wg % NS, rb = wg / NS;
  const int r0 = 16 * (wtid >> 5) + g;  // this thread's rows r0, r0 + 8
  float4* act = reinterpret_cast<float4*>(smem + C::ACT) + rb * (W / 8) * 128;
  float* io0 = reinterpret_cast<float*>(smem + C::IOS) + (64 * rb + r0) * IO;
  float* io1 = io0 + 8 * IO;
  Ring ring{base + C::RING, base + C::FULL, base + C::EMPTY, 0, 0};
  const bool signal = wtid == 0;
  const int nph = (W / 2 / PART - ch + NS - 1) / NS;  // this wg's head parts
  const long long* heads = plan + 4 * nl_full;
  // a streamed layer's k-steps and bias, as the producer reads them: the
  // ring stays in step whatever the plan holds
  auto ks_of = [=](int l) { return (int)__ldg(plan + 4 * l + 1); };
  auto bias_of = [=](int l) { return nets + __ldg(plan + 4 * l + 3); };
  // this lane's share of the output: row r0 + 8h, columns 4·half … + 3
  // ([σ, rgb] or [normal, mirror])
  const int h = t >> 1, half = t & 1;
  float d[C::NT];

  for (int p = 0; p < npass; ++p) {
    const long long s0 =
        ((long long)p * gridDim.x + blockIdx.x) * C::ROWS + 64 * rb;
    const long long ts0 = s0 + r0;  // and ts0 + 8
    pair_sync<NS>();  // the previous pass has read its inputs and sums
    __syncwarp();     // the quad has read the previous pass's inputs
    if (ch == 0 && t == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* in = k ? io1 : io0;
        const long long ts = ts0 + 8 * k;
#pragma unroll
        for (int c = 0; c < IO; ++c) in[c] = 0.f;
        if (ts < n_total) {
          const long long ray = ts / n_samples;
          const float z = z_vals[ts];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            in[a] = __fadd_rn(rays_o[ray * 3 + a],
                              __fmul_rn(rays_d[ray * 3 + a], z));
            if (!sigma_only) in[3 + a] = view_dirs[ray * 3 + a];
          }
        }
      }
    }
    __syncwarp();
    pair_sync<NS>();  // the inputs are written
    auto from_act = [=](int kt) { return act[kt * 128 + wtid]; };
    auto pe_x = [=](int kt) { return posenc_frag(io0, io1, pe, kt, t); };

    // trunk: layer 0 on pe, a skip layer (more k-steps than W/8) on
    // [pe, h], the others on h
    gemm<W, C::NPT>(d, ks_of(0), pe_x, ring, signal, C::NPT, ch, W);
    for (int i = 1; i < depth; ++i) {
      pair_sync<NS>();
      park<W, ACT_RELU>(d, bias_of(i - 1), act, wtid, ch);
      pair_sync<NS>();
      const int ks = ks_of(i);
      const int pk = ks - W / 8;  // posenc k-steps first
      if (pk > 0)
        gemm<W, C::NPT>(d, ks, [=](int kt) {
          return kt < pk ? pe_x(kt) : from_act(kt - pk);
        }, ring, signal, C::NPT, ch, W);
      else
        gemm<W, C::NPT>(d, ks, from_act, ring, signal, C::NPT, ch, W);
    }
    const float* last_b = bias_of(depth - 1);
    float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
    {
      float y[2][1];
      head<W, C::NPT, ACT_RELU, 1>(d, last_b, nets + __ldg(heads + P_SW), t,
                                   C::NPT, ch, y);
      mine.x = row_of(y, h, 0);
    }
    if (!sigma_only) {
      pair_sync<NS>();
      park<W, ACT_RELU>(d, last_b, act, wtid, ch);
      pair_sync<NS>();
      int l = depth;  // the next streamed layer
      if (has_n) {  // normal: two linears, normalized at the end
        gemm<W, C::NPH>(d, ks_of(l), from_act, ring, signal, nph, ch,
                        W / 2);
        float y[2][3];
        head<W, C::NPH, ACT_NONE, 3>(d, bias_of(l),
                                     nets + __ldg(heads + P_N1W), t, nph, ch,
                                     y);
        if (half) {
          mine.x = row_of(y, h, 0);
          mine.y = row_of(y, h, 1);
          mine.z = row_of(y, h, 2);
        }
        ++l;
      }
      if (has_m) {  // mirror: leaky 0.01, sigmoid at the end
        gemm<W, C::NPH>(d, ks_of(l), from_act, ring, signal, nph, ch,
                        W / 2);
        float y[2][1];
        head<W, C::NPH, ACT_LEAKY, 1>(d, bias_of(l),
                                      nets + __ldg(heads + P_M1W), t, nph,
                                      ch, y);
        if (half) mine.w = row_of(y, h, 0);
        ++l;
      }
      // color: xf (parked over h), then [xf, posenc(v)] → W/2 relu → rgb
      gemm<W, C::NPT>(d, ks_of(l), from_act, ring, signal, C::NPT, ch, W);
      pair_sync<NS>();
      park<W, ACT_NONE>(d, bias_of(l), act, wtid, ch);
      pair_sync<NS>();
      ++l;
      gemm<W, C::NPH>(d, ks_of(l), [=](int kt) {
        return kt < W / 8
                   ? from_act(kt)
                   : posenc_frag(io0 + 3, io1 + 3, dpe, kt - W / 8, t);
      }, ring, signal, nph, ch, W / 2);
      float y[2][3];
      head<W, C::NPH, ACT_RELU, 3>(d, bias_of(l), nets + __ldg(heads + P_RW),
                                   t, nph, ch, y);
      if (!half) {
        mine.y = row_of(y, h, 0);
        mine.z = row_of(y, h, 1);
        mine.w = row_of(y, h, 2);
      }
    }
    if constexpr (NS == 2) {
      // the second warpgroup's sums join the first's, through the parked
      // activations' first 2 KB (no layer reads them any more)
      float4* slot = reinterpret_cast<float4*>(smem + C::ACT) +
                     2 * (r0 + 8 * h) + half;
      pair_sync<NS>();
      if (ch == 1) *slot = mine;
      pair_sync<NS>();
      if (ch == 1) continue;
      const float4 o = *slot;
      mine.x += o.x;
      mine.y += o.y;
      mine.z += o.z;
      mine.w += o.w;
    }
    // the biases, the activations, the unit normal; one 16-B store a lane
    const long long s = ts0 + 8 * h;
    if (s >= n_total) continue;
    if (sigma_only) {
      if (!half) rows[s] = mine.x + __ldg(nets + __ldg(heads + P_SB));
      continue;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!half) {
      const float* rb3 = nets + __ldg(heads + P_RB);
      v.x = mine.x + __ldg(nets + __ldg(heads + P_SB));
      v.y = sigmoidf(mine.y + __ldg(rb3));
      v.z = sigmoidf(mine.z + __ldg(rb3 + 1));
      v.w = sigmoidf(mine.w + __ldg(rb3 + 2));
    } else {
      if (has_n) {
        const float* nb = nets + __ldg(heads + P_N1B);
        const float n0 = mine.x + __ldg(nb), n1 = mine.y + __ldg(nb + 1),
                    n2 = mine.z + __ldg(nb + 2);
        const float inv =
            rsqrtf(fmaxf(n0 * n0 + n1 * n1 + n2 * n2, 1.1920929e-07f));
        v.x = n0 * inv;
        v.y = n1 * inv;
        v.z = n2 * inv;
      }
      if (has_m) v.w = sigmoidf(mine.w + __ldg(nets + __ldg(heads + P_M1B)));
    }
    reinterpret_cast<float4*>(rows + s * NROW)[half] = v;
  }
  cluster_sync();  // no CTA leaves while its peer may still signal it
}

struct Args {
  const float *rays_o, *rays_d, *view_dirs, *z_vals, *nets;
  const long long* plan;
  int depth, pe, dpe, has_n, has_m, sigma_only;
  long long n_total;
  int n_samples;
  float* rows;
};

// The grid: as many CTAs as the card holds at once (whole clusters), or
// fewer when the samples need fewer passes; each runs `npass` passes.
template <int W>
int launch(const Args& a, int device, cudaStream_t stream) {
  using C = Cfg<W>;
  auto kern = mlp_rows_tc_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  // co-resident clusters, asked once a card
  static int clusters[64] = {};
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!clusters[device]) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = stream;
    e = cudaOccupancyMaxActiveClusters(&clusters[device], kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters[device] < 1) return -7;
  }
  const long long nblk = (a.n_total + C::ROWS - 1) / C::ROWS;
  long long grid = (nblk + CLUSTER - 1) / CLUSTER * CLUSTER;
  if (grid > (long long)clusters[device] * CLUSTER)
    grid = (long long)clusters[device] * CLUSTER;
  const long long npass = (nblk + grid - 1) / grid;
  grid = ((nblk + npass - 1) / npass + CLUSTER - 1) / CLUSTER * CLUSTER;
  kern<<<(unsigned)grid, THREADS, C::SMEM, stream>>>(
      a.rays_o, a.rays_d, a.view_dirs, a.z_vals, a.nets, a.plan, a.depth,
      a.pe, a.dpe, a.has_n, a.has_m, a.sigma_only, a.n_total, a.n_samples,
      (int)npass, a.rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_mlp.py turns into a message:
//   -2 n_samples < 1      -3 a posenc frequency count outside [0, 20]
//   -4 the width is not 128, 256, 384 or 512, or depth < 1
//   -6 no rays            -7 no CTA of the width's shared memory fits
// All pointers are device pointers; view_dirs may be null when σ-only.
// `nets` is ops/fused_mlp_t.py `_pack`'s buffer for this trunk (16-B
// aligned), `plan` its `stream_plan` (int64). Writes rows (n_rays·
// n_samples, 8), 16-B aligned, or (n_rays·n_samples,) raw σ when σ-only.
// The entry takes the card's index (int) and a stream of that card last;
// the guard makes the card current for the launch (csrc/launch.cuh).
int mnerf_mlp_rows_tc(const float* rays_o, const float* rays_d,
                      const float* view_dirs, const float* z_vals,
                      const float* nets, const long long* plan, int width,
                      int depth, int n_emb_xyz, int n_emb_dir,
                      int has_normal, int has_mirror, int sigma_only,
                      long long n_rays, int n_samples, float* rows,
                      int device, void* stream) {
  if (n_samples < 1) return -2;
  if (n_emb_xyz < 0 || n_emb_xyz > MAX_NF || n_emb_dir < 0 ||
      n_emb_dir > MAX_NF)
    return -3;
  if (depth < 1) return -4;
  if (n_rays < 1) return -6;
  const Args a{rays_o, rays_d, view_dirs, z_vals, nets, plan, depth,
               posenc_rows(n_emb_xyz), posenc_rows(n_emb_dir),
               has_normal ? 1 : 0, has_mirror ? 1 : 0, sigma_only ? 1 : 0,
               n_rays * n_samples, n_samples, rows};
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 128: return launch<128>(a, device, s);
    case 256: return launch<256>(a, device, s);
    case 384: return launch<384>(a, device, s);
    case 512: return launch<512>(a, device, s);
    default: return -4;
  }
}

}  // extern "C"
