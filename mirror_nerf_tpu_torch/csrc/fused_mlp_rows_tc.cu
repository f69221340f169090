// The flagship PE-MLP field per sample for every trunk up to width 4096,
// on Hopper's tensor cores (sm_90a): 3×TF32 `wgmma` with the trunk's depth
// and skip set given at run time; widths 128, 256, 384 and 512 each a
// template instance, wider ones one cluster instance (two, by how many
// k-steps a tensor-core sum spans) that takes the width at run time.
//
// Replaces, for every `FusedSpec` the JAX adapters build with a width of at
// most 4096 (`MirrorNeRFField.supports_fused_tc`: a multiple of 128, any
// depth, any skips, ≤ 20 posenc frequencies each, either head; the default
// trunk included), the two per-sample Pallas TPU kernels of
// mirror_nerf_tpu/ops/pallas/fused_mlp.py: `_kernel_rays:238` (rays;
// fused_forward_rays:310, adapter fused_rays_eval:367) and `_kernel:223`
// (points; fused_forward:266, adapters fused_packed_eval:416,
// fused_field_eval:448). Wider trunks take the layer-major GEMMs of
// csrc/fused_mlp_layers.cu (ops/fused_mlp.py `rows_route`).
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
//     sum spans at most two k-steps (one at W = 512, and in the cluster
//     instance where its ring holds fewer than five stages) and each
//     thread adds the chunks into fp32 on the CUDA cores (`gemm`). Its
//     64 columns are one part, or in the cluster instance two neighbouring
//     parts of a warpgroup (one m64n128 sum, one wait for both: the
//     waits between sums, not the products, held that instance back). Each
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
//   * wider than 512 the 64·W floats of a pass do not fit one CTA (160 KB
//     at 640, 352 KB at 1408), so C CTAs share a pass's 64 samples and
//     split each layer's columns: CTA c owns the parts q ≡ c (mod C) (≤ 8,
//     `cta_parts` in ops/fused_mlp_t.py; C the fewest of 2, 4 and 8 that
//     keeps them ≤ 6 where it can, `wide_shape`), its two warpgroups
//     alternate over them as above, it parks only its own (≤ 128 KB) and
//     streams only their weight columns, the wrapper packing each k-step
//     as C per-CTA runs of [hi, lo] planes. A thread reads the next
//     layer's A fragments from the CTA that parked them, through
//     distributed shared memory (`mapa` + `ld.shared::cluster`), two
//     k-steps ahead of its products. The C CTAs meet at a cluster-wide barrier
//     after each park and before the next: an `mbarrier` in each CTA that
//     one thread of every CTA arrives on (`release.cluster`) and every
//     consumer thread waits on (`acquire.cluster`); `barrier.cluster` would
//     also wait for the producer warpgroups, which run ahead. The cluster
//     holds two such groups on neighbouring 64-sample blocks, CTA c of one
//     paired with CTA c of the other: the pair's CTAs hold the same
//     columns, so each copies half of their stage and multicasts it to
//     both, as the narrow instances' pairs do. 2C CTAs a cluster, up to
//     16 (a non-portable cluster size), so W ≤ 4096;
//   * the weights do not fit in shared memory and every pass streams them
//     from L2: a ring of one-k-step stages (8 K rows × N × hi and lo; 3
//     stages at W = 512, 5 at 384 and 256, 10 at 128; wider, as many as
//     fit beside the parked activations, ≤ 8), each laid out as the
//     `wgmma` descriptor reads it (K-major, 32-byte swizzle). The wrapper
//     packs the stages in stream order (ops/fused_mlp_t.py `_pack`) and
//     writes a plan (`stream_plan`): each streamed layer's offset, k-steps,
//     N and bias, then the heads' fp32 leaves; the depth and the skips are
//     the plan's, the width the template's or the cluster's. A 1-D bulk
//     copy (`cp.async.bulk`) places each stage; the CTAs run in pairs, each
//     copying half a stage and multicasting it to both; an `mbarrier`
//     transaction count says it has arrived;
//   * the 1- and 3-wide heads (σ, rgb, normal, mirror) are fp32 dots on the
//     CUDA cores from the accumulators, summed over a quad by shuffles; the
//     quad's four lanes then hold a row's [σ, rgb] or [normal, mirror] each
//     and write it as one 16-B store. With split columns each warpgroup sums
//     its own and the second hands its sums to the first through shared
//     memory at the end of the pass; across a cluster's group each CTA's
//     first warpgroup then parks its CTA's sums, and the group's first CTA
//     adds them in CTA order and writes the rows;
//   * persistent CTAs: as many clusters as the card holds at once, each CTA
//     walking passes blockIdx + i·gridDim; every CTA of a cluster runs the
//     same passes (zeros past the last sample), so that they stream in step.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23,
// PERF.md §6 rows 5g, 6g): 129.5 ms at width 512, depth 8 (16384 rays × S =
// 128, full; the fp32 kernel before it 486), 50 % of the 3×TF32 bound;
// 9.75 ms at width 128, depth 6 (39 %). What bounds it now
// (tools/exp_rows_tc_diag.py): one TF32 product in place of three takes 37 %
// less time, no weight loads 1 %: the tensor pipe and the waits between
// its chunks, as in the tuned kernel. The cluster instance (rows 5w, 6w;
// tools/exp_rows_tc_diag.py): 32.3 ms at width 640, depth 2 (4096 rays ×
// 128, full; 29 % of its bound), 35.2 at 1408 on 1024 rays (32 %); one
// TF32 product 21 % less, every part its own m64n64 sum 10–14 % more, one
// k-step a sum 28–29 % more, C = ⌈W / 512⌉ (clusters of 6 at 1408) 25 %
// more; no weight loads 2–4 % less, no cluster barriers 2–4 %: the waits
// between its sums. Where a CTA holds 7 or 8 parts (widths above 3072)
// ptxas serializes its `wgmma`s for want of registers.

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

// A warpgroup's 64-column parts of a layer: part i (< n) is the layer's
// columns 64·(q0 + qs·i) …, held at part slot l0 + ls·i of the CTA's
// weight stage and park. One CTA of the narrow instances: q = l, every part
// of the layer in the CTA; a cluster's CTA c of C: q = c + C·l over its own
// parts l.
struct Parts {
  int n, q0, qs, l0, ls;
};

// act(d + b) of this warpgroup's parts (at most NP) parked as the next
// layer's A fragments: the layer's k-tile j of this thread at act[(slot
// k-tile)·128 + lane of the warpgroup], (row g col 2t, row g+8 col 2t, row g
// col 2t+1, row g+8 col 2t+1) of the layer's columns 8j …
template <int NT, int NP, int ACT>
__device__ __forceinline__ void park(const float (&d)[NT],
                                     const float* __restrict__ bias,
                                     float4* act, const int wtid,
                                     const Parts& P) {
  const int t = wtid & 3;
#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < P.n) {
#pragma unroll
      for (int jj = 0; jj < PART / 8; ++jj) {
        const int j = (P.q0 + P.qs * lq) * (PART / 8) + jj;
        const int slot = (P.l0 + P.ls * lq) * (PART / 8) + jj;
        const int e = lq * PART / 2 + 4 * jj;
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(bias + 8 * j) + t);
        act[slot * 128 + wtid] = make_float4(
            activate<ACT>(d[e] + b.x), activate<ACT>(d[e + 2] + b.x),
            activate<ACT>(d[e + 1] + b.y), activate<ACT>(d[e + 3] + b.y));
      }
    }
  }
}

// A → NO head on act(d + b) over this warpgroup's parts (at most NP): y[h][o]
// for this thread's rows g (h = 0) and g+8 (h = 1), summed over the quad by
// shuffles (all four lanes hold it), without the head's bias.
template <int NT, int NP, int ACT, int NO>
__device__ __forceinline__ void head(const float (&d)[NT],
                                     const float* __restrict__ bias,
                                     const float* __restrict__ w,
                                     const int t, const Parts& P,
                                     float (&y)[2][NO]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < NO; ++o) y[h][o] = 0.f;
#pragma unroll
  for (int lq = 0; lq < NP; ++lq) {
    if (lq < P.n) {
      const int q = P.q0 + P.qs * lq;
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

// A lane's 16-B share of a row from the heads' sums `m` (without their
// biases): [σ, rgb] (half 0) or [normal, mirror] (half 1), with the
// biases, the activations and the unit normal; 0 for a head the field lacks
__device__ __forceinline__ float4 finish(const float4 m, const int half,
                                         const int has_n, const int has_m,
                                         const float* __restrict__ nets,
                                         const long long* __restrict__ heads) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!half) {
    const float* rb3 = nets + __ldg(heads + P_RB);
    v.x = m.x + __ldg(nets + __ldg(heads + P_SB));
    v.y = sigmoidf(m.y + __ldg(rb3));
    v.z = sigmoidf(m.z + __ldg(rb3 + 1));
    v.w = sigmoidf(m.w + __ldg(rb3 + 2));
  } else {
    if (has_n) {
      const float* nb = nets + __ldg(heads + P_N1B);
      const float n0 = m.x + __ldg(nb), n1 = m.y + __ldg(nb + 1),
                  n2 = m.z + __ldg(nb + 2);
      const float inv =
          rsqrtf(fmaxf(n0 * n0 + n1 * n1 + n2 * n2, 1.1920929e-07f));
      v.x = n0 * inv;
      v.y = n1 * inv;
      v.z = n2 * inv;
    }
    if (has_m) v.w = sigmoidf(m.w + __ldg(nets + __ldg(heads + P_M1B)));
  }
  return v;
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
  // this warpgroup's parts of the trunk's layers and of the heads'
  const Parts pt{C::NPT, ch, NS, ch, NS};
  const Parts ph{(W / 2 / PART - ch + NS - 1) / NS, ch, NS, ch, NS};
  const int nph = ph.n;
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
      park<C::NT, C::NPT, ACT_RELU>(d, bias_of(i - 1), act, wtid, pt);
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
      head<C::NT, C::NPT, ACT_RELU, 1>(d, last_b, nets + __ldg(heads + P_SW),
                                       t, pt, y);
      mine.x = row_of(y, h, 0);
    }
    if (!sigma_only) {
      pair_sync<NS>();
      park<C::NT, C::NPT, ACT_RELU>(d, last_b, act, wtid, pt);
      pair_sync<NS>();
      int l = depth;  // the next streamed layer
      if (has_n) {  // normal: two linears, normalized at the end
        gemm<W, C::NPH>(d, ks_of(l), from_act, ring, signal, nph, ch,
                        W / 2);
        float y[2][3];
        head<C::NT, C::NPH, ACT_NONE, 3>(d, bias_of(l),
                                         nets + __ldg(heads + P_N1W), t, ph,
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
        head<C::NT, C::NPH, ACT_LEAKY, 1>(d, bias_of(l),
                                          nets + __ldg(heads + P_M1W), t, ph,
                                          y);
        if (half) mine.w = row_of(y, h, 0);
        ++l;
      }
      // color: xf (parked over h), then [xf, posenc(v)] → W/2 relu → rgb
      gemm<W, C::NPT>(d, ks_of(l), from_act, ring, signal, C::NPT, ch, W);
      pair_sync<NS>();
      park<C::NT, C::NPT, ACT_NONE>(d, bias_of(l), act, wtid, pt);
      pair_sync<NS>();
      ++l;
      gemm<W, C::NPH>(d, ks_of(l), [=](int kt) {
        return kt < W / 8
                   ? from_act(kt)
                   : posenc_frag(io0 + 3, io1 + 3, dpe, kt - W / 8, t);
      }, ring, signal, nph, ch, W / 2);
      float y[2][3];
      head<C::NT, C::NPH, ACT_RELU, 3>(d, bias_of(l),
                                       nets + __ldg(heads + P_RW), t, ph, y);
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
    reinterpret_cast<float4*>(rows + s * NROW)[half] =
        finish(mine, half, has_n, has_m, nets, heads);
  }
  cluster_sync();  // no CTA leaves while its peer may still signal it
}


// ---- the cluster instance: trunks wider than 512 ---------------------------

constexpr int WIDE_PARTS = 8;      // 64-column parts a CTA holds, at most
constexpr int WIDE_NP = WIDE_PARTS / CONSUMERS;  // a warpgroup's
constexpr int WIDE_NT = WIDE_NP * PART / 2;      // accumulators a thread
constexpr int WIDE_CTAS = 8;       // CTAs that split a layer's columns
constexpr int WIDE_MAX = WIDE_CTAS * WIDE_PARTS * PART;  // 4096
constexpr int WIDE_STAGES = 8;     // the weight ring's depth, at most
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100

// parts of a layer of n columns that CTA c of C holds: q = c, c + C, …
__host__ __device__ __forceinline__ int cta_parts(int n, int ctas, int c) {
  return (n / PART - c + ctas - 1) / ctas;
}

// The cluster instance's shape at width W, the same on the host and the
// card: C CTAs split a layer's columns (the cluster holds two such groups);
// CTA 0 holds the most parts (np); its park, its ring of `stages` stages of
// np parts' hi and lo planes a k-step, the pass's inputs and the barriers
// (bytes from a 256-aligned base).
struct Wide {
  int ctas, np, stages, stage_bytes, park, ios, full, empty, xbar, smem;
};

__host__ __device__ inline Wide wide_shape(int width) {
  Wide s;
  // C: the fewest of 2, 4 or 8 CTAs (clusters of 4, 8 or 16, the sizes the
  // H100's GPCs hold the most SMs in: 120, 120 and 112 of its 132, against
  // 102 in clusters of 6 and 84 of 12) that hold at most 6 parts each (a
  // ring of five stages), else 8 (≤ 8 parts, 3 stages)
  const int parts = width / PART;
  s.ctas = parts <= 12 ? 2 : (parts <= 24 ? 4 : WIDE_CTAS);
  s.np = cta_parts(width, s.ctas, 0);
  s.stage_bytes = s.np * 2 * PART * 32;  // hi + lo, 8 K rows × 64 a part
  const int park = s.np * PART * 64 * 4;  // 64 samples × its columns
  const int fixed = park + 64 * IO * 4 + 8 * (2 * WIDE_STAGES + 1) + ALIGN;
  s.stages = (SMEM_MAX - fixed) / s.stage_bytes;
  if (s.stages > WIDE_STAGES) s.stages = WIDE_STAGES;
  s.park = s.stages * s.stage_bytes;  // the ring first
  s.ios = s.park + park;
  s.full = s.ios + 64 * IO * 4;
  s.empty = s.full + 8 * s.stages;
  s.xbar = s.empty + 8 * s.stages;
  s.smem = s.xbar + 8 + ALIGN;
  return s;
}

// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_rank(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// `bytes` from global `src` to shared `dst` of the CTAs in `mask` (the same
// offset in each), completing on `bar` in each
__device__ __forceinline__ void bulk_copy_to(uint32_t dst, const void* src,
                                             int bytes, uint32_t bar,
                                             uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src),
      "r"(bytes), "r"(bar), "h"(mask) : "memory");
}

// 16 B at shared offset `addr` of CTA `rank` of the cluster
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}

// The group's cluster-wide barrier (the C CTAs that share a pass): every
// consumer thread of the group has reached it, so what each CTA parked
// before it is visible to all, and what each read from a peer before it has
// been read. The CTA's consumers meet at named barrier 1; one thread then
// arrives, with release at cluster scope, on the `xbar` of each CTA of the
// group (C arrivals complete a phase), and every consumer thread waits on
// its own with acquire at cluster scope.
__device__ __forceinline__ void group_sync(uint32_t xbar, int& phase,
                                           bool lead, int ctas,
                                           uint32_t rank0) {
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (lead) {
    for (int c = 0; c < ctas; ++c) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote) : "r"(xbar), "r"(rank0 + c));
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::
              "r"(remote) : "memory");
    }
  }
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "XWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra XWAIT;\n"
      "}" ::"r"(xbar), "r"(phase) : "memory");
  phase ^= 1;
}

// The cluster instance's view of its weight ring: its depth and stage size
// at run time, and the pair of CTAs (ranks) that fill each stage together.
struct WideRing {
  uint32_t base, full, empty;
  int stage, phase, stages, bytes;
  uint32_t pair0, pair1;
};

// d (+)= A·B, m64n128k8 TF32 (two parts side by side: d[0..31] the first,
// d[32..63] the second, each in `wgmma_n64`'s layout)
__device__ __forceinline__ void wgmma_n128(float (&d)[PART],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
}

// s += A·B over NK k-steps from kt (a chunk) for this warpgroup's parts, as
// `chunk`, from a stage of `cta_np` parts a plane. The warpgroup's parts
// are neighbours in the stage, so two at a time are one m64n128 sum (one
// tensor-core group, one wait, for two parts); an odd one is m64n64. A
// arrives split from `a` (its fp32 fragments, loaded one chunk ahead); the
// next chunk's are loaded into `a` before this chunk's products are issued,
// so that a read from a peer CTA is in flight while they run.
template <int NP, int NK, int PF, class AOf>
__device__ __forceinline__ void wide_chunk(float (&s)[WIDE_NT], const int kt,
                                           const int ksteps, float4 (&a)[PF],
                                           AOf&& a_of, WideRing& r,
                                           const bool signal, const Parts& P,
                                           const int cta_np) {
  AFrag f[NK];
  uint64_t desc[NK];
  int stage[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) split(a[j], f[j]);
#pragma unroll
  for (int j = 0; j < PF; ++j)
    if (kt + NK + j < ksteps) a[j] = a_of(kt + NK + j);
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    mbar_wait(r.full + 8 * r.stage, r.phase);
    stage[j] = r.stage;
    desc[j] = plane_desc(r.base + r.stage * r.bytes);
    if (++r.stage == r.stages) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  const uint64_t plane_lo = (uint64_t)(cta_np * PART * 32) >> 4;
  float acc[PART];
  float (&acc0)[PART / 2] = *reinterpret_cast<float (*)[PART / 2]>(acc);
#pragma unroll
  for (int i = 0; i < NP; i += 2) {
    // slot l: B rows 64l … of each of the stage's planes
    const uint64_t at = (uint64_t)((P.l0 + P.ls * i) * PART * 32) >> 4;
    if (i + 1 < P.n) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        wgmma_n128(acc, f[j].lo, desc[j] + at, j > 0);
        wgmma_n128(acc, f[j].hi, desc[j] + plane_lo + at, 1);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) wgmma_n128(acc, f[j].hi, desc[j] + at, 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < PART; ++e) asm volatile("" : "+f"(acc[e])::"memory");
#pragma unroll
      for (int e = 0; e < PART; ++e) s[i * PART / 2 + e] += acc[e];
    } else if (i < P.n) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        wgmma_n64(acc0, f[j].lo, desc[j] + at, j > 0);
        wgmma_n64(acc0, f[j].hi, desc[j] + plane_lo + at, 1);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) wgmma_n64(acc0, f[j].hi, desc[j] + at, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc0);
#pragma unroll
      for (int e = 0; e < PART / 2; ++e) s[i * PART / 2 + e] += acc0[e];
    }
  }
  if (signal) {
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      mbar_arrive_rank(r.empty + 8 * stage[j], r.pair0);
      mbar_arrive_rank(r.empty + 8 * stage[j], r.pair1);
    }
  }
}

// s = A·B for one streamed layer of `ksteps` k-steps, as `gemm`, in chunks
// of PROMOTE k-steps (the last one 1 when they do not divide)
template <int NP, int PROMOTE, class AOf>
__device__ __forceinline__ void wide_gemm(float (&s)[WIDE_NT],
                                          const int ksteps, AOf&& a_of,
                                          WideRing& r, const bool signal,
                                          const Parts& P, const int cta_np) {
#pragma unroll
  for (int i = 0; i < NP * PART / 2; ++i) s[i] = 0.f;
  float4 a[PROMOTE];
#pragma unroll
  for (int j = 0; j < PROMOTE; ++j)
    if (j < ksteps) a[j] = a_of(j);
  int kt = 0;
  for (; kt + PROMOTE <= ksteps; kt += PROMOTE)
    wide_chunk<NP, PROMOTE>(s, kt, ksteps, a, a_of, r, signal, P, cta_np);
  for (; kt < ksteps; ++kt)
    wide_chunk<NP, 1>(s, kt, ksteps, a, a_of, r, signal, P, cta_np);
}

template <int PROMOTE>
__global__ void __launch_bounds__(THREADS, 1) mlp_rows_wide_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ view_dirs, const float* __restrict__ z_vals,
    const float* __restrict__ nets, const long long* __restrict__ plan,
    const int width, const int depth, const int pe, const int dpe,
    const int has_n, const int has_m, const int sigma_only,
    const long long n_total, const int n_samples, const int npass,
    const Wide sh, float* __restrict__ rows) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + (((raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x;
  const int C = sh.ctas;
  // cluster rank c + C·r: column share c of the group r that holds the
  // pass's 64-sample block 2·(pass's pair) + r
  const uint32_t rank = cluster_rank();
  const int c = (int)rank % C, r = (int)rank / C;
  const int clusters = gridDim.x / (2 * C), cl = blockIdx.x / (2 * C);
  const int nl_full = depth + has_n + has_m + 2;
  const int nl = sigma_only ? depth : nl_full;

  if (tid == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(base + sh.full + 8 * s, 1);
      mbar_init(base + sh.empty + 8 * s, CONSUMERS * 2);
    }
    mbar_init(base + sh.xbar, C);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (tid >= 128 * CONSUMERS) {
    // ---- producer: one thread streams this CTA's columns of the plan's
    // layers, pass after pass, half of each stage from each CTA of the pair
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 128 * CONSUMERS) {
      const uint16_t mask = (uint16_t)((1u << c) | (1u << (c + C)));
      int stage = 0, phase = 0;
      for (int p = 0; p < npass; ++p) {
        for (int l = 0; l < nl; ++l) {
          const long long off = __ldg(plan + 4 * l);
          const int ks = (int)__ldg(plan + 4 * l + 1);
          const int n = (int)__ldg(plan + 4 * l + 2);
          int first = 0;  // parts of the CTAs before this one
          for (int c2 = 0; c2 < c; ++c2) first += cta_parts(n, C, c2);
          const int bytes = cta_parts(n, C, c) * 2 * PART * 32;  // a k-step
          const char* src = reinterpret_cast<const char*>(nets + off) +
                            first * 2 * PART * 32 + r * (bytes / 2);
          for (int k = 0; k < ks; ++k, src += 64 * n) {
            mbar_wait(base + sh.empty + 8 * stage, phase ^ 1);
            mbar_expect_tx(base + sh.full + 8 * stage, bytes);
            bulk_copy_to(base + stage * sh.stage_bytes + r * (bytes / 2),
                         src, bytes / 2, base + sh.full + 8 * stage, mask);
            if (++stage == sh.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the pair's copies into this CTA have all landed
    return;
  }

  // ---- consumers: warpgroup wg computes this CTA's parts l ≡ wg (mod 2)
  // of each layer for the 64 samples of the group's block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7, wtid = tid & 127;
  const int g = (wtid & 31) >> 2, t = wtid & 3;
  const int r0 = 16 * (wtid >> 5) + g;  // this thread's rows r0, r0 + 8
  float4* act = reinterpret_cast<float4*>(smem + sh.park);
  const uint32_t act_at = base + sh.park + 16 * wtid;
  float* io0 = reinterpret_cast<float*>(smem + sh.ios) + r0 * IO;
  float* io1 = io0 + 8 * IO;
  WideRing ring{base, base + sh.full, base + sh.empty, 0, 0, sh.stages,
                sh.stage_bytes, (uint32_t)c, (uint32_t)(c + C)};
  const bool signal = wtid == 0;
  const bool lead = tid == 0;
  const uint32_t rank0 = C * r;  // the group's first CTA
  int xphase = 0;
  const long long* heads = plan + 4 * nl_full;
  auto ks_of = [=](int l) { return (int)__ldg(plan + 4 * l + 1); };
  auto bias_of = [=](int l) { return nets + __ldg(plan + 4 * l + 3); };
  // this CTA's parts of a layer of n columns, and this warpgroup's
  const int np_t = cta_parts(width, C, c), np_h = cta_parts(width / 2, C, c);
  // warpgroup 0 the first ⌈np/2⌉ of the CTA's parts, 1 the rest
  const int ht = (np_t + 1) / 2, hh = (np_h + 1) / 2;
  const Parts pt{wg ? np_t - ht : ht, c + C * ht * wg, C, ht * wg, 1};
  const Parts ph{wg ? np_h - hh : hh, c + C * hh * wg, C, hh * wg, 1};
  // parts a warpgroup holds: 3 where the ring holds five stages or more
  // (PROMOTE 2, whose two k-steps' A fragments and m64n128 sums the
  // registers must also hold), 4 below (PROMOTE 1)
  constexpr int NPT = PROMOTE == 2 ? 3 : WIDE_NP;
  const int h = t >> 1, half = t & 1;
  float d[WIDE_NT];

  for (int p = 0; p < npass; ++p) {
    const long long ts0 =
        ((long long)(p * clusters + cl) * 2 + r) * 64 + r0;  // and + 8
    __syncwarp();
    if (wg == 0 && t == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* in = k ? io1 : io0;
        const long long ts = ts0 + 8 * k;
#pragma unroll
        for (int e = 0; e < IO; ++e) in[e] = 0.f;
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
    asm volatile("bar.sync 1, 256;" ::: "memory");  // the inputs are written
    // k-tile kt of a layer's activations: part kt/8 is parked by the
    // group's CTA (kt/8) mod C, as its part slot (kt/8) / C
    auto from_park = [=](int kt) {
      const int q = kt >> 3;
      return ld_cluster(act_at + (((q / C) * 8 + (kt & 7)) * 128) * 16,
                        rank0 + q % C);
    };
    auto pe_x = [=](int kt) { return posenc_frag(io0, io1, pe, kt, t); };

    // trunk: layer 0 on pe, a skip layer (more k-steps than W/8) on
    // [pe, h], the others on h
    wide_gemm<NPT, PROMOTE>(d, ks_of(0), pe_x, ring, signal, pt, np_t);
    for (int i = 1; i < depth; ++i) {
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      park<WIDE_NT, NPT, ACT_RELU>(d, bias_of(i - 1), act, wtid, pt);
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      const int ks = ks_of(i);
      const int pk = ks - width / 8;  // posenc k-steps first
      if (pk > 0)
        wide_gemm<NPT, PROMOTE>(d, ks, [=](int kt) {
          return kt < pk ? pe_x(kt) : from_park(kt - pk);
        }, ring, signal, pt, np_t);
      else
        wide_gemm<NPT, PROMOTE>(d, ks, from_park, ring, signal, pt,
                                    np_t);
    }
    const float* last_b = bias_of(depth - 1);
    float4 mine = make_float4(0.f, 0.f, 0.f, 0.f);
    {
      float y[2][1];
      head<WIDE_NT, NPT, ACT_RELU, 1>(d, last_b,
                                          nets + __ldg(heads + P_SW), t, pt,
                                          y);
      mine.x = row_of(y, h, 0);
    }
    if (!sigma_only) {
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      park<WIDE_NT, NPT, ACT_RELU>(d, last_b, act, wtid, pt);
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      int l = depth;  // the next streamed layer
      if (has_n) {  // normal: two linears, normalized at the end
        wide_gemm<2, PROMOTE>(d, ks_of(l), from_park, ring, signal,
                                        ph, np_h);
        float y[2][3];
        head<WIDE_NT, 2, ACT_NONE, 3>(
            d, bias_of(l), nets + __ldg(heads + P_N1W), t, ph, y);
        if (half) {
          mine.x = row_of(y, h, 0);
          mine.y = row_of(y, h, 1);
          mine.z = row_of(y, h, 2);
        }
        ++l;
      }
      if (has_m) {  // mirror: leaky 0.01, sigmoid at the end
        wide_gemm<2, PROMOTE>(d, ks_of(l), from_park, ring, signal,
                                        ph, np_h);
        float y[2][1];
        head<WIDE_NT, 2, ACT_LEAKY, 1>(
            d, bias_of(l), nets + __ldg(heads + P_M1W), t, ph, y);
        if (half) mine.w = row_of(y, h, 0);
        ++l;
      }
      // color: xf (parked over h), then [xf, posenc(v)] → W/2 relu → rgb
      wide_gemm<NPT, PROMOTE>(d, ks_of(l), from_park, ring, signal, pt,
                                  np_t);
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      park<WIDE_NT, NPT, ACT_NONE>(d, bias_of(l), act, wtid, pt);
      group_sync(base + sh.xbar, xphase, lead, C, rank0);
      ++l;
      wide_gemm<2, PROMOTE>(d, ks_of(l), [=](int kt) {
        return kt < width / 8
                   ? from_park(kt)
                   : posenc_frag(io0 + 3, io1 + 3, dpe, kt - width / 8, t);
      }, ring, signal, ph, np_h);
      float y[2][3];
      head<WIDE_NT, 2, ACT_RELU, 3>(
          d, bias_of(l), nets + __ldg(heads + P_RW), t, ph, y);
      if (!half) {
        mine.y = row_of(y, h, 0);
        mine.z = row_of(y, h, 1);
        mine.w = row_of(y, h, 2);
      }
    }
    // the sums: the second warpgroup's join the first's, then each CTA's
    // the group's first CTA, in CTA order, through the inputs' slots (no
    // layer reads them any more)
    float4* sums = reinterpret_cast<float4*>(smem + sh.ios);
    const int slot = 2 * (r0 + 8 * h) + half;
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wg == 1) sums[slot] = mine;
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wg == 0) {
      const float4 o = sums[slot];
      mine.x += o.x;
      mine.y += o.y;
      mine.z += o.z;
      mine.w += o.w;
      sums[slot] = mine;
    }
    group_sync(base + sh.xbar, xphase, lead, C, rank0);
    const long long s = ts0 + 8 * h;
    if (c == 0 && wg == 0 && s < n_total) {
      for (int c2 = 1; c2 < C; ++c2) {
        const float4 o = ld_cluster(base + sh.ios + 16 * slot, rank0 + c2);
        mine.x += o.x;
        mine.y += o.y;
        mine.z += o.z;
        mine.w += o.w;
      }
      // the biases, the activations, the unit normal; one 16-B store a lane
      if (sigma_only) {
        if (!half) rows[s] = mine.x + __ldg(nets + __ldg(heads + P_SB));
      } else {
        reinterpret_cast<float4*>(rows + s * NROW)[half] =
            finish(mine, half, has_n, has_m, nets, heads);
      }
    }
    // the first CTA has read every CTA's sums: the inputs' slots are free
    group_sync(base + sh.xbar, xphase, lead, C, rank0);
  }
  cluster_sync();  // no CTA leaves while a peer may still read or signal it
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

// The cluster instance at width W, its launch configuration (clusters of
// 2C CTAs, non-portable above 8) and the clusters the card holds at once
// (asked once a card and width; 0 when none fits)
struct WideLaunch {
  Wide sh;
  decltype(&mlp_rows_wide_kernel<1>) kern;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters;
};

cudaError_t wide_launch(int width, int device, cudaStream_t stream,
                        WideLaunch& w) {
  w.sh = wide_shape(width);
  const int csize = 2 * w.sh.ctas;
  w.kern = w.sh.stages >= 5 ? mlp_rows_wide_kernel<2>
                            : mlp_rows_wide_kernel<1>;
  cudaError_t e = cudaFuncSetAttribute(
      w.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, w.sh.smem);
  if (e != cudaSuccess) return e;
  if (csize > 8) {
    e = cudaFuncSetAttribute(
        w.kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  w.attr[0].id = cudaLaunchAttributeClusterDimension;
  w.attr[0].val.clusterDim.x = csize;
  w.attr[0].val.clusterDim.y = 1;
  w.attr[0].val.clusterDim.z = 1;
  w.cfg = {};
  w.cfg.gridDim = dim3(csize);
  w.cfg.blockDim = dim3(THREADS);
  w.cfg.dynamicSmemBytes = w.sh.smem;
  w.cfg.stream = stream;
  w.cfg.attrs = w.attr;
  w.cfg.numAttrs = 1;
  static int held[64][WIDE_MAX / 128 + 1] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  int& h = held[device][width / 128];
  if (!h) {
    e = cudaOccupancyMaxActiveClusters(&h, w.kern, &w.cfg);
    if (e != cudaSuccess) return e;
  }
  w.clusters = h;
  return cudaSuccess;
}

// the grid: as many clusters as the card holds at once, or fewer when the
// samples need fewer passes; each cluster takes two 64-sample blocks a pass
int launch_wide(const Args& a, int width, int device, cudaStream_t stream) {
  WideLaunch w;
  cudaError_t e = wide_launch(width, device, stream, w);
  if (e != cudaSuccess) return (int)e;
  if (w.clusters < 1) return -7;
  const long long pairs = (a.n_total + 127) / 128;
  long long grid = pairs < w.clusters ? pairs : w.clusters;
  const long long npass = (pairs + grid - 1) / grid;
  grid = (pairs + npass - 1) / npass;
  w.cfg.gridDim = dim3((unsigned)(grid * 2 * w.sh.ctas));
  e = cudaLaunchKernelEx(&w.cfg, w.kern, a.rays_o, a.rays_d, a.view_dirs,
                         a.z_vals, a.nets, a.plan, width, a.depth, a.pe,
                         a.dpe, a.has_n, a.has_m, a.sigma_only, a.n_total,
                         a.n_samples, (int)npass, w.sh, a.rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The cluster instance at width W (640 … 4096, a multiple of 128) on
// card `device`: CTAs a group (C), the most parts a CTA holds, the ring's
// stages and the clusters of 2C CTAs the card holds at once, packed as
// C + 16·(parts + 16·(stages + 16·clusters)); −4 for another width, or a
// cudaError_t's negative. The stream is not used (every entry of the
// launch path takes one last).
int mnerf_mlp_rows_tc_shape(int width, int device, void* stream) {
  if (width <= 512 || width % 128 || width > WIDE_MAX) return -4;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  WideLaunch w;
  const cudaError_t e = wide_launch(width, device, nullptr, w);
  if (e != cudaSuccess) return -(int)e;
  return w.sh.ctas + 16 * (w.sh.np + 16 * (w.sh.stages + 16 * w.clusters));
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_mlp.py turns into a message:
//   -2 n_samples < 1      -3 a posenc frequency count outside [0, 20]
//   -4 the width is not 128, 256, 384, 512 or a multiple of 128 up to
//      WIDE_MAX (4096), or depth < 1
//   -6 no rays            -7 no CTA (cluster) of the width's shared memory
//                            fits the card
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
    default:
      if (width > 512 && width % 128 == 0 && width <= WIDE_MAX)
        return launch_wide(a, width, device, s);
      return -4;
  }
}

}  // extern "C"
