// Fused flagship PE-MLP field + per-ray alpha compositing, one kernel
// (sm_90a), with a per-sample rows output mode.
//
// Composite mode replaces the Pallas TPU kernel `_kernel` of
// mirror_nerf_tpu/ops/pallas/fused_mlp_t.py:276 (driven by fused_t_forward:352,
// σ-only at :384, full at :393; adapter fused_t_rays_eval:418), in both its
// variants. It computes the same function, not the same layout: the TPU
// kernel's transposed lanes, its `E @ x3` posenc matmul with the hi/lo bf16
// split, the roll scan, the SUM-matrix composite and the packed 8-row output
// answered TPU limits and are gone.
//
// Rows mode (the ROWS template flag) replaces the two per-sample kernels of
// mirror_nerf_tpu/ops/pallas/fused_mlp.py: `_kernel_rays:238` (rays;
// fused_forward_rays:310 → :348, adapter fused_rays_eval:367) and `_kernel:223`
// (points; fused_forward:266 → :290, adapters fused_packed_eval:416,
// fused_field_eval:448). It runs the same trunk and heads and writes, per
// sample, 8 floats [raw σ, rgb (3), unit normal (3), mirror] (0 where the
// field lacks the head; raw σ alone in the σ-only variant) instead of
// compositing: σ-noise passes add the noise to the raw σ and composite
// outside. Points are one-sample rays (o = x, d = 0, z = 0: x + 0·0 is x
// exactly), so a block takes 256 of them.
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
// What bounds it on the H100: arithmetic. A sample costs 659,456 multiply-
// adds (full; 491,264 σ-only) against 4 B of depth in and 4 B of weight out;
// the weights (2.6 MB fp32) are read from L2 by every block. Design:
//   * a block owns whole rays, up to 256 samples (rays_per_block =
//     256 / S), and walks them in tiles of 64 samples;
//   * a tile's activations stay in shared memory, feature-major
//     ([row][sample], 64 floats a row): pe (63 rows), h (256), posenc(v)
//     (27) back to back (at the default frequencies), so the skip input [pe, h] and the color input
//     [xf, posenc(v)] are contiguous row ranges. Every layer is a dense
//     product over those rows, written back in place after a barrier;
//   * the weights do not fit in shared memory (2.6 MB against 227 KB): each
//     layer streams 16-row slices of its (in, out) matrix through a 16 KB
//     shared buffer, the next slice's loads in flight in registers while the
//     current one is consumed;
//   * each thread owns a register tile of 8 samples × 8 outputs (× 4 for the
//     128-wide layers): per input row it reads two float4 of activations (a
//     broadcast within the warp) and two float4 of weights for 64 FMAs;
//   * the 1- and 3-wide heads are dot products split over 4 lanes;
//   * per-sample sd, rgb, n, m of the block's rays collect in shared memory;
//     one thread per ray then runs the exclusive prefix and the sums in
//     sample order. Rows mode keeps raw σ there instead of sd and the whole
//     block writes its rows out at the end, 32 bytes a sample, coalesced:
//     at 16384 rays × 128 samples that is 67 MB, ~0.02 ms of the memory
//     rate against tens of ms of FMAs, so rows mode is bound by the same
//     arithmetic as the composite.
// Everything is fp32 on the CUDA cores: no TF32, no bf16, no tensor cores.
// Those (wgmma) are the redesign's work.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int TILE = 64;           // samples per tile
constexpr int BLOCK = 256;         // threads
constexpr int MAXS = 256;          // samples per block
constexpr int KT = 16;             // weight rows per staged slice
constexpr int W = 256;             // trunk width
constexpr int WH = 128;            // head width
constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int MAX_NF = 20;                 // posenc frequencies, x or v
constexpr int NOUT = 9;  // opacity, rgb(3), normal(3), mirror, depth
constexpr int NROW = 8;  // rows mode: σ, rgb(3), normal(3), mirror
constexpr float HALF_PI = 1.57079637f;     // fp32(π/2), as the JAX phase

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// rows of a 3-d posenc with n_freqs frequencies
__host__ __device__ constexpr int posenc_rows(int n_freqs) {
  return 3 * (1 + 2 * n_freqs);
}

// Float offsets into the packed weight buffer; every leaf starts at a
// multiple of 4 floats (float4 loads). Matrices keep the JAX (in, out)
// layout; a missing head has no leaves (offsets -1). ops/fused_mlp_t.py
// `_pack` writes exactly this order.
struct Nets {
  int tw[DEPTH], tb[DEPTH];
  int sw, sb;
  int xw, xb, dw, db, rw, rb, n0w, n0b, n1w, n1b, m0w, m0b, m1w, m1b;
  int total;
};

// input rows of trunk layer i, for pe posenc rows
__host__ __device__ constexpr int trunk_in(int i, int pe) {
  return i == 0 ? pe : (i == SKIP ? pe + W : W);
}

Nets net_offsets(int pe, int dpe, bool has_n, bool has_m) {
  Nets o{};
  o.n0w = o.n0b = o.n1w = o.n1b = o.m0w = o.m0b = o.m1w = o.m1b = -1;
  int p = 0;
  auto take = [&p](int n) { const int at = p; p += pad4(n); return at; };
  for (int i = 0; i < DEPTH; ++i) {
    o.tw[i] = take(trunk_in(i, pe) * W);
    o.tb[i] = take(W);
  }
  o.sw = take(W);
  o.sb = take(1);
  o.xw = take(W * W);
  o.xb = take(W);
  o.dw = take((W + dpe) * WH);
  o.db = take(WH);
  o.rw = take(WH * 3);
  o.rb = take(3);
  if (has_n) {
    o.n0w = take(W * WH);
    o.n0b = take(WH);
    o.n1w = take(WH * 3);
    o.n1b = take(3);
  }
  if (has_m) {
    o.m0w = take(W * WH);
    o.m0b = take(WH);
    o.m1w = take(WH);
    o.m1b = take(1);
  }
  o.total = p;
  return o;
}

// Shared-memory layout (float offsets) for pe posenc rows of x and dpe of
// v; every region starts at a multiple of 4 floats (float4 access).
struct Smem {
  int act;  // [row][TILE]: pe, h (W), posenc(v) unless σ-only
  int hid;  // [WH][TILE]
  int wst;  // [KT][W], the staged weight slice
  int io;   // x3, v3, δ, z: [8][TILE]
  int sd, rgb, nrm, mir;  // per sample of the block: [MAXS], [3][MAXS], ..
  int total;
};

__host__ __device__ constexpr Smem smem_layout(int pe, int dpe,
                                               bool sigma_only) {
  Smem l{};
  l.act = 0;
  l.hid = l.act + (sigma_only ? pe + W : pe + W + dpe) * TILE;
  l.wst = l.hid + (sigma_only ? 0 : WH * TILE);
  l.io = l.wst + KT * W;
  l.sd = l.io + 8 * TILE;
  l.rgb = l.sd + MAXS;
  l.nrm = l.rgb + (sigma_only ? 0 : 3 * MAXS);
  l.mir = l.nrm + (sigma_only ? 0 : 3 * MAXS);
  l.total = l.mir + (sigma_only ? 0 : MAXS);
  return l;
}
static_assert(sizeof(float) * smem_layout(posenc_rows(MAX_NF),
                                          posenc_rows(MAX_NF), false).total
                  <= 232448,
              "shared memory");

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Rows [k0, k0 + KT) of a row-major (K, N) matrix, as this thread's PER
// float4 of the slice (zeros past row K).
template <int N, int PER>
__device__ __forceinline__ void fetch_slice(float4 (&pre)[PER],
                                            const float* __restrict__ Wg,
                                            const int k0, const int K) {
  const float4* src = reinterpret_cast<const float4*>(Wg + k0 * N);
  const int lim = min(KT, K - k0) * N / 4;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = threadIdx.x + p * BLOCK;
    pre[p] = idx < lim ? __ldg(src + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// out[n][s] = act(Σ_k A[k][s]·Wg[k·N + n] + b[n]) for the tile's 64 samples
// and n < N (N = 256 or 128). A and out are [row][TILE] in shared memory and
// may overlap: every thread has read A before any thread writes out.
// Starts and ends with a barrier.
template <int N, int ACT>
__device__ __forceinline__ void dense(const float* A, const int K,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg,
                                      float* out, float* wst) {
  constexpr int NC = N / 128;                   // float4 column groups
  constexpr int PER = KT * N / 4 / BLOCK;       // staged float4 per thread
  const int lane = threadIdx.x & 31;
  const int s0 = (threadIdx.x >> 5) * 8;        // the warp's 8 samples
  float acc[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;

  float4 pre[PER];
  fetch_slice<N, PER>(pre, Wg, 0, K);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int p = 0; p < PER; ++p)
      reinterpret_cast<float4*>(wst)[threadIdx.x + p * BLOCK] = pre[p];
    __syncthreads();
    // the next slice's loads are in flight during the FMAs below
    if (k0 + KT < K) fetch_slice<N, PER>(pre, Wg, k0 + KT, K);
    const int kn = min(KT, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float* a = A + (k0 + kk) * TILE + s0;
      const float4 a0 = *reinterpret_cast<const float4*>(a);
      const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(
            wst + kk * N + c * 128 + 4 * lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * c + 0] = fmaf(av[i], wv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(av[i], wv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(av[i], wv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(av[i], wv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
  __syncthreads();  // every thread has read A
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = c * 128 + 4 * lane + j;
      const float b = __ldg(bg + n);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = acc[i][4 * c + j] + b;
        if (ACT == ACT_RELU) y = fmaxf(y, 0.f);
        if (ACT == ACT_LEAKY) y = y >= 0.f ? y : 0.01f * y;
        v[i] = y;
      }
      float* o = out + n * TILE + s0;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();
}

// y[o] = Σ_k A[k][s]·Wg[k·NO + o] + b[o] for this thread's sample
// s = tid / 4; the 4 lanes of a sample split k and combine by shuffles,
// so all four hold the result.
template <int NO>
__device__ __forceinline__ void small_head(const float* A, const int K,
                                           const float* __restrict__ Wg,
                                           const float* __restrict__ bg,
                                           float y[NO]) {
  const int s = threadIdx.x >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int o = 0; o < NO; ++o) y[o] = 0.f;
  for (int k = q; k < K; k += 4) {
    const float a = A[k * TILE + s];
#pragma unroll
    for (int o = 0; o < NO; ++o) y[o] = fmaf(a, __ldg(Wg + k * NO + o), y[o]);
  }
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    y[o] += __shfl_xor_sync(0xffffffffu, y[o], 1);
    y[o] += __shfl_xor_sync(0xffffffffu, y[o], 2);
    y[o] += __ldg(bg + o);
  }
}

// posenc rows r of one coordinate triple: r < 3 the raw value, then per
// frequency band a sin block and a cos block of 3 rows each.
__device__ __forceinline__ float posenc_row(const float* v3, const int r) {
  if (r < 3) return v3[r];
  const int j = r - 3;
  const int band = j / 6, within = j % 6;
  const float f = (float)(1 << band);
  // f·x is exact (f = 2^band); the phase add rounds as the JAX x @ M + phase
  const float fx = __fmul_rn(f, v3[within % 3]);
  return sinf(within < 3 ? fx : __fadd_rn(fx, HALF_PI));
}

template <bool ROWS, bool SIGMA_ONLY, bool SOFTPLUS, bool HAS_N, bool HAS_M>
__global__ void __launch_bounds__(BLOCK, 1) mlp_field_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ view_dirs, const float* __restrict__ z_vals,
    const float* __restrict__ nets, const Nets no, const int pe,
    const int dpe, const int n_rays, const int n_samples,
    const int rays_per_block, float* __restrict__ weights,
    float* __restrict__ per_ray, float* __restrict__ rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem L = smem_layout(pe, dpe, SIGMA_ONLY);
  float* act = smem + L.act;
  float* hid = smem + L.hid;
  float* wst = smem + L.wst;
  float* io = smem + L.io;  // x [3][TILE], v [3][TILE], δ, z
  float* s_sd = smem + L.sd;  // sd, or raw σ in rows mode
  float* s_rgb = smem + L.rgb;
  float* s_nrm = smem + L.nrm;
  float* s_mir = smem + L.mir;

  const long long ray0 = (long long)blockIdx.x * rays_per_block;
  const int n_here = (int)min((long long)rays_per_block, n_rays - ray0);
  const int nt = n_here * n_samples;  // samples this block holds
  const int tid = threadIdx.x;

  for (int t0 = 0; t0 < nt; t0 += TILE) {
    __syncthreads();  // the previous tile's heads are done with io
    if (tid < TILE) {
      const int t = t0 + tid;
      float x[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
      float z = 0.f, delta = 0.f;
      if (t < nt) {
        const long long ray = ray0 + t / n_samples;
        const int i = t % n_samples;
        const long long zi = ray * n_samples + i;
        z = z_vals[zi];
        if (!ROWS) delta = (i == n_samples - 1) ? 1e10f : z_vals[zi + 1] - z;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          x[a] = __fadd_rn(rays_o[ray * 3 + a],
                           __fmul_rn(rays_d[ray * 3 + a], z));
          if (!SIGMA_ONLY) v[a] = view_dirs[ray * 3 + a];
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        io[a * TILE + tid] = x[a];
        io[(3 + a) * TILE + tid] = v[a];
      }
      io[6 * TILE + tid] = delta;
      io[7 * TILE + tid] = z;
    }
    __syncthreads();
    for (int idx = tid; idx < pe * TILE; idx += BLOCK) {
      const int r = idx / TILE, s = idx % TILE;
      const float x3[3] = {io[s], io[TILE + s], io[2 * TILE + s]};
      act[r * TILE + s] = posenc_row(x3, r);
    }
    if (!SIGMA_ONLY) {
      for (int idx = tid; idx < dpe * TILE; idx += BLOCK) {
        const int r = idx / TILE, s = idx % TILE;
        const float v3[3] = {io[3 * TILE + s], io[4 * TILE + s],
                             io[5 * TILE + s]};
        act[(pe + W + r) * TILE + s] = posenc_row(v3, r);
      }
    }
    // (dense starts with a barrier: the encodings are complete)

    float* h = act + pe * TILE;
    dense<W, ACT_RELU>(act, pe, nets + no.tw[0], nets + no.tb[0], h, wst);
    for (int i = 1; i < DEPTH; ++i) {
      const float* in = i == SKIP ? act : h;  // [pe, h] is rows 0..pe+W
      dense<W, ACT_RELU>(in, trunk_in(i, pe), nets + no.tw[i],
                         nets + no.tb[i], h, wst);
    }

    const int s = tid >> 2;
    const bool writer = (tid & 3) == 0 && t0 + s < nt;
    {
      float sig[1];
      small_head<1>(h, W, nets + no.sw, nets + no.sb, sig);
      const float a = SOFTPLUS
          ? fmaxf(sig[0], 0.f) + log1pf(expf(-fabsf(sig[0])))
          : fmaxf(sig[0], 0.f);
      if (writer) s_sd[t0 + s] = ROWS ? sig[0] : io[6 * TILE + s] * a;
    }
    if (SIGMA_ONLY) continue;

    if (HAS_N) {  // normal: two linears, then normalized
      dense<WH, ACT_NONE>(h, W, nets + no.n0w, nets + no.n0b, hid, wst);
      float n[3];
      small_head<3>(hid, WH, nets + no.n1w, nets + no.n1b, n);
      const float inv = rsqrtf(
          fmaxf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1.1920929e-07f));
      if (writer)
        for (int c = 0; c < 3; ++c) s_nrm[c * MAXS + t0 + s] = n[c] * inv;
    }
    if (HAS_M) {  // mirror: leaky 0.01, then sigmoid
      dense<WH, ACT_LEAKY>(h, W, nets + no.m0w, nets + no.m0b, hid, wst);
      float m[1];
      small_head<1>(hid, WH, nets + no.m1w, nets + no.m1b, m);
      if (writer) s_mir[t0 + s] = sigmoidf(m[0]);
    }
    // color: xf (in place over h), then [xf, posenc(v)] → 128 relu → rgb
    dense<W, ACT_NONE>(h, W, nets + no.xw, nets + no.xb, h, wst);
    dense<WH, ACT_RELU>(h, W + dpe, nets + no.dw, nets + no.db, hid, wst);
    {
      float c3[3];
      small_head<3>(hid, WH, nets + no.rw, nets + no.rb, c3);
      if (writer)
        for (int c = 0; c < 3; ++c) s_rgb[c * MAXS + t0 + s] = sigmoidf(c3[c]);
    }
  }
  __syncthreads();

  if (ROWS) {  // the block's rows, ray-major, coalesced
    constexpr int NR = SIGMA_ONLY ? 1 : NROW;
    float* out = rows + ray0 * n_samples * NR;
    for (int idx = tid; idx < nt * NR; idx += BLOCK) {
      const int t = idx / NR, c = idx - t * NR;
      float v;
      if (c == 0) v = s_sd[t];
      else if (c < 4) v = s_rgb[(c - 1) * MAXS + t];
      else if (c < 7) v = HAS_N ? s_nrm[(c - 4) * MAXS + t] : 0.f;
      else v = HAS_M ? s_mir[t] : 0.f;
      out[idx] = v;
    }
    return;
  }

  // one thread per ray: the exclusive prefix and the per-ray sums, in
  // sample order. The prefix never holds a sample's own sd, so the 1e10
  // on the last sample cancels nothing.
  if (tid < n_here) {
    const long long ray = ray0 + tid;
    const float* sd = s_sd + tid * n_samples;
    float excl = 0.f;
    float acc[NOUT] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n_samples; ++i) {
      const float w = expf(-excl) * (1.f - expf(-sd[i]));
      excl += sd[i];
      weights[ray * n_samples + i] = w;
      if (!SIGMA_ONLY) {
        const int t = tid * n_samples + i;
        acc[0] += w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[1 + c] += w * s_rgb[c * MAXS + t];
          if (HAS_N) acc[4 + c] += w * s_nrm[c * MAXS + t];
        }
        if (HAS_M) acc[7] += w * s_mir[t];
        acc[8] += w * z_vals[ray * n_samples + i];
      }
    }
    if (!SIGMA_ONLY) {
#pragma unroll
      for (int k = 0; k < NOUT; ++k) per_ray[ray * NOUT + k] = acc[k];
    }
  }
}

struct Args {
  const float *rays_o, *rays_d, *view_dirs, *z_vals, *nets;
  Nets no;
  int pe, dpe, n_rays, n_samples;
  float *weights, *per_ray, *rows;
};

template <bool ROWS, bool SIGMA_ONLY, bool SOFTPLUS, bool HAS_N, bool HAS_M>
int launch(const Args& a, cudaStream_t stream) {
  const int rays_per_block = MAXS / a.n_samples;
  const int grid = (a.n_rays + rays_per_block - 1) / rays_per_block;
  const int smem =
      (int)sizeof(float) * smem_layout(a.pe, a.dpe, SIGMA_ONLY).total;
  auto kern = mlp_field_kernel<ROWS, SIGMA_ONLY, SOFTPLUS, HAS_N, HAS_M>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, BLOCK, smem, stream>>>(
      a.rays_o, a.rays_d, a.view_dirs, a.z_vals, a.nets, a.no, a.pe, a.dpe,
      a.n_rays, a.n_samples, rays_per_block, a.weights, a.per_ray, a.rows);
  return (int)cudaGetLastError();
}

// the σ-only variant reads no head; the full one one instance per head set.
// Rows mode emits raw σ, so it has no activation (one instance per set).
template <bool ROWS, bool SOFTPLUS>
int launch_variant(const Args& a, bool sigma_only, bool has_n, bool has_m,
                   cudaStream_t stream) {
  if (sigma_only)
    return launch<ROWS, true, SOFTPLUS, false, false>(a, stream);
  if (has_n && has_m)
    return launch<ROWS, false, SOFTPLUS, true, true>(a, stream);
  if (has_n) return launch<ROWS, false, SOFTPLUS, true, false>(a, stream);
  if (has_m) return launch<ROWS, false, SOFTPLUS, false, true>(a, stream);
  return launch<ROWS, false, SOFTPLUS, false, false>(a, stream);
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
// variant. Composite mode (rows_mode 0) writes weights (N, S) and, unless
// σ-only, per_ray (N, 9); rows mode (1) writes rows (N·S, 8), or (N·S,)
// raw σ when σ-only, and ignores softplus. nets holds every leaf of the
// field, heads included, whichever the variant. The entry takes the card's
// index (int) and a stream of that card last; the guard makes the card
// current for the launch (csrc/launch.cuh).
int mnerf_fused_mlp_t(const float* rays_o, const float* rays_d,
                      const float* view_dirs, const float* z_vals,
                      const float* nets, long long n_nets, int n_rays,
                      int n_samples, int n_emb_xyz, int n_emb_dir,
                      int has_normal, int has_mirror, int sigma_only,
                      int softplus, int rows_mode, float* weights,
                      float* per_ray, float* rows, int device,
                      void* stream) {
  if (n_samples < 1 || n_samples > MAXS) return -2;
  if (n_emb_xyz < 0 || n_emb_xyz > MAX_NF || n_emb_dir < 0 ||
      n_emb_dir > MAX_NF)
    return -3;
  const int pe = posenc_rows(n_emb_xyz), dpe = posenc_rows(n_emb_dir);
  const Args a{rays_o, rays_d, view_dirs, z_vals, nets,
               net_offsets(pe, dpe, has_normal, has_mirror), pe, dpe,
               n_rays, n_samples, weights, per_ray, rows};
  if (n_nets != a.no.total) return -4;
  if (n_rays < 1) return -6;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows_mode)
    return launch_variant<true, false>(a, sigma_only, has_normal, has_mirror,
                                       s);
  return softplus
      ? launch_variant<false, true>(a, sigma_only, has_normal, has_mirror, s)
      : launch_variant<false, false>(a, sigma_only, has_normal, has_mirror, s);
}

}  // extern "C"
