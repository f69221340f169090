// The flagship PE-MLP field per sample, for any trunk (sm_90a), in fp32 on
// the CUDA cores: the rows mode of csrc/fused_mlp_t.cu widened from its one
// trunk (width 256, depth 8, the skip at layer 4) to every trunk the JAX
// kernels take.
//
// Replaces, for the `FusedSpec`s the JAX adapters build (`FusedSpec(width=
// field.width, depth=field.depth, skips=field.skips)`) wider than 4096 (a
// multiple of 128, any depth, any skips, ≤ 20 posenc frequencies each,
// either head), the two per-sample Pallas TPU kernels of mirror_nerf_tpu/
// ops/pallas/fused_mlp.py: `_kernel_rays:238` (rays; fused_forward_rays:310,
// adapter fused_rays_eval:367) and `_kernel:223` (points; fused_forward:266,
// adapters fused_packed_eval:416, fused_field_eval:448). Every trunk up to
// width 4096 takes the 3×TF32 `wgmma` kernel csrc/fused_mlp_rows_tc.cu
// (ops/fused_mlp.py `rows_route`); the entry takes any width, so those
// trunks can be timed here beside it.
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
// lacks), or raw σ alone when σ-only: the rows csrc/fused_mlp_t.cu writes.
//
// What bounds it on the H100: the products, 2·(pe·W + (depth−1)·W² +
// skips·pe·W + W + W² + (W + dpe)·W/2 + 2·W·W/2 + …) operations a sample
// (4.8 M at width 512, depth 8); fp32 FMA on the CUDA cores, bound by the
// 67 TFLOP/s fp32 peak. The design is the simple one:
//   * width, depth and the skip set are run-time arguments: the wrapper
//     (ops/fused_mlp.py `_rows_nets`) packs every leaf, each padded to 4
//     floats, and a table of their offsets; the weights are read from
//     global memory in their own (in, out) layout, one float4 of four
//     columns at a time (L1 and L2 hold them);
//   * a block of 256 threads owns T consecutive samples, T the largest
//     power of two ≤ 64 whose activations fit the block's shared memory
//     (2·W + max(pe, dpe) rows of T floats, column-major: row k of all T
//     samples is contiguous); any width that fits one sample runs;
//   * a layer is a register-tiled product: a thread holds MS samples × 4
//     columns (MS = min(T, 8)); the 32 threads of a warp share their
//     samples (the activations are shared-memory broadcasts) and read 32
//     neighbouring float4 of a weight row; sums run in k order in fp32;
//   * the 1- and 3-wide heads split their K over the block's threads and
//     sum the parts in order through shared memory;
//   * posenc rows are computed once per block into shared memory, the
//     view-dir posenc over them after the trunk.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23,
// PERF.md §6): 103 ms at width 640, depth 2 (4096 rays × S = 128, full),
// 22 % of its fp32 bound and 0.45× the plain route's speed, where the
// tensor-core kernel's cluster instance now takes ~32; 485 ms at width
// 512, depth 8 (16384 rays × 128), where the tensor-core kernel takes
// ~130.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_T = 64;       // samples a block
constexpr int MAX_NF = 20;      // posenc frequencies, x or v
constexpr int NROW = 8;         // σ, rgb (3), normal (3), mirror
constexpr int RED = BLOCK * 4;  // the heads' partial sums
constexpr float HALF_PI = 1.57079637f;  // fp32(π/2), as the JAX phase

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

// The offsets table (int64, written by the wrapper): per trunk layer i
// (w, b, skip) at 3i, then the heads' (w, b) pairs at 3·depth + H_*;
// −1 for a head the field lacks.
enum {
  H_SIGMA = 0, H_XF = 2, H_DIR = 4, H_RGB = 6, H_N0 = 8, H_N1 = 10,
  H_M0 = 12, H_M1 = 14
};

__host__ __device__ constexpr int posenc_rows(int n_freqs) {
  return 3 * (1 + 2 * n_freqs);
}

// shared-memory floats of a block of t samples
__host__ __device__ constexpr long long smem_floats(int width, int pe_max,
                                                    int t) {
  return (long long)(2 * width + pe_max + 6 + NROW) * t + RED;
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_LEAKY) return y >= 0.f ? y : 0.01f * y;
  return y;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// posenc row r of one coordinate triple c: r < 3 the raw value, then per
// frequency band a sin block and a cos block of 3 rows each
__device__ __forceinline__ float posenc_row(const float* c, int r) {
  if (r < 3) return c[r];
  const int j = r - 3;
  const int band = j / 6, within = j % 6;
  // f·x is exact (f = 2^band); the phase add rounds as JAX's x @ M + phase
  const float fx = __fmul_rn((float)(1 << band), c[within % 3]);
  return sinf(within < 3 ? fx : __fadd_rn(fx, HALF_PI));
}

// acc += in[0:k, samples] · w[0:k, columns c0..c0+3] (w row-major, n
// columns); in column-major with T floats a row
template <int MS>
__device__ __forceinline__ void accumulate(const float* __restrict__ in,
                                           int k, const float* __restrict__ w,
                                           int n, int c0, int t0, int T,
                                           float (&acc)[MS][4]) {
#pragma unroll 4
  for (int r = 0; r < k; ++r) {
    const float4 wv =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)r * n + c0));
    float a[MS];
    const float* row = in + r * T + t0;
    if constexpr (MS % 4 == 0) {
#pragma unroll
      for (int i = 0; i < MS; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + i);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < MS; ++i) a[i] = row[i];
    }
#pragma unroll
    for (int i = 0; i < MS; ++i) {
      acc[i][0] = fmaf(a[i], wv.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], wv.y, acc[i][1]);
      acc[i][2] = fmaf(a[i], wv.z, acc[i][2]);
      acc[i][3] = fmaf(a[i], wv.w, acc[i][3]);
    }
  }
}

// out = act([in0 (k0 rows), in1 (k1 rows)] · w + b), n columns (a multiple
// of 4), all column-major over the block's T samples; w's rows k0… read
// in1. Ends with the block's barrier.
template <int MS>
__device__ void layer(const float* __restrict__ in0, int k0,
                      const float* __restrict__ in1, int k1,
                      const float* __restrict__ w,
                      const float* __restrict__ b, int n, int act,
                      float* __restrict__ out, int T) {
  const int groups = T / MS;           // sample groups
  const int cols = BLOCK / groups;     // column groups of 4
  const int sg = threadIdx.x / cols, cg = threadIdx.x % cols;
  const int t0 = sg * MS;
  for (int c0 = 4 * cg; c0 < n; c0 += 4 * cols) {
    float acc[MS][4];
#pragma unroll
    for (int i = 0; i < MS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    accumulate<MS>(in0, k0, w, n, c0, t0, T, acc);
    if (k1) accumulate<MS>(in1, k1, w + (size_t)k0 * n, n, c0, t0, T, acc);
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + c0));
    const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < MS; ++i)
        out[(c0 + j) * T + t0 + i] = activate(acc[i][j] + bj[j], act);
  }
  __syncthreads();
}

// y[t][o] = in[0:k, t] · w[0:k, o] + b[o] for the block's T samples, NO ≤ 3
// outputs: the BLOCK / T threads of a sample sum interleaved rows, then
// thread t < T adds the parts in order (into y, T × NROW floats at column
// `col`). Ends with the block's barrier.
__device__ void head(const float* __restrict__ in, int k,
                     const float* __restrict__ w,
                     const float* __restrict__ b, int no, float* red,
                     float* y, int col, int T) {
  const int parts = BLOCK / T;
  const int t = threadIdx.x % T, part = threadIdx.x / T;
  float s[3] = {0.f, 0.f, 0.f};
  for (int r = part; r < k; r += parts) {
    const float a = in[r * T + t];
    for (int o = 0; o < no; ++o) s[o] = fmaf(a, __ldg(w + r * no + o), s[o]);
  }
  for (int o = 0; o < no; ++o) red[(part * 3 + o) * T + t] = s[o];
  __syncthreads();
  if (threadIdx.x < T) {
    for (int o = 0; o < no; ++o) {
      float v = 0.f;
      for (int p = 0; p < parts; ++p) v += red[(p * 3 + o) * T + t];
      y[t * NROW + col + o] = v + __ldg(b + o);
    }
  }
  __syncthreads();
}

template <int MS>
__global__ void __launch_bounds__(BLOCK)
    mlp_rows_kernel(const float* __restrict__ rays_o,
                    const float* __restrict__ rays_d,
                    const float* __restrict__ view_dirs,
                    const float* __restrict__ z_vals,
                    const float* __restrict__ nets,
                    const long long* __restrict__ offs, int width, int depth,
                    int pe, int dpe, int has_n, int has_m, int sigma_only,
                    long long n_total, int n_samples, int T,
                    float* __restrict__ rows) {
  extern __shared__ float4 smem4[];
  float* a_buf = reinterpret_cast<float*>(smem4);  // width × T
  float* b_buf = a_buf + width * T;                 // width × T
  float* p_buf = b_buf + width * T;                 // max(pe, dpe) × T
  const int pe_max = pe > dpe ? pe : dpe;
  float* io = p_buf + pe_max * T;  // x (3), v (3) of each sample
  float* y = io + 6 * T;           // the block's rows
  float* red = y + NROW * T;
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * T;
  const int nt = (int)(n_total - s0 < T ? n_total - s0 : T);
  const float* H = nets;
  auto leaf = [&](int i) { return H + __ldg(offs + i); };
  const int heads = 3 * depth;

  for (int t = tid; t < T; t += BLOCK) {
    float* in = io + 6 * t;
#pragma unroll
    for (int c = 0; c < 6; ++c) in[c] = 0.f;
    if (t < nt) {
      const long long s = s0 + t;
      const long long ray = s / n_samples;
      const float z = z_vals[s];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        in[a] = __fadd_rn(rays_o[ray * 3 + a],
                          __fmul_rn(rays_d[ray * 3 + a], z));
        if (!sigma_only) in[3 + a] = view_dirs[ray * 3 + a];
      }
    }
#pragma unroll
    for (int c = 0; c < NROW; ++c) y[t * NROW + c] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < pe * T; i += BLOCK)
    p_buf[i] = posenc_row(io + 6 * (i % T), i / T);
  __syncthreads();

  // trunk: layer 0 on pe, a skip layer on [pe, h], the others on h
  float* h = a_buf;
  float* other = b_buf;
  layer<MS>(p_buf, pe, nullptr, 0, leaf(0), leaf(1), width, ACT_RELU, h, T);
  for (int i = 1; i < depth; ++i) {
    if (__ldg(offs + 3 * i + 2))
      layer<MS>(p_buf, pe, h, width, leaf(3 * i), leaf(3 * i + 1), width,
                ACT_RELU, other, T);
    else
      layer<MS>(h, width, nullptr, 0, leaf(3 * i), leaf(3 * i + 1), width,
                ACT_RELU, other, T);
    float* tmp = h;
    h = other;
    other = tmp;
  }
  head(h, width, leaf(heads + H_SIGMA), leaf(heads + H_SIGMA + 1), 1, red, y,
       0, T);

  if (!sigma_only) {
    // the view-dir posenc over the position's (no layer reads it now)
    for (int i = tid; i < dpe * T; i += BLOCK)
      p_buf[i] = posenc_row(io + 6 * (i % T) + 3, i / T);
    const int wh = width / 2;
    if (has_n) {  // normal: two linears, normalized below
      layer<MS>(h, width, nullptr, 0, leaf(heads + H_N0),
                leaf(heads + H_N0 + 1), wh, ACT_NONE, other, T);
      head(other, wh, leaf(heads + H_N1), leaf(heads + H_N1 + 1), 3, red, y,
           4, T);
    }
    if (has_m) {  // mirror: leaky 0.01, sigmoid below
      layer<MS>(h, width, nullptr, 0, leaf(heads + H_M0),
                leaf(heads + H_M0 + 1), wh, ACT_LEAKY, other, T);
      head(other, wh, leaf(heads + H_M1), leaf(heads + H_M1 + 1), 1, red, y,
           7, T);
    }
    // color: xf over h, then [xf, posenc(v)] → W/2 relu (into h) → rgb
    layer<MS>(h, width, nullptr, 0, leaf(heads + H_XF),
              leaf(heads + H_XF + 1), width, ACT_NONE, other, T);
    layer<MS>(other, width, p_buf, dpe, leaf(heads + H_DIR),
              leaf(heads + H_DIR + 1), wh, ACT_RELU, h, T);
    head(h, wh, leaf(heads + H_RGB), leaf(heads + H_RGB + 1), 3, red, y, 1,
         T);
    // the epilogue: sigmoid on rgb and mirror, the unit normal
    for (int t = tid; t < nt; t += BLOCK) {
      float* r = y + t * NROW;
#pragma unroll
      for (int c = 1; c < 4; ++c) r[c] = sigmoidf(r[c]);
      if (has_n) {
        const float inv = rsqrtf(fmaxf(
            r[4] * r[4] + r[5] * r[5] + r[6] * r[6], 1.1920929e-07f));
#pragma unroll
        for (int c = 4; c < 7; ++c) r[c] *= inv;
      }
      if (has_m) r[7] = sigmoidf(r[7]);
    }
    __syncthreads();
  }

  // the block's rows, coalesced
  const int nr = sigma_only ? 1 : NROW;
  float* out = rows + s0 * nr;
  for (int i = tid; i < nt * nr; i += BLOCK)
    out[i] = y[(i / nr) * NROW + i % nr];
}

template <int MS>
int launch(const float* rays_o, const float* rays_d, const float* view_dirs,
           const float* z_vals, const float* nets, const long long* offs,
           int width, int depth, int pe, int dpe, int has_n, int has_m,
           int sigma_only, long long n_total, int n_samples, int T,
           size_t smem, float* rows, cudaStream_t stream) {
  auto kern = mlp_rows_kernel<MS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (n_total + T - 1) / T;
  kern<<<(unsigned)grid, BLOCK, smem, stream>>>(
      rays_o, rays_d, view_dirs, z_vals, nets, offs, width, depth, pe, dpe,
      has_n, has_m, sigma_only, n_total, n_samples, T, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The samples a block takes for this width and these posenc frequencies on
// `device` (the largest power of two ≤ 64 whose shared memory fits), or 0
// when not even one sample fits. The stream is not used (every entry of
// the launch path takes one last).
int mnerf_mlp_rows_tile(int width, int n_emb_xyz, int n_emb_dir, int device,
                        void* stream) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int pe = posenc_rows(n_emb_xyz), dpe = posenc_rows(n_emb_dir);
  const int pe_max = pe > dpe ? pe : dpe;
  for (int t = MAX_T; t >= 1; t /= 2)
    if (smem_floats(width, pe_max, t) * 4 <= optin) return t;
  return 0;
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_mlp.py turns into a message:
//   -2 n_samples < 1      -3 a posenc frequency count outside [0, 20]
//   -4 the width is not a positive multiple of 128, or depth < 1
//   -6 no samples         -7 T is not a power of two ≤ 64 whose shared
//   memory fits the card (`mnerf_mlp_rows_tile`)
// All pointers are device pointers; view_dirs may be null when σ-only.
// `offs` is the offsets table (3·depth + 16 int64, see H_*) into `nets`
// (16-B aligned, every leaf at a multiple of 4 floats). Writes rows
// (n_rays·n_samples, 8), or (n_rays·n_samples,) raw σ when σ-only.
int mnerf_mlp_rows(const float* rays_o, const float* rays_d,
                   const float* view_dirs, const float* z_vals,
                   const float* nets, const long long* offs, int width,
                   int depth, int n_emb_xyz, int n_emb_dir, int has_normal,
                   int has_mirror, int sigma_only, long long n_rays,
                   int n_samples, int T, float* rows, int device,
                   void* stream) {
  if (n_samples < 1) return -2;
  if (n_emb_xyz < 0 || n_emb_xyz > MAX_NF || n_emb_dir < 0 ||
      n_emb_dir > MAX_NF)
    return -3;
  if (width < 128 || width % 128 || depth < 1) return -4;
  if (n_rays < 1) return -6;
  if (T < 1 || T > MAX_T || (T & (T - 1))) return -7;
  const int pe = posenc_rows(n_emb_xyz), dpe = posenc_rows(n_emb_dir);
  const int pe_max = pe > dpe ? pe : dpe;
  const size_t smem = (size_t)smem_floats(width, pe_max, T) * 4;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return -7;
  const long long n_total = n_rays * n_samples;
  cudaStream_t s = (cudaStream_t)stream;
#define MNERF_ROWS(MS)                                                      \
  return launch<MS>(rays_o, rays_d, view_dirs, z_vals, nets, offs, width,   \
                    depth, pe, dpe, has_normal, has_mirror, sigma_only,     \
                    n_total, n_samples, T, smem, rows, s)
  if (T >= 8) MNERF_ROWS(8);
  if (T == 4) MNERF_ROWS(4);
  if (T == 2) MNERF_ROWS(2);
  MNERF_ROWS(1);
#undef MNERF_ROWS
}

}  // extern "C"
