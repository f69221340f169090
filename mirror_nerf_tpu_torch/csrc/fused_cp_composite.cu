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
// Per ray (o, d, view dir) and its S sorted depths z, each sample is one
// thread:
//   x01 = (o + d·z + bound) / 2·bound
//   CP encode: per level (G, R) and axis, lerp two rows of the (G, R) table
//     (clamp to [0,1], xi = min(floor, G-2)), multiply the three axes
//     rank-wise and fold each rank straight into 32 accumulators
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
// What bounds it on the H100: arithmetic. A sample costs ~17k fp32 FMAs
// (6k in the CP fold at the default 3×64 ranks, 11k in the nets) against
// ~1.2k 4-byte table reads that mostly hit L1/L2 (neighbouring samples of a
// ray read neighbouring rows), and only 4 B in + 4 B out of device memory
// per sample. The design keeps everything between the z load and the weight
// store on chip:
//   * all net weights (~17k floats, ~69 KB) live in dynamic shared memory,
//     read at uniform addresses (a broadcast, no bank conflicts);
//   * the CP tables (3 × 832 rows × 64 ranks × 4 B ≈ 0.64 MB by default) do
//     not fit, so they are read through __ldg from L2;
//   * the fold accumulates per rank into 32 registers: the 192 concatenated
//     features never exist;
//   * the color/normal/mirror output layers are streamed: each hidden unit
//     is consumed as soon as it is computed;
//   * the scan is warp shuffles plus one shared-memory pass across warps;
//     the per-ray sums are warp reductions plus one pass.
// Everything is fp32 on the CUDA cores; positions never go through a
// reduced-precision (TF32) tensor-core product. Tensor cores (wgmma), bf16
// tables and TMA staging are work for later versions.
//
// Measured on an H100 80GB HBM3 at 700 W, 16384 rays: 7.5 ms for S = 128
// (full), ~10 TFLOP/s or 15 % of the 67 TFLOP/s fp32 peak; 3.8 ms for
// S = 64 (σ-only), ~8 %. So the FMAs are not yet the limit: the scalar table
// loads of the CP encode (6 per rank) and one shared-memory operand per FMA
// are, which is what vectorized rank loads and tensor-core nets would cut.
// ROWS writes 32 B a sample (67 MB at 16384 × 128, ~0.02 ms of the memory
// rate) and SAMPLES reads 32 B a sample (x, v, z, δ): both stay bound by
// the same encode and nets.

#include <cuda_runtime.h>

namespace {

constexpr int F = 32;            // CP fold output features
constexpr int H = 64;            // σ / color / normal hidden width
constexpr int NSG = 16;          // σ-net output: raw σ + 15 geo
constexpr int GEO = 15;
constexpr int NSH = 16;          // SH degree 4
constexpr int CIN = NSH + GEO;   // color-net input
constexpr int HM = 32;           // mirror hidden width
constexpr int MAX_LEVELS = 8;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int NOUT = 9;          // opacity, rgb(3), normal(3), mirror, depth
constexpr int NROW = 8;          // ROWS: σ, rgb(3), normal(3), mirror

enum Mode { COMPOSITE = 0, ROWS = 1, SAMPLES = 2 };
constexpr int SMEM_LIMIT = 232448 - WARPS * NOUT * 4;  // 227 KB minus static

struct Levels {
  int n;
  int G[MAX_LEVELS];
  int R[MAX_LEVELS];
  long long off[MAX_LEVELS][3];  // float offset of the (level, axis) table
};

// Float offsets into the packed net buffer: the fold (ΣR × F) first, then
// each matrix in the JAX (in, out) layout. The wrapper in
// ops/fused_cp.py packs in exactly this order.
struct Nets {
  int s1, s2, c1, c2, c3, n1, n2, m1w, m1b, m2w, m2b;
  int sigma_total;  // floats the σ-only variant reads: fold, s1, s2
  int total;
};

Nets net_offsets(int sum_r) {
  Nets o;
  int p = sum_r * F;
  o.s1 = p;  p += F * H;
  o.s2 = p;  p += H * NSG;
  o.sigma_total = p;
  o.c1 = p;  p += CIN * H;
  o.c2 = p;  p += H * H;
  o.c3 = p;  p += H * 3;
  o.n1 = p;  p += GEO * H;
  o.n2 = p;  p += H * 3;
  o.m1w = p; p += GEO * HM;
  o.m1b = p; p += HM;
  o.m2w = p; p += HM;
  o.m2b = p; p += 1;
  o.total = p;
  return o;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// CP encode of one point: feat = fold^T · concat_l(Π_axes lerp(A_al, x_a)).
__device__ __forceinline__ void cp_features(
    const float x[3], const float* __restrict__ tables,
    const float* sfold, const Levels& lv, float feat[F]) {
#pragma unroll
  for (int j = 0; j < F; ++j) feat[j] = 0.f;
  int roff = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int G = lv.G[l], R = lv.R[l];
    const float* lo[3];
    float w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float xf = fminf(fmaxf(x[a], 0.f), 1.f) * (float)(G - 1);
      const int xi = min((int)floorf(xf), G - 2);
      w[a] = xf - (float)xi;
      lo[a] = tables + lv.off[l][a] + (long long)xi * R;
    }
    for (int r = 0; r < R; ++r) {
      float f = 1.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = __ldg(lo[a] + r);
        const float t1 = __ldg(lo[a] + R + r);
        f *= t0 * (1.f - w[a]) + t1 * w[a];
      }
      const float* fr = sfold + (roff + r) * F;
#pragma unroll
      for (int j = 0; j < F; ++j) feat[j] = fmaf(f, fr[j], feat[j]);
    }
    roff += R;
  }
}

// pos: ray origins (N, 3), or world positions (N, S, 3) in SAMPLES mode;
// vdir: view dirs (N, 3), or (N, S, 3) in SAMPLES mode; rays_d is read in
// COMPOSITE and ROWS, deltas (N, S) in SAMPLES only.
template <int MODE, bool SIGMA_ONLY, bool SOFTPLUS>
__global__ void __launch_bounds__(BLOCK) cp_field_kernel(
    const float* __restrict__ pos, const float* __restrict__ rays_d,
    const float* __restrict__ vdir, const float* __restrict__ z_vals,
    const float* __restrict__ deltas, const float* __restrict__ tables,
    const float* __restrict__ nets, const Levels lv, const Nets no,
    const int n_rays, const int n_samples, const int lanes_per_ray,
    const float bound, float* __restrict__ weights,
    float* __restrict__ per_ray, float* __restrict__ rows) {
  extern __shared__ float smem[];
  __shared__ float s_part[WARPS][NOUT];

  const int n_load = SIGMA_ONLY ? no.sigma_total : no.total;
  for (int k = threadIdx.x; k < n_load; k += BLOCK) smem[k] = nets[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rays_per_block = BLOCK / lanes_per_ray;
  const int slot = threadIdx.x / lanes_per_ray;   // ray within the block
  const int i = threadIdx.x - slot * lanes_per_ray;  // sample within the ray
  const int warp0 = slot * (lanes_per_ray / 32);  // the ray's first warp
  const long long ray = (long long)blockIdx.x * rays_per_block + slot;
  // when lanes_per_ray does not divide BLOCK, the last threads hold no ray
  const bool has_ray = slot < rays_per_block && ray < n_rays;
  const bool active = has_ray && i < n_samples;

  float sd = 0.f, z = 0.f;
  float rgb[3] = {0.f, 0.f, 0.f}, nrm[3] = {0.f, 0.f, 0.f}, mir = 0.f;
  const long long zi = ray * n_samples + i;
  if (active) {
    z = z_vals[zi];
    float delta = 0.f;
    if (MODE == SAMPLES) delta = deltas[zi];
    if (MODE == COMPOSITE)
      delta = (i == n_samples - 1) ? 1e10f : z_vals[zi + 1] - z;
    float x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // unfused mul/add: the same roundings as the plain version
      const float p = MODE == SAMPLES
          ? pos[zi * 3 + a]
          : __fadd_rn(pos[ray * 3 + a], __fmul_rn(rays_d[ray * 3 + a], z));
      x[a] = (p + bound) / (2.f * bound);
    }
    float feat[F];
    cp_features(x, tables, smem, lv, feat);

    // σ-net: 32 → 64 relu → 16, the hidden layer streamed into the output
    float sg[NSG];
#pragma unroll
    for (int k = 0; k < NSG; ++k) sg[k] = 0.f;
    {
      const float* s1 = smem + no.s1;
      const float* s2 = smem + no.s2;
#pragma unroll 4
      for (int o = 0; o < H; ++o) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < F; ++j) v = fmaf(feat[j], s1[j * H + o], v);
        v = fmaxf(v, 0.f);
#pragma unroll
        for (int k = 0; k < NSG; ++k) sg[k] = fmaf(v, s2[o * NSG + k], sg[k]);
      }
    }
    const float sigma = sg[0];
    const float act = SOFTPLUS
        ? fmaxf(sigma, 0.f) + log1pf(expf(-fabsf(sigma)))
        : fmaxf(sigma, 0.f);
    sd = delta * act;
    if (MODE == ROWS && SIGMA_ONLY) rows[zi] = sigma;

    if (!SIGMA_ONLY) {
      // SH degree 4 of the normalized view direction
      const long long vi = (MODE == SAMPLES ? zi : ray) * 3;
      float dx = vdir[vi + 0], dy = vdir[vi + 1], dz = vdir[vi + 2];
      const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
      dx *= inv; dy *= inv; dz *= inv;
      const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
      const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
      float cin[CIN] = {
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
      for (int k = 0; k < GEO; ++k) cin[NSH + k] = sg[1 + k];

      // color: [sh; geo] → 64 relu → 64 relu → 3 sigmoid
      float hc[H];
      {
        const float* c1 = smem + no.c1;
#pragma unroll
        for (int o = 0; o < H; ++o) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < CIN; ++k) v = fmaf(cin[k], c1[k * H + o], v);
          hc[o] = fmaxf(v, 0.f);
        }
      }
      {
        const float* c2 = smem + no.c2;
        const float* c3 = smem + no.c3;
#pragma unroll 2
        for (int o = 0; o < H; ++o) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < H; ++j) v = fmaf(hc[j], c2[j * H + o], v);
          v = fmaxf(v, 0.f);
#pragma unroll
          for (int c = 0; c < 3; ++c) rgb[c] = fmaf(v, c3[o * 3 + c], rgb[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = sigmoidf(rgb[c]);

      // normal: geo → 64 relu → 3, then L2-normalized
      {
        const float* n1 = smem + no.n1;
        const float* n2 = smem + no.n2;
#pragma unroll 4
        for (int o = 0; o < H; ++o) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < GEO; ++k) v = fmaf(sg[1 + k], n1[k * H + o], v);
          v = fmaxf(v, 0.f);
#pragma unroll
          for (int c = 0; c < 3; ++c) nrm[c] = fmaf(v, n2[o * 3 + c], nrm[c]);
        }
        const float nsq = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2];
        const float ninv = rsqrtf(fmaxf(nsq, 1.1920929e-07f));
#pragma unroll
        for (int c = 0; c < 3; ++c) nrm[c] *= ninv;
      }

      // mirror: geo → 32 (+b) leaky 0.01 → 1 (+b) sigmoid
      {
        const float* m1w = smem + no.m1w;
        const float* m1b = smem + no.m1b;
        const float* m2w = smem + no.m2w;
        float m = 0.f;
#pragma unroll 4
        for (int o = 0; o < HM; ++o) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < GEO; ++k) v = fmaf(sg[1 + k], m1w[k * HM + o], v);
          v += m1b[o];
          v = v >= 0.f ? v : 0.01f * v;
          m = fmaf(v, m2w[o], m);
        }
        mir = sigmoidf(m + smem[no.m2b]);
      }
      if (MODE == ROWS) {
        const float row[NROW] = {sigma, rgb[0], rgb[1], rgb[2],
                                 nrm[0], nrm[1], nrm[2], mir};
        float4* out = reinterpret_cast<float4*>(rows + zi * NROW);
        out[0] = make_float4(row[0], row[1], row[2], row[3]);
        out[1] = make_float4(row[4], row[5], row[6], row[7]);
      }
    }
  }
  if (MODE == ROWS) return;  // every thread of the block: no barrier below

  // Segmented EXCLUSIVE prefix of sd over the ray's lanes: warp scan, then
  // the totals of the ray's earlier warps. A lane's prefix never contains
  // its own sd, so the 1e10 sentinel on the last sample cancels nothing.
  float incl = sd;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  float excl_w = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl_w = 0.f;
  if (lane == 31) s_part[warp][0] = incl;
  __syncthreads();
  float base = 0.f;
  for (int w2 = warp0; w2 < warp; ++w2) base += s_part[w2][0];
  const float excl = base + excl_w;
  const float wt = active ? expf(-excl) * (1.f - expf(-sd)) : 0.f;
  if (active) weights[ray * n_samples + i] = wt;
  if (SIGMA_ONLY) return;

  // per-ray Σ w·[1, rgb, normal, mirror, z]
  float v[NOUT] = {wt, wt * rgb[0], wt * rgb[1], wt * rgb[2], wt * nrm[0],
                   wt * nrm[1], wt * nrm[2], wt * mir, wt * z};
#pragma unroll
  for (int k = 0; k < NOUT; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  __syncthreads();  // every lane has read the scan totals
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NOUT; ++k) s_part[warp][k] = v[k];
  }
  __syncthreads();
  if (i == 0 && has_ray) {
    const int nw = lanes_per_ray / 32;
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
      float acc = 0.f;
      for (int w2 = warp0; w2 < warp0 + nw; ++w2) acc += s_part[w2][k];
      per_ray[ray * NOUT + k] = acc;
    }
  }
}

struct Args {
  const float *pos, *rays_d, *vdir, *z_vals, *deltas, *tables, *nets;
  Levels lv;
  Nets no;
  int n_rays, n_samples;
  float bound;
  float *weights, *per_ray, *rows;
};

template <int MODE, bool SIGMA_ONLY, bool SOFTPLUS>
int launch(const Args& a, cudaStream_t stream) {
  const int lanes = (a.n_samples + 31) / 32 * 32;
  const int rays_per_block = BLOCK / lanes;
  const int grid = (a.n_rays + rays_per_block - 1) / rays_per_block;
  const size_t smem =
      (size_t)(SIGMA_ONLY ? a.no.sigma_total : a.no.total) * sizeof(float);
  auto kern = cp_field_kernel<MODE, SIGMA_ONLY, SOFTPLUS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, BLOCK, smem, stream>>>(
      a.pos, a.rays_d, a.vdir, a.z_vals, a.deltas, a.tables, a.nets, a.lv,
      a.no, a.n_rays, a.n_samples, lanes, a.bound, a.weights, a.per_ray,
      a.rows);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_variant(const Args& a, bool sigma_only, bool softplus,
                   cudaStream_t s) {
  if (sigma_only)
    return softplus ? launch<MODE, true, true>(a, s)
                    : launch<MODE, true, false>(a, s);
  return softplus ? launch<MODE, false, true>(a, s)
                  : launch<MODE, false, false>(a, s);
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0), or a negative code for arguments the
// kernel does not take, which ops/fused_cp.py turns into a message:
//   -1 level count outside [1, MAX_LEVELS]   -2 S outside [1, BLOCK]
//   -3 a level with G < 2 or R < 1           -4 n_nets is not the layout's
//   -5 the nets exceed the shared memory     -6 n_rays < 1
//   -7 mode outside {0, 1, 2}
// mode 0 (COMPOSITE): pos = rays_o (N, 3), rays_d (N, 3), vdir (N, 3);
// writes weights (N, S) and, unless σ-only, per_ray (N, 9). mode 1 (ROWS):
// the same inputs; writes rows (N, S, 8), or (N, S) raw σ when σ-only, and
// ignores softplus. mode 2 (SAMPLES): pos (N, S, 3), vdir (N, S, 3),
// deltas (N, S); writes what mode 0 writes. vdir is unread when σ-only.
// All pointers are device pointers except level_g, level_r and table_off,
// which are host arrays of n_levels entries (table_off: 3 per level,
// axis-minor).
int mnerf_fused_cp_composite(
    const float* pos, const float* rays_d, const float* vdir,
    const float* z_vals, const float* deltas, const float* tables,
    const float* nets, long long n_nets, const int* level_g,
    const int* level_r, const long long* table_off, int n_levels, int n_rays,
    int n_samples, float bound, int mode, int sigma_only, int softplus,
    float* weights, float* per_ray, float* rows, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
  if (n_samples < 1 || n_samples > BLOCK) return -2;
  if (mode < COMPOSITE || mode > SAMPLES) return -7;
  Args a{pos, rays_d, vdir, z_vals, deltas, tables, nets};
  a.lv.n = n_levels;
  int sum_r = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (level_g[l] < 2 || level_r[l] < 1) return -3;
    a.lv.G[l] = level_g[l];
    a.lv.R[l] = level_r[l];
    for (int k = 0; k < 3; ++k) a.lv.off[l][k] = table_off[l * 3 + k];
    sum_r += level_r[l];
  }
  a.no = net_offsets(sum_r);
  if (n_nets != a.no.total) return -4;
  if ((long long)(sigma_only ? a.no.sigma_total : a.no.total) * 4 >
      SMEM_LIMIT)
    return -5;
  if (n_rays < 1) return -6;
  a.n_rays = n_rays;
  a.n_samples = n_samples;
  a.bound = bound;
  a.weights = weights;
  a.per_ray = per_ray;
  a.rows = rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == ROWS)  // raw σ out: no activation, one instance per variant
    return sigma_only ? launch<ROWS, true, false>(a, s)
                      : launch<ROWS, false, false>(a, s);
  if (mode == SAMPLES)
    return launch_variant<SAMPLES>(a, sigma_only, softplus, s);
  return launch_variant<COMPOSITE>(a, sigma_only, softplus, s);
}

}  // extern "C"
