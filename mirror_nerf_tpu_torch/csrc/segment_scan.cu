// Segmented exclusive prefix sums over 128-wide fp32 rows, one kernel
// library (sm_90a), three modes:
//
//   SCAN and TRI replace the Pallas TPU probe kernel `kernel_reshape`
//     (tools/exp_reshape_probe.py:35, pallas_call :48): out[…, i] =
//     Σ_{j < i, same segment} x[…, j] for segments of S values, S a power
//     of two dividing 128. The TPU kernel reshapes a (1, L) row to
//     (L/128, 128) and multiplies it by the strictly lower block-diagonal
//     TRI (`_tri_excl`, :26) on the MXU. The probe's question on this card
//     is which of two formulations to use:
//       SCAN: a warp per 128-wide row; each lane holds 4 values (one 16-B
//         load), scans them, and the lanes of a segment combine their sums
//         with shuffles;
//       TRI: the TPU's own formulation, each row times TRI kept in shared
//         memory, in fp32 FMAs on the CUDA cores (never TF32 mma: TF32
//         truncates the operands; ROADMAP.md §2).
//   WEIGHTS replaces `_prefix_weights` (mirror_nerf_tpu/ops/pallas/
//     fused_mlp_t.py:108), run inline by the test kernel at
//     tests/test_fused_cp.py:204: SCAN followed by the compositing epilogue
//     w = exp(−prefix)·(1 − exp(−sd)) per segment (a segment is a ray).
//
// The prefix is EXCLUSIVE by construction in every mode: a lane's offset is
// the inclusive sum of the lane before it (zero at a segment's first lane),
// never its own inclusive sum minus its value. A ray's last sample carries
// δ_inf = 1e10, and fp32 (1e10 + prefix) − 1e10 would cancel the whole
// prefix (the δ_inf trap of docs/kernels.md). TRI's zeros multiply the
// sentinel into exact zeros.
//
// What bounds it on the H100: bytes, each value read once and written once
// (16.8 MB, 5.0 µs at 3.35 TB/s for 16384 rays × 128 samples). SCAN does
// ~2 operations a value; TRI does 128 FMAs a value, its design's cost (8 µs
// of the fp32 peak at that size), with TRI built in shared memory per CTA
// (64 KiB) beside a tile of 32 rows.

#include <cuda_runtime.h>

namespace {

constexpr int ROW = 128;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int TILE = 32;  // TRI: rows a CTA
constexpr unsigned FULL = 0xffffffffu;

enum Mode { SCAN = 0, TRI = 1, WEIGHTS = 2 };

template <bool EPILOGUE>
__global__ void __launch_bounds__(BLOCK)
    scan_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long rows, int seg) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float4 v4 =
      __ldg(reinterpret_cast<const float4*>(x + row * ROW) + lane);
  const float v[4] = {v4.x, v4.y, v4.z, v4.w};
  // the lane's own exclusive prefix, restarting at each segment start
  float ex[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (((lane * 4 + k) & (seg - 1)) == 0) run = 0.f;
    ex[k] = run;
    run += v[k];
  }
  if (seg > 4) {
    // a segment spans g = seg/4 lanes, each lane inside one segment: an
    // inclusive scan of the lane sums within the segment, then each lane
    // takes the inclusive sum of the lane before it
    const int g = seg >> 2;
    const int li = lane & (g - 1);
    float inc = run;
    for (int off = 1; off < g; off <<= 1) {
      const float t = __shfl_up_sync(FULL, inc, off);
      if (li >= off) inc += t;
    }
    float offset = __shfl_up_sync(FULL, inc, 1);
    if (li == 0) offset = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) ex[k] += offset;
  }
  float4 o;
  if (EPILOGUE) {
    o.x = expf(-ex[0]) * (1.f - expf(-v[0]));
    o.y = expf(-ex[1]) * (1.f - expf(-v[1]));
    o.z = expf(-ex[2]) * (1.f - expf(-v[2]));
    o.w = expf(-ex[3]) * (1.f - expf(-v[3]));
  } else {
    o = make_float4(ex[0], ex[1], ex[2], ex[3]);
  }
  reinterpret_cast<float4*>(out + row * ROW)[lane] = o;
}

// TRI: thread (column i, half h) computes rows h·16 … h·16 + 15 of the
// CTA's tile as Σ_j x[r, j]·TRI[j, i], j ascending, in fp32 FMAs.
__global__ void __launch_bounds__(BLOCK)
    tri_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long rows, int seg) {
  extern __shared__ float4 smem4[];
  float* tri = reinterpret_cast<float*>(smem4);  // [j][i], 128 × 128
  float* xs = tri + ROW * ROW;                   // [r][j], TILE × 128
  for (int e = threadIdx.x; e < ROW * ROW; e += BLOCK) {
    const int j = e / ROW, i = e % ROW;
    tri[e] = (j < i && j / seg == i / seg) ? 1.f : 0.f;
  }
  const long long row0 = (long long)blockIdx.x * TILE;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int e = threadIdx.x; e < TILE * ROW / 4; e += BLOCK) {
    const long long r = row0 + e / (ROW / 4);
    reinterpret_cast<float4*>(xs)[e] =
        r < rows ? __ldg(x4 + r * (ROW / 4) + e % (ROW / 4))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  constexpr int R = TILE / (BLOCK / ROW);  // 16 rows a thread
  const int i = threadIdx.x % ROW;
  const int rb = (threadIdx.x / ROW) * R;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int j = 0; j < ROW; j += 4) {
    const float t0 = tri[j * ROW + i], t1 = tri[(j + 1) * ROW + i],
                t2 = tri[(j + 2) * ROW + i], t3 = tri[(j + 3) * ROW + i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 xv = reinterpret_cast<const float4*>(xs)[((rb + r) * ROW + j) / 4];
      acc[r] = fmaf(xv.x, t0, acc[r]);
      acc[r] = fmaf(xv.y, t1, acc[r]);
      acc[r] = fmaf(xv.z, t2, acc[r]);
      acc[r] = fmaf(xv.w, t3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + rb + r;
    if (row < rows) out[row * ROW + i] = acc[r];
  }
}

constexpr size_t TRI_SMEM = (size_t)(ROW * ROW + TILE * ROW) * sizeof(float);

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0) from the launch, or a negative code for
// arguments the kernel does not take (ops/segment_scan.py maps each to a
// message):
//   -1 seg is not a power of two in [1, 128]   -2 rows < 1
//   -3 mode outside {0 SCAN, 1 TRI, 2 WEIGHTS}
// x and out are device pointers to rows × 128 fp32 values, 16-B aligned,
// not overlapping.
int mnerf_segment_scan(const float* x, float* out, long long rows, int seg,
                       int mode, void* stream) {
  if (seg < 1 || seg > ROW || (seg & (seg - 1))) return -1;
  if (rows < 1) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned scan_grid = (unsigned)((rows + WARPS - 1) / WARPS);
  switch (mode) {
    case SCAN:
      scan_kernel<false><<<scan_grid, BLOCK, 0, s>>>(x, out, rows, seg);
      break;
    case WEIGHTS:
      scan_kernel<true><<<scan_grid, BLOCK, 0, s>>>(x, out, rows, seg);
      break;
    case TRI: {
      const cudaError_t e = cudaFuncSetAttribute(
          tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)TRI_SMEM);
      if (e != cudaSuccess) return (int)e;
      tri_kernel<<<(unsigned)((rows + TILE - 1) / TILE), BLOCK, TRI_SMEM,
                   s>>>(x, out, rows, seg);
      break;
    }
    default:
      return -3;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
