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
//       TRI: the TPU's own formulation, each row times TRI, as a matrix
//         product on the tensor cores (below).
//   WEIGHTS replaces `_prefix_weights` (mirror_nerf_tpu/ops/pallas/
//     fused_mlp_t.py:108), run inline by the test kernel at
//     tests/test_fused_cp.py:204: SCAN followed by the compositing epilogue
//     w = exp(−prefix)·(1 − exp(−sd)) per segment (a segment is a ray).
//
// TRI's design. out = x·T with T[j, i] = 1 if j < i and j, i share a
// segment, in bf16 mma.sync.m16n8k16 with fp32 accumulators, to the
// accuracy of fp32:
//   * the three-piece split, in registers: hi = bf16(x), mid = bf16(x − hi),
//     lo = bf16(x − hi − mid). Each residual is exact in fp32 and the three
//     pieces hold all 24 bits of the significand, so hi + mid + lo == x
//     (two pieces, the JAX package's `_mm_hilo_lhs`, keep ~16 bits: too few
//     for the probe's 2e-6 bar). T is 0/1, exact in bf16; each product is
//     exact. The tensor cores' fp32 sums do not round to nearest at every
//     add, so hi·T goes to one accumulator and lo·T + mid·T (2⁻⁸ of it and
//     less, smallest first) to another; one fp32 add joins them.
//   * T never lives in memory: a warp computes 16 rows; an mma's K (16
//     values of a row) and N (8 outputs) may be assigned to columns in any
//     order as long as A, B and C agree, so lane (g, t) loads one float4,
//     columns 16·kb + 4t … 4t + 3 of rows g and g + 8, as its A fragment,
//     and owns columns 16·p + 4t … 4t + 3 of the output (one float4 store a
//     row) over the n-tile pair p. T's 16 × 16 blocks then have three
//     kinds, their B fragments made in registers from the lane's (k, n):
//     zero (a k-block after p, or another segment: no mma); the diagonal
//     block kb = p (two registers a tile, computed once a thread); all ones
//     (an earlier k-block of p's segment). An all-ones block has rank one:
//     x times it is the k-block's row sum in every column, so each k-block
//     but a segment's last is summed once (one mma a piece with B all ones,
//     on one n-tile) and carried in fp32 registers into the accumulators
//     of the later diagonal blocks of its segment. 69 mma a warp at S =
//     128, 48 at S ≤ 16, against 216 for every nonzero block.
//   * a segment's last value (the δ_inf sentinel 1e10 of a ray) multiplies
//     only T's zeros, and is set to 0 before the split: it never enters the
//     tensor cores. The prefix is exclusive by construction, never
//     inclusive-minus-self.
//   * ragged rows (rows not a multiple of 16) load zeros and store nothing.
//
// What bounds it on the H100: bytes, each value read once and written once
// (16.8 MB, 5.0 µs at 3.35 TB/s for 16384 rays × 128 samples). SCAN does
// ~2 operations a value. TRI's products with all of T would be 3 × 2 × 128
// operations a value (1.61 G at that size, 1.6 µs at the dense bf16 peak of
// 989 TFLOP/s); the block structure leaves 69 mma of 4096 operations per 16
// rows at S = 128 (0.29 G, 0.3 µs). So the tensor cores do not set the
// pace, and the design goes to the bytes: 16 16-B loads a lane issued at
// once (8 KB a warp in flight), no shared memory, no barrier, 16-B stores,
// each k-block split and multiplied as its loads land. The split (about 6
// instructions a value on the CUDA cores) is the other cost.
//
// The C entry takes the card's index and the current stream of that card
// last, and switches the device in C only when it differs (csrc/launch.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "launch.cuh"

namespace {

constexpr int ROW = 128;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TRI_BLOCK = 128;  // 4 warps
constexpr int TRI_WARPS = TRI_BLOCK / 32;
constexpr int TRI_ROWS = 16;    // rows a warp: an mma's M
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr uint32_t BF16_ONES = 0x3F803F80u;

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

// ---- TRI on the tensor cores ----

// no side effects beyond c: not volatile, so the compiler may interleave
// the mma of one block with the loads and splits of the next
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Two values (the lower K first) split into three bf16 pairs whose sum is
// exactly the pair: hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi −
// mid); every difference is exact in fp32.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h));
  const float rb = __fsub_rn(b, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      __fsub_rn(ra, __low2float(m)), __fsub_rn(rb, __high2float(m)));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// T inside a diagonal 16 × 16 block, at column offsets j (row of T) and i
// (column of T): the blocks start at multiples of 16, so for S < 16 two
// offsets share a segment iff j / S == i / S.
template <int S>
__device__ __forceinline__ uint32_t tri_bit(int j, int i) {
  return (j < i && (S >= 16 || j / S == i / S)) ? BF16_ONE : 0u;
}

// A warp computes rows r0 … r0 + 15. Lane (g, t) = (lane / 4, lane % 4):
//   A, k-block kb: slots 2t, 2t + 1 ↔ columns 16·kb + 4t, 4t + 1 and slots
//     2t + 8, 2t + 9 ↔ 4t + 2, 4t + 3, of rows g (a0, a2) and g + 8 (a1, a3);
//   B, n-tile h of pair p: column n ↔ output 16·p + 4·(n / 2) + 2h + n % 2;
//   C: c0, c1 of n-tile h are outputs 16·p + 4t + 2h, + 1 of row g, c2, c3
//     of row g + 8, so a lane stores one float4 a row and pair.
template <int S>
__global__ void __launch_bounds__(TRI_BLOCK)
    tri_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long rows) {
  constexpr int KSEG = S >= 16 ? S / 16 : 1;  // k-blocks a segment spans
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long r0 =
      ((long long)blockIdx.x * TRI_WARPS + (threadIdx.x >> 5)) * TRI_ROWS;
  if (r0 >= rows) return;  // the whole warp: mma.sync needs every lane
  const long long ra = r0 + g, rb = r0 + g + 8;
  const bool in_a = ra < rows, in_b = rb < rows;
  const float4* xa = reinterpret_cast<const float4*>(x + ra * ROW) + t;
  const float4* xb = reinterpret_cast<const float4*>(x + rb * ROW) + t;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 va[8], vb[8];
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {  // all 16 loads in flight at once
    va[kb] = in_a ? __ldg(xa + 4 * kb) : zero;
    vb[kb] = in_b ? __ldg(xb + 4 * kb) : zero;
  }
  // B's diagonal blocks, n-tile h: rows 4t … 4t + 3 of T at column n = g
  uint32_t diag[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 4 * (g >> 1) + 2 * h + (g & 1);
    diag[h][0] = tri_bit<S>(4 * t, i) | (tri_bit<S>(4 * t + 1, i) << 16);
    diag[h][1] = tri_bit<S>(4 * t + 2, i) | (tri_bit<S>(4 * t + 3, i) << 16);
  }
  // the A fragments, three pieces a k-block; a segment's last value (the
  // δ_inf sentinel) multiplies only T's zeros and is dropped before
  uint32_t hi[8][4], mid[8][4], lo[8][4];
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    float ea[4] = {va[kb].x, va[kb].y, va[kb].z, va[kb].w};
    float eb[4] = {vb[kb].x, vb[kb].y, vb[kb].z, vb[kb].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (((16 * kb + 4 * t + q) & (S - 1)) == S - 1) ea[q] = eb[q] = 0.f;
    }
    split3(ea[0], ea[1], hi[kb][0], mid[kb][0], lo[kb][0]);
    split3(eb[0], eb[1], hi[kb][1], mid[kb][1], lo[kb][1]);
    split3(ea[2], ea[3], hi[kb][2], mid[kb][2], lo[kb][2]);
    split3(eb[2], eb[3], hi[kb][3], mid[kb][3], lo[kb][3]);
  }
  float* oa = out + ra * ROW + 4 * t;
  float* ob = out + rb * ROW + 4 * t;
  // the earlier k-blocks of the segment, carried: rows g and g + 8, the hi
  // piece's sums and the lo + mid pieces' sums
  float carry_hi_a = 0.f, carry_hi_b = 0.f, carry_lm_a = 0.f,
        carry_lm_b = 0.f;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (p % KSEG == 0)
      carry_hi_a = carry_hi_b = carry_lm_a = carry_lm_b = 0.f;
    // the diagonal block kb = p on top of the carries
    float big[2][4], small[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      big[h][0] = big[h][1] = carry_hi_a;
      big[h][2] = big[h][3] = carry_hi_b;
      small[h][0] = small[h][1] = carry_lm_a;
      small[h][2] = small[h][3] = carry_lm_b;
      mma_bf16(small[h], lo[p], diag[h][0], diag[h][1]);
      mma_bf16(small[h], mid[p], diag[h][0], diag[h][1]);
      mma_bf16(big[h], hi[p], diag[h][0], diag[h][1]);
    }
    if (in_a)
      reinterpret_cast<float4*>(oa)[4 * p] = make_float4(
          big[0][0] + small[0][0], big[0][1] + small[0][1],
          big[1][0] + small[1][0], big[1][1] + small[1][1]);
    if (in_b)
      reinterpret_cast<float4*>(ob)[4 * p] = make_float4(
          big[0][2] + small[0][2], big[0][3] + small[0][3],
          big[1][2] + small[1][2], big[1][3] + small[1][3]);
    if ((p + 1) % KSEG != 0) {
      // the all-ones block (p, later column blocks of the segment) has rank
      // one: x times it is the block's row sum in every column, one mma a
      // piece on one n-tile, carried in fp32
      float sum_hi[4] = {0.f, 0.f, 0.f, 0.f}, sum_lm[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(sum_lm, lo[p], BF16_ONES, BF16_ONES);
      mma_bf16(sum_lm, mid[p], BF16_ONES, BF16_ONES);
      mma_bf16(sum_hi, hi[p], BF16_ONES, BF16_ONES);
      carry_hi_a += sum_hi[0];
      carry_hi_b += sum_hi[2];
      carry_lm_a += sum_lm[0];
      carry_lm_b += sum_lm[2];
    }
  }
}

template <int S>
cudaError_t launch_tri(const float* x, float* out, long long rows,
                       cudaStream_t s) {
  const long long warps = (rows + TRI_ROWS - 1) / TRI_ROWS;
  tri_kernel<S><<<(unsigned)((warps + TRI_WARPS - 1) / TRI_WARPS), TRI_BLOCK,
                  0, s>>>(x, out, rows);
  return cudaGetLastError();
}

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
// not overlapping, on card `device`; stream is a stream of that card, made
// current there by the guard (csrc/launch.cuh).
int mnerf_segment_scan(const float* x, float* out, long long rows, int seg,
                       int mode, int device, void* stream) {
  if (seg < 1 || seg > ROW || (seg & (seg - 1))) return -1;
  if (rows < 1) return -2;
  if (mode < SCAN || mode > WEIGHTS) return -3;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned scan_grid = (unsigned)((rows + WARPS - 1) / WARPS);
  switch (mode) {
    case SCAN:
      scan_kernel<false><<<scan_grid, BLOCK, 0, s>>>(x, out, rows, seg);
      break;
    case WEIGHTS:
      scan_kernel<true><<<scan_grid, BLOCK, 0, s>>>(x, out, rows, seg);
      break;
    default:
      switch (seg) {
        case 1: return (int)launch_tri<1>(x, out, rows, s);
        case 2: return (int)launch_tri<2>(x, out, rows, s);
        case 4: return (int)launch_tri<4>(x, out, rows, s);
        case 8: return (int)launch_tri<8>(x, out, rows, s);
        case 16: return (int)launch_tri<16>(x, out, rows, s);
        case 32: return (int)launch_tri<32>(x, out, rows, s);
        case 64: return (int)launch_tri<64>(x, out, rows, s);
        default: return (int)launch_tri<128>(x, out, rows, s);
      }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
