// Encoder-shaped table products on the tensor cores, one kernel library
// (sm_90a), two operand types. It replaces the Pallas TPU probe kernel
// `kernel` of tools/exp_int8_probe.py:49 (built in `make_timed`:48,
// pallas_call :73), which asks whether int8 products run at twice the rate
// of bf16 ones at the CP encoder's shapes. For each block b (a (1, L) row of
// x) and table j:
//
//   basis_j[i, l] = cast(fl(fl(fl(i·1e-3) + x_b[l]) + j))      (G, L)
//   out_b        = Σ_j t_j @ basis_j                          (R, L) fp32
//
// with int8 tables and basis (cast: clip to ±127, then truncation toward
// zero; products summed in int32, each table's sum converted to fp32 before
// the sum over tables), or bf16 ones (cast: round to nearest even; products
// summed in fp32). The probe's defaults: G 512, R 64, L 1024, 64 blocks,
// 9 tables.
//
// Rounding: the JAX body evaluates the basis as three fp32 roundings, and
// nvcc would contract i·1e-3 + x into one FMA, so the kernel writes
// __fmul_rn / __fadd_rn (and __float2bfloat16_rn for bf16). The int8 result
// is then exact everywhere: the basis is ≤ 9 and |t| ≤ 127, so every partial
// sum is an integer below 2²⁴ (kernel, plain version and JAX agree bit for
// bit). bf16 differs from them only in the order of its fp32 sums.
//
// Design (right first; wgmma and TMA are later work):
//   * mma.sync: int8 m16n8k32 .s32.s8.s8.s32, bf16 m16n8k16 .f32.bf16.bf16
//     .f32. A CTA of 8 warps computes a (64, 128) tile of out_b, each warp a
//     (32, 32) tile: 2 × 4 mma tiles. 64 blocks × 8 lane tiles = 512 CTAs,
//     so 64 blocks do fill 132 SMs.
//   * K in chunks of 64: for each chunk the CTA copies the table chunk
//     (64 rows × 64) into shared memory and builds the basis chunk there,
//     lane-major with K contiguous (the B operand's layout: a thread's
//     fragment is one 32-bit word per register); rows padded by 16 B so a
//     warp's fragment loads hit 32 distinct banks. The basis never touches
//     device memory, and each element is built once.
//
// What bounds it on the H100: operations. 2·64·9·64·512·1024 = 38.65 G
// multiply-add operations: 39.1 µs at bf16's 989 TFLOP/s, 19.5 µs at int8's
// 1979 TOPS (dense, data sheet); the basis build, 302 M elements of a few
// fp32 operations and a conversion each, ~13.5 µs at 67 TFLOP/s; the 16.8 MB
// output 5.0 µs at 3.35 TB/s. The conversions run at a fraction of the FMA
// rate and may, not the mma, set int8's pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;  // 8 warps: 2 (rows) × 4 (lanes)
constexpr int TM = 64;      // out rows a CTA
constexpr int TN = 128;     // out lanes a CTA
constexpr int KC = 64;      // K a chunk
constexpr int KSTEP_WORDS = 8;  // one mma's K: 32 int8 or 16 bf16 = 32 B

template <typename T> struct Kind;
template <> struct Kind<int8_t> { static constexpr int BYTES = 1; };
template <> struct Kind<__nv_bfloat16> { static constexpr int BYTES = 2; };

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four consecutive basis values of one lane, K = gi … gi + 3, stored at dst
// in the B operand's layout (lower K in lower bits): one word of four int8
// (clip to ±127, then truncation toward zero: JAX's astype(int8)), or two
// words of two bf16 (round to nearest even).
template <typename T>
__device__ __forceinline__ void store_basis(uint32_t* dst, float xl, int gi,
                                            float j) {
  float f[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    f[q] = __fadd_rn(__fadd_rn(__fmul_rn((float)(gi + q), 1e-3f), xl), j);
  if constexpr (Kind<T>::BYTES == 1) {
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w |= (uint32_t)(__float2int_rz(fminf(fmaxf(f[q], -127.f), 127.f)) &
                      0xff)
           << (8 * q);
    *dst = w;
  } else {
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * h])) |
             ((uint32_t)__bfloat16_as_ushort(
                  __float2bfloat16_rn(f[2 * h + 1]))
              << 16);
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// The per-table accumulator: int32 for int8 (converted to fp32 after each
// table, as the JAX body does), none for bf16 (the fp32 sum runs on).
template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    table_mma_kernel(const T* __restrict__ t, const float* __restrict__ x,
                     float* __restrict__ out, int nt, int r, int g,
                     int lanes) {
  // a chunk's row in shared memory: KC elements + 16 B of padding, in words
  constexpr int SW = KC * Kind<T>::BYTES / 4 + 4;
  constexpr int ROW_UNITS = KC * Kind<T>::BYTES / 16;  // 16-B units a row
  constexpr int KSTEPS = KC * Kind<T>::BYTES / 32;
  constexpr bool INT8 = Kind<T>::BYTES == 1;
  __shared__ __align__(16) uint32_t As[TM * SW];
  __shared__ __align__(16) uint32_t Bs[TN * SW];
  __shared__ float xs[TN];

  const int lane0 = blockIdx.x * TN;
  const int b = blockIdx.y;
  const int m0 = blockIdx.z * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int gid = lid >> 2, tig = lid & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;

  for (int n = tid; n < TN; n += BLOCK)
    xs[n] = __ldg(x + (size_t)b * lanes + lane0 + n);

  float total[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt8 = 0; nt8 < 4; ++nt8)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[mt][nt8][q] = 0.f;

  for (int j = 0; j < nt; ++j) {
    typename Acc<T>::type acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt8 = 0; nt8 < 4; ++nt8)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nt8][q] = INT8 ? 0 : total[mt][nt8][q];
    const unsigned char* tj =
        reinterpret_cast<const unsigned char*>(t) +
        (size_t)j * r * g * Kind<T>::BYTES;
    const float jf = (float)j;

    for (int k0 = 0; k0 < g; k0 += KC) {
      __syncthreads();  // the previous chunk's fragments are read
      // the table chunk: rows m0 … m0 + 63 (zeros past r), K k0 … k0 + 63
      for (int u = tid; u < TM * ROW_UNITS; u += BLOCK) {
        const int m = u / ROW_UNITS, q = u % ROW_UNITS;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + m < r)
          v = __ldg(reinterpret_cast<const uint4*>(
                        tj + ((size_t)(m0 + m) * g + k0) * Kind<T>::BYTES) +
                    q);
        *reinterpret_cast<uint4*>(As + m * SW + q * 4) = v;
      }
      // the basis chunk: lane n, K k0 + 4·kq … + 3, lane-major
      for (int e = tid; e < TN * (KC / 4); e += BLOCK) {
        const int n = e / (KC / 4), kq = e % (KC / 4);
        store_basis<T>(Bs + n * SW + kq * Kind<T>::BYTES, xs[n],
                       k0 + 4 * kq, jf);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int kw = ks * KSTEP_WORDS;
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* p = As + (wm + mt * 16 + gid) * SW + kw + tig;
          a[mt][0] = p[0];
          a[mt][1] = p[8 * SW];
          a[mt][2] = p[4];
          a[mt][3] = p[8 * SW + 4];
        }
#pragma unroll
        for (int nt8 = 0; nt8 < 4; ++nt8) {
          const uint32_t* p = Bs + (wn + nt8 * 8 + gid) * SW + kw + tig;
          bf[nt8][0] = p[0];
          bf[nt8][1] = p[4];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt8 = 0; nt8 < 4; ++nt8) mma(acc[mt][nt8], a[mt], bf[nt8]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt8 = 0; nt8 < 4; ++nt8)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          total[mt][nt8][q] = INT8 ? total[mt][nt8][q] + (float)acc[mt][nt8][q]
                                   : (float)acc[mt][nt8][q];
  }

  // c0, c1 at (gid, 2·tig … + 1), c2, c3 at (gid + 8, …)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + gid + 8 * h;
      if (row >= r) continue;
      float* o = out + ((size_t)b * r + row) * lanes + lane0 + wn + 2 * tig;
#pragma unroll
      for (int nt8 = 0; nt8 < 4; ++nt8)
        *reinterpret_cast<float2*>(o + nt8 * 8) =
            make_float2(total[mt][nt8][2 * h], total[mt][nt8][2 * h + 1]);
    }
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0) from the launch, or a negative code for
// arguments the kernel does not take (ops/table_mma.py maps each to a
// message):
//   -1 g not a positive multiple of 64 below 2²⁴
//   -2 lanes not a positive multiple of 128   -3 nb, nt or r < 1
//   -4 kind outside {0 int8, 1 bf16}
// Device pointers: t (nt, r, g) int8 or bf16 row-major, 16-B aligned; x
// (nb, 1, lanes) fp32; out (nb, r, lanes) fp32. The entry takes the card's
// index (int) and a stream of that card last; the guard makes the card
// current for the launch (csrc/launch.cuh).
int mnerf_table_mma(const void* t, const float* x, float* out, int nb,
                    int nt, int r, int g, int lanes, int kind, int device,
                    void* stream) {
  if (g < KC || g % KC || g >= (1 << 24)) return -1;
  if (lanes < TN || lanes % TN) return -2;
  if (nb < 1 || nt < 1 || r < 1) return -3;
  if (kind != 0 && kind != 1) return -4;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const dim3 grid(lanes / TN, nb, (r + TM - 1) / TM);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    table_mma_kernel<int8_t><<<grid, BLOCK, 0, s>>>(
        static_cast<const int8_t*>(t), x, out, nt, r, g, lanes);
  else
    table_mma_kernel<__nv_bfloat16><<<grid, BLOCK, 0, s>>>(
        static_cast<const __nv_bfloat16*>(t), x, out, nt, r, g, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
