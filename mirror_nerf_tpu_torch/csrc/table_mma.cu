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
// the sum over tables, in table order), or bf16 ones (cast: round to
// nearest even; products summed in fp32, each table's sum added to the
// fp32 total in table order). The probe's defaults: G 512, R 64, L 1024, 64
// blocks, 9 tables.
//
// Rounding: the JAX body evaluates the basis as three fp32 roundings, and
// nvcc would contract i·1e-3 + x into one FMA, so the kernel writes
// __fmul_rn / __fadd_rn. The int8 result is then exact everywhere: |t| and
// the basis are ≤ 127, so with G ≤ 512 every table's sum is an integer
// below 2²⁴ (kernel, plain version and JAX agree bit for bit). bf16 differs
// from them only in the order of its fp32 sums.
//
// What bounds it on the H100: operations. 2·64·9·64·512·1024 = 38.65 G
// multiply-add operations: 39.1 µs at bf16's 989 TFLOP/s, 19.5 µs at int8's
// 1979 TOPS (dense, data sheet); the 16.8 MB output 5.0 µs at 3.35 TB/s.
// Beside them the basis, 302 M elements built on the CUDA cores. From the
// final SASS (tools/exp_table_diag.py prints its opcode counts) an int8
// element costs 2 FADD, 1 FMNMX, 1 F2I, 0.75 PRMT and 1/16 of a 16-B store,
// a bf16 one 2 FADD, half an F2FP (two values a conversion) and 1/8 of a
// store; at four warp instructions a clock an SM (1980 MHz) that is ~44 µs
// and ~24 µs of issue, and the conversions alone, at 16 a clock an SM, ~72
// µs (int8) and ~36 µs (bf16): for int8 the build, not the tensor cores,
// sets the pace.
//
// Design (the first design, mma.sync with the build between two
// barriers, is in git history):
//   * `wgmma`: m64n128k32 .s32.s8.s8 for int8 and m64n128k16 .f32.bf16.bf16
//     for bf16, both operands read from shared memory by descriptor,
//     K-major (8-bit types take only that): a tile is 64 table rows × 256
//     lanes, two consumer warpgroups of 128 lanes each;
//   * warp specialisation: two producer warpgroups build basis chunk k + 1
//     into a ring of STAGES shared-memory stages while the consumers run
//     chunk k. A stage is 128 bytes of K (128 int8 or 64 bf16 values): the
//     table chunk (64 rows) and the basis chunk (256 lanes), each row 128 B
//     in the 128-byte swizzle the descriptor reads (16-B unit u of row n at
//     unit u ^ (n & 7));
//   * the table chunk comes in by TMA (a 3-d tensor map, the swizzle done
//     by the copy, zeros past R and past G), started by one producer thread
//     once the stage is free; its bytes count against the stage's full
//     barrier, so no thread waits for the copy;
//   * the basis is built on chip in every call and never touches device
//     memory. A producer thread builds one 16-B unit (16 int8 or 8 bf16
//     values along K) of 8 lanes a stage: the unit's fl(i·1e-3) from the
//     CTA's table in shared memory (broadcast 16-B loads), the lanes' x in
//     registers for the tile; bf16 packs pairs with one `cvt.rn.bf16x2.f32`;
//     int8 takes fmaxf(f, −127), then `cvt.rzi.s8.f32` (its saturation is
//     the upper clip; `cast_s8`), and packs four bytes with __byte_perm.
//     Every producer thread runs `fence.proxy.async` (its generic stores
//     before the tensor cores' async reads), then one lane a warp arrives
//     on the stage's full barrier; the consumers wait on it, issue the
//     chunk's four k-steps, wait for them and let one lane a warp release
//     the stage (the next chunk's issued before the wait: −2.4 … +0.5 %,
//     two runs);
//   * int8 keeps each table's int32 sum in the wgmma accumulator (scale-d 0
//     at the table's first k-step) and adds it, converted, to an fp32 total
//     in registers after the table's last chunk; bf16 does the same with an
//     fp32 accumulator, so the tensor cores' sums span one table, and the
//     sum over tables is rounded on the CUDA cores;
//   * persistent CTAs (one an SM, 512 threads, `setmaxnreg` 152 / 104 for
//     the consumers / producers in int8, 184 / 72 in bf16) walk the tiles
//     (lane tile fastest, then block, then row tile): the producers fill
//     the next tile's stages while the consumers write the last one's
//     outputs. At the defaults 4 × 64 = 256 tiles on 132 SMs. Measured:
//     tiles of 128 lanes (one consumer warpgroup) 13–36 % slower; one CTA
//     a tile within −1 … +4 % (two runs).
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): int8 0.130 ms
// and bf16 0.096 a call (tools/exp_table_diag.py), about half and a third
// of the first design's in turns (tools/exp_launch_ab.py --groups tables).
// What holds it (exp_table_diag, in turns): int8 the build (0.046 ms
// without it, 0.117 without the products); bf16 both sides alike (0.080
// without the build, 0.073 without the products): the producers' stores
// and the tensor cores' operand reads share the SM's shared memory. Casts:
// cvt 0.130, the first design's F2I 0.133, the directed add of 1.5·2²³
// 0.152 (F2I-free, three more instructions an element). Copying each
// stage's table chunk a stage ahead by the producers (cp.async, in place
// of TMA) was slower: the ring then holds one stage less.
// Shapes: G a multiple of 64 up to G_MAX (an int8 chunk of 64 is padded
// with zeros to 128), L a multiple of 128 (a tile's second warpgroup
// computes and stores nothing past L), any R ≥ 1 (rows past R are loaded
// as zeros and not stored).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;  // warpgroups running wgmma, WN lanes each
constexpr int PRODUCERS = 2;  // warpgroups building the basis
constexpr int C_THREADS = 128 * CONSUMERS;
constexpr int P_THREADS = 128 * PRODUCERS;
constexpr int THREADS = C_THREADS + P_THREADS;
constexpr int TM = 64;                  // table rows a tile: wgmma's M
constexpr int WN = 128;                 // lanes a consumer warpgroup: its N
constexpr int TN = WN * CONSUMERS;      // lanes a tile
constexpr int ROW = 128;                // K bytes a stage row (the swizzle)
constexpr int UNITS = ROW / 16;         // 16-B units a row
constexpr int LANES_PER_THREAD = TN * UNITS / P_THREADS;  // 8
constexpr int A_BYTES = TM * ROW;       // 8 KB: the table chunk
constexpr int B_BYTES = TN * ROW;       // 32 KB: the basis chunk
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
constexpr int G_MAX = 16384;            // fl(i·1e-3) for every i: 64 KB

static_assert(LANES_PER_THREAD * P_THREADS == TN * UNITS, "producer split");

template <typename T> struct Kind;
// setmaxnreg's split, consumers + producers = 256 (2·128·256 = 65536),
// each type's fastest (tools/exp_table_diag.py regs_*)
template <> struct Kind<int8_t> {
  static constexpr int E = 1;
  static constexpr int REG_CONSUMER = 152, REG_PRODUCER = 104;
  using Acc = int;
};
template <> struct Kind<__nv_bfloat16> {
  static constexpr int E = 2;
  static constexpr int REG_CONSUMER = 184, REG_PRODUCER = 72;
  using Acc = float;
};

// Dynamic shared memory (from a 1024-aligned base): the ring, then
// fl(i·1e-3) for i < g, then the full and empty barriers of each stage.
__host__ __device__ constexpr int table_bytes(int g) {
  return (4 * g + 7) / 8 * 8;
}
__host__ __device__ constexpr int smem_bytes(int g) {
  return STAGES * STAGE_BYTES + table_bytes(g) + 16 * STAGES;
}
static_assert(smem_bytes(G_MAX) + 1024 <= 232448, "shared memory");

// the box at (c0, c1, c2) of a 3-d tensor map into shared `dst`, completing
// on `bar` (its bytes counted against the barrier's transaction count)
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar) : "memory");
}

// byte offset of 16-B unit `u` of 128-B row `n` in the 128-byte swizzle
__device__ __forceinline__ uint32_t sw128(int n, int u) {
  return (n >> 3) * 1024 + (n & 7) * ROW + ((u ^ (n & 7)) << 4);
}

// Descriptor of K-major rows of 128 B at shared address `addr` (1024-B
// aligned) in the 128-byte swizzle (layout 1): 8-row groups (SBO) 1024 B
// apart; LBO is not read in a swizzled K-major layout. A k-step of 32 B
// within the rows adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A·B, m64n128k32 .s32.s8.s8: A (64 rows of the table chunk) and B
// (128 lanes of the basis chunk) by descriptor, K-major; d is overwritten
// when `scale` is 0.
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

// the same for bf16: m64n128k16 .f32.bf16.bf16, both operands K-major
__device__ __forceinline__ void wgmma_k32(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

// keeps the compiler from moving reads of the accumulators above the wait
template <typename A>
__device__ __forceinline__ void fence_acc(A (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (std::is_integral_v<A>)
      asm volatile("" : "+r"(d[i])::"memory");
    else
      asm volatile("" : "+f"(d[i])::"memory");
  }
}

// JAX's astype(int8) of clip(f, −127, 127), as the low byte of the result
// (the packing reads no other): cvt.rzi.s8.f32 truncates toward zero and
// saturates at 127 above; the fmaxf takes −128 to −127 (tools/
// exp_table_diag.py times the first design's F2I after a two-sided clip,
// and an F2I-free add of 1.5·2²³ under directed rounding)
__device__ __forceinline__ uint32_t cast_s8(float f) {
  int v;
  asm("{\n.reg .s8 t;\ncvt.rzi.s8.f32 t, %1;\ncvt.s32.s8 %0, t;\n}"
      : "=r"(v) : "f"(fmaxf(f, -127.f)));
  return (uint32_t)v;
}

// the low bytes of four words, b0 lowest
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040),
                     __byte_perm(b2, b3, 0x0040), 0x5410);
}

// One 16-B unit of a lane's basis row: K values k … k + 16/E − 1 (a holds
// their fl(i·1e-3)), lower K in lower bits.
template <typename T>
__device__ __forceinline__ uint4 basis_unit(const float (&a)[16 / Kind<T>::E],
                                            float xl, float jf) {
  constexpr int EPU = 16 / Kind<T>::E;
  float f[EPU];
#pragma unroll
  for (int q = 0; q < EPU; ++q) f[q] = __fadd_rn(__fadd_rn(a[q], xl), jf);
  uint32_t w[4];
  if constexpr (Kind<T>::E == 1) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      w[h] = pack4(cast_s8(f[4 * h]), cast_s8(f[4 * h + 1]),
                   cast_s8(f[4 * h + 2]), cast_s8(f[4 * h + 3]));
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * h], f[2 * h + 1]);
      memcpy(&w[h], &v, 4);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a tile's first lane, block and first table row: lane tile fastest, then
// block, then row tile
struct Tile {
  int lane0, b, m0;
};
__device__ __forceinline__ Tile tile_at(int tile, int n_lt, int nb) {
  const int rest = tile / n_lt;
  return {tile % n_lt * TN, rest % nb, rest / nb * TM};
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    table_mma_kernel(const __grid_constant__ CUtensorMap tmap,
                     const float* __restrict__ x, float* __restrict__ out,
                     int nb, int nt, int r, int g, int lanes) {
  constexpr int E = Kind<T>::E;
  constexpr int KC = ROW / E;    // K a stage: 128 int8, 64 bf16
  constexpr int EPU = 16 / E;    // K a 16-B unit
  using Acc = typename Kind<T>::Acc;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  float* iot = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  const uint32_t full = base + STAGES * STAGE_BYTES + table_bytes(g);
  const uint32_t empty = full + 8 * STAGES;
  const int tid = threadIdx.x;
  const int n_lt = (lanes + TN - 1) / TN, n_mt = (r + TM - 1) / TM;
  const int tiles = n_lt * nb * n_mt;
  const int chunks = (g + KC - 1) / KC;

  for (int i = tid; i < g; i += THREADS) iot[i] = __fmul_rn((float)i, 1e-3f);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // one arrive a producer warp, and the TMA's expect_tx
      mbar_init(full + 8 * s, P_THREADS / 32 + 1);
      mbar_init(empty + 8 * s, C_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= C_THREADS) {
    // ---- producers: unit `unit` of lanes n0 … n0 + 7 of every stage; the
    // first thread also starts the stage's table chunk by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        Kind<T>::REG_PRODUCER));
    const int p = tid - C_THREADS;
    const int unit = p % UNITS;
    const int n0 = p / UNITS * LANES_PER_THREAD;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile at = tile_at(tile, n_lt, nb);
      // this thread's lanes' x (0 past L: built, never stored)
      float xl[LANES_PER_THREAD];
#pragma unroll
      for (int i = 0; i < LANES_PER_THREAD; i += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (at.lane0 + n0 < lanes)
          v = __ldg(reinterpret_cast<const float4*>(
              x + (size_t)at.b * lanes + at.lane0 + n0 + i));
        xl[i] = v.x;
        xl[i + 1] = v.y;
        xl[i + 2] = v.z;
        xl[i + 3] = v.w;
      }
      for (int j = 0; j < nt; ++j) {
        const float jf = (float)j;
        for (int c = 0; c < chunks; ++c) {
          const int k0 = c * KC;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          if (p == 0) {
            // rows m0 … m0 + 63 of chunk c of table j, swizzled by the TMA
            // unit (zeros past r and past g); its bytes complete the
            // stage's full barrier
            mbar_expect_tx(full + 8 * stage, A_BYTES);
            tma_load_3d(base + stage * STAGE_BYTES, &tmap, k0, at.m0, j,
                        full + 8 * stage);
          }
          unsigned char* st = smem + stage * STAGE_BYTES;
          if (unit < min(KC, g - k0) * E / 16) {
            float a[EPU];
#pragma unroll
            for (int i = 0; i < EPU; i += 4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  iot + k0 + unit * EPU + i);
              a[i] = v.x;
              a[i + 1] = v.y;
              a[i + 2] = v.z;
              a[i + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < LANES_PER_THREAD; ++i)
              *reinterpret_cast<uint4*>(st + A_BYTES + sw128(n0 + i, unit)) =
                  basis_unit<T>(a, xl[i], jf);
          } else {
            // past g (an int8 chunk of 64): zeros, so that every chunk runs
            // its four k-steps
#pragma unroll
            for (int i = 0; i < LANES_PER_THREAD; ++i)
              *reinterpret_cast<uint4*>(st + A_BYTES + sw128(n0 + i, unit)) =
                  make_uint4(0, 0, 0, 0);
          }
          // this thread's stores before the tensor cores' reads; one
          // arrive a warp
          fence_proxy_async();
          __syncwarp();
          if ((tid & 31) == 0) mbar_arrive(full + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg runs lanes 128·wg … 128·wg + 127 of a tile;
  // a stage is released (one lane a warp) once the products that read it
  // are done
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      Kind<T>::REG_CONSUMER));
  const int wg = tid >> 7, wtid = tid & 127;
  const int gid = (wtid & 31) >> 2, tig = wtid & 3;
  const int row_w = 16 * (wtid >> 5) + gid;  // and row_w + 8
  Acc acc[64];  // a table's sum (scale-d 0 at the table's first k-step)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile at = tile_at(tile, n_lt, nb);
    float total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;
    for (int j = 0; j < nt; ++j) {
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t st = base + stage * STAGE_BYTES;
        const uint64_t da = sw128_desc(st);
        const uint64_t db = sw128_desc(st + A_BYTES + wg * WN * ROW);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < ROW / 32; ++ks)
          wgmma_k32(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait_all();
        if ((tid & 31) == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      fence_acc(acc);
      // the table's sum, converted (int8: rounded to nearest), into the
      // total in table order
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += (float)acc[i];
    }
    // d[4q + 2h + e] holds row row_w + 8h, lane 8q + 2·tig + e
    const int lw = at.lane0 + wg * WN;
    if (lw >= lanes) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = at.m0 + row_w + 8 * h;
      if (row >= r) continue;
      float* o = out + ((size_t)at.b * r + row) * lanes + lw + 2 * tig;
#pragma unroll
      for (int q = 0; q < WN / 8; ++q)
        *reinterpret_cast<float2*>(o + 8 * q) =
            make_float2(total[4 * q + 2 * h], total[4 * q + 2 * h + 1]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult q;
    void* f = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

template <typename T>
int launch(const T* t, const float* x, float* out, int nb, int nt, int r,
           int g, int lanes, int device, cudaStream_t s) {
  constexpr int E = Kind<T>::E;
  // the tables as a 3-d tensor (g, r, nt), innermost first; a box is one
  // stage's table chunk, KC × 64 × 1, in the 128-byte swizzle
  auto encode = encode_fn();
  if (!encode) return -6;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)g, (cuuint64_t)r, (cuuint64_t)nt};
  const cuuint64_t strides[2] = {(cuuint64_t)g * E, (cuuint64_t)g * r * E};
  const cuuint32_t box[3] = {(cuuint32_t)(ROW / E), (cuuint32_t)TM, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  if (encode(&map,
             E == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<T*>(t), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -6;
  const int smem = smem_bytes(g) + 1024;  // + the 1024-B alignment
  auto kern = table_mma_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((lanes + TN - 1) / TN) * nb *
                          ((r + TM - 1) / TM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, smem, s>>>(map, x, out, nb, nt, r, g, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Returns 0, a cudaError_t (> 0) from the launch, or a negative code for
// arguments the kernel does not take (ops/table_mma.py maps each to a
// message):
//   -1 g not a positive multiple of 64       -5 g above G_MAX (16384)
//   -2 lanes not a positive multiple of 128   -3 nb, nt or r < 1, or more
//      than 2³¹ − 1 tiles
//   -4 kind outside {0 int8, 1 bf16}      -6 cuTensorMapEncodeTiled did not
//      make the tables' tensor map (or was not found)
// Device pointers: t (nt, r, g) int8 or bf16 row-major, 16-B aligned (the
// TMA's rule; its rows are multiples of 64 B); x
// (nb, 1, lanes) fp32, 16-B aligned; out (nb, r, lanes) fp32. The entry
// takes the card's index (int) and a stream of that card last; the guard
// makes the card current for the launch (csrc/launch.cuh).
int mnerf_table_mma(const void* t, const float* x, float* out, int nb,
                    int nt, int r, int g, int lanes, int kind, int device,
                    void* stream) {
  if (g < 64 || g % 64) return -1;
  if (g > G_MAX) return -5;
  if (lanes < WN || lanes % WN) return -2;
  if (nb < 1 || nt < 1 || r < 1) return -3;
  if ((long long)((lanes + TN - 1) / TN) * nb * ((r + TM - 1) / TM) >
      0x7FFFFFFFll)
    return -3;
  if (kind != 0 && kind != 1) return -4;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return launch(static_cast<const int8_t*>(t), x, out, nb, nt, r, g, lanes,
                  device, s);
  return launch(static_cast<const __nv_bfloat16*>(t), x, out, nb, nt, r, g,
                lanes, device, s);
}

}  // extern "C"
