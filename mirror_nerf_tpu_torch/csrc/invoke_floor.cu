// The launch floor, one kernel library (sm_90a): y = 1.000001·x + 1e-6 over
// fp32, one kernel in two launch shapes:
//
//   SMALL replaces the Pallas TPU probe kernel `kern`
//     (tools/exp_invoke_floor.py:43, run as `small`, pallas_call :46): the
//     (8, 128) tensor in one CTA.
//   GRID replaces `kern_g` (tools/exp_invoke_floor.py:55, run as `grid`,
//     pallas_call :58, 128 parallel steps of (1, 1, 4096)): one CTA per
//     (1, L) row, 128 CTAs for the probe's (128, 1, 4096).
//
// The probe does not ask how fast the arithmetic is but what one launch
// costs: the kernel is the smallest body that reads its input and writes
// its output, so a chain of launches measures the floor under every launch
// of the port. Three ways to reach it (ops/invoke_floor.py,
// tools/exp_invoke_floor.py): `mnerf_floor_chain` loops the launches here,
// with no Python between them (the bare floor); the port's Python wrapper
// launches one per call through `mnerf_floor_launch` (ctypes plus the
// wrapper's checks); a CUDA graph replays a captured chain of wrapper calls.
// `mnerf_floor_launch_packed` is the same launch with its arguments in one
// buffer: the probe's breakdown times what one ctypes argument instead of
// six would save (the port's entries take theirs one by one).
//
// Rounding: XLA contracts the JAX body `x * 1.000001 + 1e-6` into one fused
// multiply-add (on the CPU too), so the kernel calls __fmaf_rn with the fp32
// constants; the plain version rounds once as well. Kernel, plain version and
// JAX agree bit for bit.
//
// What bounds it on the H100: bytes, and far below the launch cost. SMALL
// moves 8 KiB (2.4 ns at 3.35 TB/s), GRID 4 MiB (1.25 µs). Design: 256
// threads a CTA, 16-byte loads and stores (float4), each CTA walking its row.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr float SCALE = 1.000001f;
constexpr float SHIFT = 1e-6f;

__global__ void __launch_bounds__(BLOCK)
    floor_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                 int row_vec) {
  const size_t base = (size_t)blockIdx.x * row_vec;
  for (int i = threadIdx.x; i < row_vec; i += BLOCK) {
    float4 v = __ldg(x + base + i);
    v.x = __fmaf_rn(v.x, SCALE, SHIFT);
    v.y = __fmaf_rn(v.y, SCALE, SHIFT);
    v.z = __fmaf_rn(v.z, SCALE, SHIFT);
    v.w = __fmaf_rn(v.w, SCALE, SHIFT);
    y[base + i] = v;
  }
}

int check(int rows, int row_len) {
  if (row_len < 4 || row_len % 4) return -1;
  if (rows < 1) return -2;
  return 0;
}


}  // namespace

extern "C" {

const char* mnerf_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Each entry returns 0, a cudaError_t (> 0) from a launch, or a negative
// code for arguments the kernel does not take (ops/invoke_floor.py maps each
// to a message):
//   -1 row_len not a positive multiple of 4    -2 rows < 1
//   -3 launches < 1
// Each entry takes the card's index (int) and a stream of that card last;
// the guard makes the card current for the launches (csrc/launch.cuh). x,
// y, a and b are device pointers to rows × row_len fp32 values, 16-B
// aligned, on that card. SMALL is rows 1, row_len 1024; GRID rows 128,
// row_len 4096.
int mnerf_floor_launch(const float* x, float* y, int rows, int row_len,
                       int device, void* stream) {
  const int rc = check(rows, row_len);
  if (rc) return rc;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  floor_kernel<<<rows, BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      row_len / 4);
  return (int)cudaGetLastError();
}

// The launch's arguments in one buffer, packed by Python's struct module in
// native alignment ("PPiiiP").
struct FloorLaunch {
  const float* x;
  float* y;
  int rows;
  int row_len;
  int device;
  void* stream;
};

int mnerf_floor_launch_packed(const FloorLaunch* a) {
  return mnerf_floor_launch(a->x, a->y, a->rows, a->row_len, a->device,
                            a->stream);
}

// `launches` dependent launches a → b → a → …: launch k reads what launch
// k − 1 wrote. The result lies in b after an odd count, in a after an even
// one. Stops at the first launch that fails.
int mnerf_floor_chain(float* a, float* b, int rows, int row_len, int launches,
                      int device, void* stream) {
  int rc = check(rows, row_len);
  if (rc) return rc;
  if (launches < 1) return -3;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t s = (cudaStream_t)stream;
  for (int k = 0; k < launches; ++k) {
    const float* src = (k % 2) ? b : a;
    float* dst = (k % 2) ? a : b;
    floor_kernel<<<rows, BLOCK, 0, s>>>(reinterpret_cast<const float4*>(src),
                                        reinterpret_cast<float4*>(dst),
                                        row_len / 4);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
