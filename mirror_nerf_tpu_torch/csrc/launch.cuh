// The C side of the port's launch path (ops/_build.py `Library`), shared by
// the libraries that adopted it (segment_scan, hashgrid, invoke_floor).
//
// Arguments: an entry takes its arguments one by one, as ctypes passes them
// (ops/<module>.py declares their types), and the last two are always the
// card's index (int) and the raw handle of that card's current stream.
//
// The device guard: the entry makes that card current only when it is not
// (cudaGetDevice is a thread-local read), launches, and restores the
// caller's device when the guard goes out of scope, after the entry has read
// cudaGetLastError(). This replaces a Python `with torch.cuda.device()`
// around every launch.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;  // the caller's device, when it was switched
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    int cur = -1;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
