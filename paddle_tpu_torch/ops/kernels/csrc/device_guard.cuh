// The calling thread's current CUDA device, made `device` for a scope and
// given back on every return path, errors included: a launcher called for
// a tensor on another card leaves the caller's current device as it was.
#pragma once
#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  bool changed = false;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      changed = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (changed) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
