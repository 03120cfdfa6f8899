// The launchers' device switch.  The Python wrappers pass the tensors'
// device index instead of entering and leaving torch.cuda.device around
// every launch (a few microseconds of host time each); a launcher switches
// the calling thread's current device only when it differs, and switches
// back when it returns.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    int cur = 0;
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
