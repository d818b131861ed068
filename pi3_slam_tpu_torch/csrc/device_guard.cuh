// The launchers' switch to the device they launch on, undone when the launcher
// returns. cudaSetDevice sets the calling thread's current device, which
// PyTorch reads for every allocation and launch that names no index: a launch
// on cuda:1 must leave a thread that was on cuda:0 there. The switch runs even
// where the thread is on the device already: it also makes the device's
// primary context current in the thread, which the driver calls of a launch
// (the TMA encoder) need in a thread that has made no runtime call yet.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int previous = -1;
  int device;
  cudaError_t err;
  explicit DeviceGuard(int d) : device(d) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous >= 0 && previous != device) cudaSetDevice(previous);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
