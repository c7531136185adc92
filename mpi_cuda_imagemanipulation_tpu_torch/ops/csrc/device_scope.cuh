// The runtime's current device made `device` for one launch, then put back
// as it was, so that a wrapper needs no device context of its own (used by
// stream_stencil.cu and copy_probe.cu, whose wrappers pass the device).

#pragma once

#include <cuda_runtime.h>

struct DeviceScope {
  int prev = -1;
  int err = 0;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = (int)cudaGetDevice(&cur);
    if (err == 0 && cur != device) {
      prev = cur;
      err = (int)cudaSetDevice(device);
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};
