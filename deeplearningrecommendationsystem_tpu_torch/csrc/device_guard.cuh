// What the ctypes entry points share: a guard that makes the caller's device
// current for the entry's calls (the launcher passes the tensor's device index
// instead of entering torch.cuda.device(...), which costs microseconds a call).

#pragma once

#include <cuda_runtime.h>

// Makes `device` current for the entry point's calls and restores the previous
// device after; sets nothing when it is current already.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : target_(device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) error_ = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous_ >= 0 && previous_ != target_) cudaSetDevice(previous_);
  }
  cudaError_t error() const { return error_; }

 private:
  int target_;
  int previous_ = -1;
  cudaError_t error_;
};
