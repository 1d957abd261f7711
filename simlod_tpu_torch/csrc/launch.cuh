// The launch path shared by the C entry points of csrc/*.cu: each takes the
// device index of its tensors and torch's raw stream of that device, makes the
// device current for the launch (no torch.cuda.device context on the Python
// side) and returns the first cudaError of the launch.
#pragma once

#include <cuda_runtime.h>

namespace simlod {

// Makes `device` current for a launch (torch's stream of a tensor belongs to
// the tensor's device) and restores the caller's device afterwards.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  int error() const { return static_cast<int>(err_); }

 private:
  int device_, prev_ = -1;
  cudaError_t err_;
};

// The first error of a launch call: the launch's own, or cudaGetLastError()
// (which it also clears, so that no later call reports it again).
inline int launch_error(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace simlod
