// A kernel's function attributes (its dynamic shared-memory limit, a
// non-portable cluster size), set once per device for each kernel
// instantiation instead of on every launch: a decode request launches the
// decode attention 930 times, and each cudaFuncSetAttribute is a driver call
// on the host's critical path.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

constexpr int MELLOW_MAX_DEVICES = 64;

// Calls `set()` (which returns a cudaError_t) on the current device unless
// it has already succeeded there for this `done` array; `done` is a static
// of the caller's kernel instantiation.
template <typename Set>
cudaError_t set_func_attrs_once(std::atomic<bool> (&done)[MELLOW_MAX_DEVICES], Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MELLOW_MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = set();
  if (err == cudaSuccess && dev < MELLOW_MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}
