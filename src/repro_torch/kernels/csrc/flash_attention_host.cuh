// Host code that both flash-attention sources (flash_attention_bf16.cu and
// flash_attention_f32.cu) share: raising a kernel's dynamic shared-memory
// limit once per device, the occupancy query and the error strings of the
// C interface.  Each source builds into its own library, so each defines
// these once.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace flash_host {

constexpr int kMaxDevices = 64;
constexpr int kEncodeError = 1000;   // + CUresult of cuTensorMapEncodeTiled

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once: `done` is the caller's record for this kernel, one flag a
// device.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// out[0..2] = threads a CTA, dynamic shared memory a CTA (bytes), CTAs an SM
// at once, of `kernel` launched with `threads` threads and `bytes` of
// dynamic shared memory (its limit already raised).  Returns 0 or a
// cudaError_t.
inline int occupancy(const void* kernel, int threads, int bytes, int* out) {
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, kernel, threads, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = bytes;
  out[2] = ctas;
  return 0;
}

}  // namespace flash_host

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= flash_host::kEncodeError) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
