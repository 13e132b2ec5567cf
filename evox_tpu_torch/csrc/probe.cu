// Build-and-launch probe on Hopper (sm_90a): o = 2x.
//
// Replaces the probe `kernel` in `_PROBE_CODE` of evox_tpu/ops/pallas_gate.py
// (a Pallas `o = 2x` on an (8, 128) float32 tile, run to learn whether
// Pallas works on a TPU attachment).  Here it shows that the toolchain
// builds a kernel for the card and that the kernel launches and computes:
// evox_tpu_torch/ops/probe.py builds it, launches it and compares the
// result exactly with 2 * x.  The port has no gate to open with it.
//
// What bounds it on an H100: bytes (4 bytes read and 4 written per
// element, one multiply); at (8, 128) the launch itself dominates.  One
// thread per element.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scale_by_two_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

}  // namespace

// Plain C entry point for ctypes: o = 2 * x over n float32 elements (device
// pointers).  Returns cudaGetLastError() after the launch.
extern "C" int scale_by_two(const void* x, void* o, long long n, void* stream) {
  if (n > 0)
    scale_by_two_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>((const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}
