// Symmetric eigendecomposition on the card that a CUDA graph can capture.
//
// No TPU kernel is replaced: the JAX package decomposes CMA-ES's
// covariance with jnp.linalg.eigh (evox_tpu/algorithms/so/es_variants/
// cma_es.py, `decompose`), an XLA operation.  On the H100, PyTorch's
// torch.linalg.eigh reads LAPACK's `info` on the host after cuSOLVER's
// syevd, and cuSOLVER's own syevd, Xsyevd and (unbatched) syevj invalidate
// a stream capture; the batched Jacobi solver syevjBatched (n <= 32) runs
// wholly on the card and captures, its `info` left in device memory.  So
// this file binds cusolverDn<t>syevjBatched with a plain C interface for
// ctypes (evox_tpu_torch/ops/linalg.py): the handle and the Jacobi
// parameters are made on the first call (before any capture: a fused
// segment runs one warm-up generation first), the workspace is allocated by
// the caller, and nothing here synchronises or allocates.
//
// Eigenvalues come back ascending; the eigenvectors overwrite A in
// column-major order (column j is the j-th eigenvector).  The Jacobi
// sweeps stop at the solver's default tolerance (the dtype's machine
// accuracy) or after kMaxSweeps, whichever comes first, and are the same
// for the same input, so an eager step and a replayed graph give the same
// bits.

#include <cuda_runtime.h>
#include <cusolverDn.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxSweeps = 100;

cusolverDnHandle_t g_handle[kMaxDevices] = {};
syevjInfo_t g_params[kMaxDevices] = {};

// The handle and Jacobi parameters of the current device; 0 on success.
int ensure(cusolverDnHandle_t* handle, syevjInfo_t* params) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 1;
  if (!g_handle[dev]) {
    cusolverDnHandle_t h = nullptr;
    syevjInfo_t p = nullptr;
    if (cusolverDnCreate(&h) != CUSOLVER_STATUS_SUCCESS) return 2;
    if (cusolverDnCreateSyevjInfo(&p) != CUSOLVER_STATUS_SUCCESS) return 3;
    cusolverDnXsyevjSetMaxSweeps(p, kMaxSweeps);
    g_handle[dev] = h;
    g_params[dev] = p;
  }
  *handle = g_handle[dev];
  *params = g_params[dev];
  return 0;
}

}  // namespace

// Device workspace in bytes of one syevjBatched call on `batch` n x n
// matrices (double when `f64`, else float); A and W are the call's device
// pointers.  Negative on failure.
extern "C" long long eigh_batched_workspace(int n, int batch, int f64, const void* A, const void* W) {
  cusolverDnHandle_t h;
  syevjInfo_t p;
  if (ensure(&h, &p)) return -1;
  int lwork = 0;
  cusolverStatus_t st;
  if (f64)
    st = cusolverDnDsyevjBatched_bufferSize(h, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                            (const double*)A, n, (const double*)W, &lwork, p, batch);
  else
    st = cusolverDnSsyevjBatched_bufferSize(h, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                            (const float*)A, n, (const float*)W, &lwork, p, batch);
  if (st != CUSOLVER_STATUS_SUCCESS) return -2;
  return (long long)lwork * (f64 ? 8 : 4);
}

// Eigendecomposition of `batch` symmetric n x n matrices in A (overwritten
// by the eigenvectors), eigenvalues into W, per-matrix `info` (int32) into
// `info`, on `stream`.  Returns 0, 1000 + the cuSOLVER status if the call
// was refused, or cudaGetLastError() after it.
extern "C" int eigh_batched(void* A, void* W, void* work, long long work_bytes, void* info, int n, int batch,
                            int f64, void* stream) {
  cusolverDnHandle_t h;
  syevjInfo_t p;
  if (ensure(&h, &p)) return 999;
  if (cusolverDnSetStream(h, (cudaStream_t)stream) != CUSOLVER_STATUS_SUCCESS) return 998;
  cusolverStatus_t st;
  if (f64)
    st = cusolverDnDsyevjBatched(h, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, (double*)A, n,
                                 (double*)W, (double*)work, (int)(work_bytes / 8), (int*)info, p, batch);
  else
    st = cusolverDnSsyevjBatched(h, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, (float*)A, n,
                                 (float*)W, (float*)work, (int)(work_bytes / 4), (int*)info, p, batch);
  if (st != CUSOLVER_STATUS_SUCCESS) return 1000 + (int)st;
  return (int)cudaGetLastError();
}
