// Which cuSOLVER eigensolvers run inside a CUDA graph capture: syevjBatched
// (kind 0, n <= 32), syevj (1), syevd (2) and Xsyevd (3), each on one
// float32 n x n matrix, with a plain C interface for ctypes (probe.py).
// The handle and parameters are made on the first call; the caller
// allocates the device workspace.
#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <cstdlib>
#include <cstdint>

static cusolverDnHandle_t g_handle = nullptr;
static syevjInfo_t g_syevj = nullptr;
static cusolverDnParams_t g_params = nullptr;
static void* g_host = nullptr;
static size_t g_host_bytes = 0;

static int ensure() {
  if (!g_handle) {
    if (cusolverDnCreate(&g_handle) != CUSOLVER_STATUS_SUCCESS) return 1;
    if (cusolverDnCreateSyevjInfo(&g_syevj) != CUSOLVER_STATUS_SUCCESS) return 2;
    if (cusolverDnCreateParams(&g_params) != CUSOLVER_STATUS_SUCCESS) return 3;
  }
  return 0;
}

extern "C" int probe_init(int max_sweeps, double tol) {
  int e = ensure();
  if (e) return e;
  cusolverDnXsyevjSetMaxSweeps(g_syevj, max_sweeps);
  cusolverDnXsyevjSetTolerance(g_syevj, tol);
  return 0;
}

// kind: 0 syevjBatched(batch 1), 1 syevj, 2 syevd, 3 Xsyevd.  Returns the
// device workspace size in bytes (host workspace kept in a static buffer).
extern "C" long long probe_ws(int kind, int n, const void* A, const void* W) {
  if (ensure()) return -1;
  int lwork = 0;
  cusolverStatus_t st;
  switch (kind) {
    case 0:
      st = cusolverDnSsyevjBatched_bufferSize(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                              (const float*)A, n, (const float*)W, &lwork, g_syevj, 1);
      return st == CUSOLVER_STATUS_SUCCESS ? (long long)lwork * 4 : -10 - (int)st;
    case 1:
      st = cusolverDnSsyevj_bufferSize(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                       (const float*)A, n, (const float*)W, &lwork, g_syevj);
      return st == CUSOLVER_STATUS_SUCCESS ? (long long)lwork * 4 : -10 - (int)st;
    case 2:
      st = cusolverDnSsyevd_bufferSize(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                       (const float*)A, n, (const float*)W, &lwork);
      return st == CUSOLVER_STATUS_SUCCESS ? (long long)lwork * 4 : -10 - (int)st;
    case 3: {
      size_t dev = 0, host = 0;
      st = cusolverDnXsyevd_bufferSize(g_handle, g_params, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                                       CUDA_R_32F, A, n, CUDA_R_32F, W, CUDA_R_32F, &dev, &host);
      if (st != CUSOLVER_STATUS_SUCCESS) return -10 - (int)st;
      if (host > g_host_bytes) {
        free(g_host);
        g_host = malloc(host);
        g_host_bytes = host;
      }
      return (long long)dev;
    }
  }
  return -2;
}

extern "C" long long probe_host_bytes() { return (long long)g_host_bytes; }

// Runs the eigensolver in place on A (n x n, overwritten by eigenvectors).
// Returns 1000 * cusolver status + cudaGetLastError().
extern "C" int probe_run(int kind, int n, void* A, void* W, void* work, long long work_bytes, void* info,
                         void* stream) {
  if (ensure()) return -1;
  cusolverDnSetStream(g_handle, (cudaStream_t)stream);
  cusolverStatus_t st = CUSOLVER_STATUS_SUCCESS;
  int lwork = (int)(work_bytes / 4);
  switch (kind) {
    case 0:
      st = cusolverDnSsyevjBatched(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, (float*)A, n,
                                   (float*)W, (float*)work, lwork, (int*)info, g_syevj, 1);
      break;
    case 1:
      st = cusolverDnSsyevj(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, (float*)A, n,
                            (float*)W, (float*)work, lwork, (int*)info, g_syevj);
      break;
    case 2:
      st = cusolverDnSsyevd(g_handle, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, (float*)A, n,
                            (float*)W, (float*)work, lwork, (int*)info);
      break;
    case 3:
      st = cusolverDnXsyevd(g_handle, g_params, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n, CUDA_R_32F,
                            A, n, CUDA_R_32F, W, CUDA_R_32F, work, (size_t)work_bytes, g_host, g_host_bytes,
                            (int*)info);
      break;
  }
  return 1000 * (int)st + (int)cudaGetLastError();
}
