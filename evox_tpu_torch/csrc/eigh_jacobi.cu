// Symmetric eigendecomposition for n > 32 that a CUDA graph can capture: a
// blocked two-sided cyclic Jacobi method, written out without any library.
//
// No TPU kernel is replaced: the JAX package decomposes CMA-ES's covariance
// with jnp.linalg.eigh (evox_tpu/algorithms/so/es_variants/cma_es.py,
// `decompose`) and takes ASEBO's directions from jnp.linalg.svd, XLA
// operations.  On the H100 torch.linalg.eigh reads cuSOLVER's `info` on the
// host and cuSOLVER's syevd/Xsyevd/syevj invalidate a capture; syevjBatched
// (csrc/linalg.cu) captures but stops at n = 32.  This file covers n > 32:
// it launches a fixed sequence of kernels, reads nothing on the host and
// allocates nothing, so an eager call and a replayed graph run the same
// arithmetic and give the same bits (no atomics; every reduction has an
// order fixed by the code).
//
// The algorithm (evox_tpu_torch/ops/linalg.py, `eigh_jacobi_plain`, is the
// same algorithm in PyTorch).  A stack of B symmetric matrices, each padded
// with zero rows and columns to N, a multiple of 2b (b = 32; a padded index
// has no off-diagonal entry, so it never rotates and stays decoupled), is
// cut into N/b column blocks.  A sweep pairs every block with every other
// once, in N/b - 1 rounds of the circle method (round-robin).  A round is
// two launches:
//   solve  one thread block per block pair loads the 2b x 2b sub-matrix of
//          the pair into shared memory in float64 and takes one sweep of
//          scalar cyclic Jacobi over it (63 parallel rounds of 32 disjoint
//          rotations), accumulating the orthogonal J in
//          float64, and stores J in the storage type.  One inner sweep
//          costs the whole solve about one more outer sweep than a full
//          inner diagonalisation (plain version on the CPU, n = 100 and
//          256: 7 against 6, 9 against 8 sweeps) at a third to a half of
//          the solve launches' time;
//   apply  one thread block per 2b x 2b tile of A and of V: A[Pi, Pj] <-
//          Ji^T A[Pi, Pj] Jj and V[Pi, Pj] <- V[Pi, Pj] Jj.  The pairs of a
//          round are disjoint and cover every index, so each tile depends on
//          itself alone and is updated in place.
// After each sweep one launch per matrix computes off(A) in float64 (a
// strided sum then a tree, both in a fixed order); the matrix is done when
// off(A) <= eps sqrt(N) |A|_F or when no pair rotated in the sweep (a pair
// that does not rotate keeps J = I exactly, so the matrix is then a fixed
// point).  Every launch first reads the matrix's `done` flag and the
// optional device predicate `due`, and returns at once when the matrix is
// done or not due.  A rotation of (p, q) is skipped when |a_pq| <=
// max(eps sqrt|a_pp| sqrt|a_qq|, eps |A|_F / 16) (the classic relative test,
// with a floor at the noise the storage type's rounding leaves), eps the
// storage type's.  The inner solve runs in float64 for either storage type:
// in float32 the orthogonality of J, which the similarity transform relies
// on, then loses one rounding instead of one per rotation.
//
// The sweep count is fixed by the caller: 20 in float32 and 32 in float64
// (ops/linalg.py, MAX_SWEEPS).  Measured with the plain version on the CPU
// (one inner sweep), a spread spectrum (condition 1e3) takes 7 to 9 sweeps
// at n = 33 to 256 in float32 and 8 to 11 in float64; a spectrum of three
// values of multiplicity n/3, the slowest case (Jacobi converges only
// linearly until the clusters separate), 9 to 13 in float32 and 14 to 24 in
// float64 (n = 33 to 256).  The caps leave room for n = 1000 and such
// clusters (CMA-ES's C is a multiple of I plus a low-rank update).  A converged matrix's later launches return at once.  The sweeps a
// matrix took and off(A) are left in device memory (flags, norms) and are
// never read on the host here.
//
// What bounds it.  The least work is the rotations', about 9 n^3 operations
// a sweep (chip_smoke.py's eigh_bound: under a millisecond at n = 1000 on
// the CUDA cores).  This first design is latency bound instead: the solve
// launches (63 dependent rounds of two barriers on one block a pair, 16
// blocks at n = 1000) took about 70 % of the device time on the H100, the
// apply launches (a shared-memory product, about 16 N^3 operations a sweep,
// no tensor cores) about 20 %, the off(A) launches (one block a matrix) the
// rest, and a converged or not-due call still runs its fixed sequence of
// empty launches (PERF.md, "The port's own kernels").
//
// Eigenvalues (the diagonal) and eigenvectors (the columns of V) are left
// unsorted; the wrapper sorts them on the device.  Built with --fmad=false
// (ops/_build.py), as every kernel of the port.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBw = 32;              // column block width b
constexpr int kTile = 2 * kBw;       // 64: the sub-matrix of a block pair
constexpr int kLd = kTile + 1;       // shared-memory row stride (no bank conflicts on columns)
constexpr int kThreads = 256;
constexpr int kNormThreads = 1024;
constexpr double kFloorRel = 1.0 / 16.0;

// flags[b * 4 + ...] and norms[b * 2 + ...] of matrix b.
constexpr int kDone = 0, kSweeps = 1, kRotated = 2;
constexpr int kFro = 0, kOff = 1;

__device__ __forceinline__ bool idle(const int* flags, const uint8_t* due, int b) {
  return (due != nullptr && !due[b]) || flags[b * 4 + kDone];
}

// Round r of the circle method over m (even) players: the pair at position i.
__device__ __forceinline__ void pair_of(int m, int r, int i, int* lo, int* hi) {
  const int k = m - 1;
  const int a = i == 0 ? 0 : 1 + (i - 1 + r) % k;
  const int b = 1 + (m - 2 - i + r) % k;  // the partner at position m - 1 - i
  *lo = min(a, b);
  *hi = max(a, b);
}

// Row or column r (0..63) of the sub-matrix of the block pair (lo, hi).
__device__ __forceinline__ int index_of(int lo, int hi, int r) {
  return r < kBw ? lo * kBw + r : hi * kBw + (r - kBw);
}

// off(A) and, with `init`, |A|_F of each matrix; grid (B), kNormThreads.
template <typename T>
__global__ void norms_kernel(const T* __restrict__ W, int N, int* flags, double* norms,
                             const uint8_t* __restrict__ due, int init, double tol) {
  const int b = blockIdx.x;
  if (due != nullptr && !due[b]) return;
  if (!init && flags[b * 4 + kDone]) return;
  __shared__ double s_all[kNormThreads], s_off[kNormThreads];
  const T* A = W + (size_t)b * N * N;
  const long long total = (long long)N * N;
  double all = 0.0, off = 0.0;
  for (long long e = threadIdx.x; e < total; e += kNormThreads) {
    const double v = (double)A[e];
    const double v2 = v * v;
    all += v2;
    if (e / N != e % N) off += v2;
  }
  s_all[threadIdx.x] = all;
  s_off[threadIdx.x] = off;
  __syncthreads();
  for (int s = kNormThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_all[threadIdx.x] += s_all[threadIdx.x + s];
      s_off[threadIdx.x] += s_off[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double o = sqrt(s_off[0]);
    int* f = flags + b * 4;
    if (init) {
      const double fro = sqrt(s_all[0]);
      norms[b * 2 + kFro] = fro;
      f[kSweeps] = 0;
      f[kRotated] = 0;
      f[kDone] = o <= tol * fro;
    } else {
      f[kSweeps] += 1;
      f[kDone] = o <= tol * norms[b * 2 + kFro] || !f[kRotated];
      f[kRotated] = 0;
    }
    norms[b * 2 + kOff] = o;
  }
}

// Diagonalise each block pair's sub-matrix of round r: J into Jbuf (B, N/64,
// 64, 64).  Grid (N/64, 1, B), kThreads, 2 * 64 * kLd doubles of dynamic
// shared memory.
template <typename T>
__global__ void solve_kernel(const T* __restrict__ W, T* __restrict__ Jbuf, int N, int r, int* flags,
                             const double* __restrict__ norms, const uint8_t* __restrict__ due, double eps) {
  const int b = blockIdx.z;
  if (idle(flags, due, b)) return;
  extern __shared__ double smem[];
  double* S = smem;
  double* J = smem + kTile * kLd;
  __shared__ double s_c[kTile / 2], s_s[kTile / 2], s_pp[kTile / 2], s_qq[kTile / 2];
  __shared__ int s_p[kTile / 2], s_q[kTile / 2], s_rot[kTile / 2];

  const int nb = N / kBw;
  int lo, hi;
  pair_of(nb, r, blockIdx.x, &lo, &hi);
  const T* A = W + (size_t)b * N * N;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    S[i * kLd + j] = (double)A[(size_t)index_of(lo, hi, i) * N + index_of(lo, hi, j)];
    J[i * kLd + j] = i == j ? 1.0 : 0.0;
  }
  const double floor_abs = eps * norms[b * 2 + kFro] * kFloorRel;
  __syncthreads();

  // One sweep of scalar Jacobi: 63 rounds of 32 disjoint rotations.
  int any = 0;
  for (int k = 0; k < kTile - 1; ++k) {
    if (threadIdx.x < kTile / 2) {
      int p, q;
      pair_of(kTile, k, threadIdx.x, &p, &q);
      const double app = S[p * kLd + p], aqq = S[q * kLd + q], apq = S[p * kLd + q];
      const double thr = fmax(eps * sqrt(fabs(app)) * sqrt(fabs(aqq)), floor_abs);
      const int rot = fabs(apq) > thr;
      double c = 1.0, s = 0.0, t = 0.0;
      if (rot) {
        const double theta = (aqq - app) / (2.0 * apq);
        t = copysign(1.0 / (fabs(theta) + hypot(1.0, theta)), theta);
        c = 1.0 / sqrt(1.0 + t * t);
        s = t * c;
      }
      s_c[threadIdx.x] = c;
      s_s[threadIdx.x] = s;
      s_pp[threadIdx.x] = app - t * apq;
      s_qq[threadIdx.x] = aqq + t * apq;
      s_p[threadIdx.x] = p;
      s_q[threadIdx.x] = q;
      s_rot[threadIdx.x] = rot;
      any |= rot;
    }
    __syncthreads();
    // S <- R^T S R a 2 x 2 block (the rows of pair m, the columns of pair
    // n) a thread: the row rotation, then the column one, the operations
    // of a row pass followed by a column pass; a pair's own block takes
    // its exact values (a_pq = 0).  Then J <- J R, columns p and q.
    for (int e = threadIdx.x; e < (kTile / 2) * (kTile / 2); e += kThreads) {
      const int m = e / (kTile / 2), n = e % (kTile / 2);
      if (!s_rot[m] && !s_rot[n]) continue;
      const int pm = s_p[m], qm = s_q[m], pn = s_p[n], qn = s_q[n];
      if (m == n) {
        S[pm * kLd + pm] = s_pp[m];
        S[pm * kLd + qm] = 0.0;
        S[qm * kLd + pm] = 0.0;
        S[qm * kLd + qm] = s_qq[m];
        continue;
      }
      const double cm = s_c[m], sm = s_s[m], cn = s_c[n], sn = s_s[n];
      const double x00 = S[pm * kLd + pn], x01 = S[pm * kLd + qn];
      const double x10 = S[qm * kLd + pn], x11 = S[qm * kLd + qn];
      const double y00 = cm * x00 - sm * x10, y01 = cm * x01 - sm * x11;
      const double y10 = sm * x00 + cm * x10, y11 = sm * x01 + cm * x11;
      S[pm * kLd + pn] = cn * y00 - sn * y01;
      S[pm * kLd + qn] = sn * y00 + cn * y01;
      S[qm * kLd + pn] = cn * y10 - sn * y11;
      S[qm * kLd + qn] = sn * y10 + cn * y11;
    }
    for (int e = threadIdx.x; e < kTile / 2 * kTile; e += kThreads) {
      const int n = e / kTile, i = e % kTile;
      if (!s_rot[n]) continue;
      const int p = s_p[n], q = s_q[n];
      const double c = s_c[n], s = s_s[n];
      const double jp = J[i * kLd + p], jq = J[i * kLd + q];
      J[i * kLd + p] = c * jp - s * jq;
      J[i * kLd + q] = s * jp + c * jq;
    }
    __syncthreads();
  }
  // Every block that rotated stores the same value: no atomics needed.
  if (__syncthreads_or(any) && threadIdx.x == 0) flags[b * 4 + kRotated] = 1;
  T* Jout = Jbuf + ((size_t)b * (N / kTile) + blockIdx.x) * kTile * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) Jout[e] = (T)J[(e / kTile) * kLd + e % kTile];
}

// A[Pi, Pj] <- Ji^T A[Pi, Pj] Jj (blockIdx.y < P) and V[Pi, Pj] <- V[Pi, Pj] Jj
// (blockIdx.y >= P) for round r.  Grid (P, 2P, B), 16 x 16 threads, each 4 x 4
// outputs; 2 * 64 * kLd values of T of dynamic shared memory.
template <typename T>
__global__ void apply_kernel(T* __restrict__ W, T* __restrict__ V, const T* __restrict__ Jbuf, int N, int r,
                             const int* flags, const uint8_t* __restrict__ due) {
  const int b = blockIdx.z;
  if (idle(flags, due, b)) return;
  extern __shared__ unsigned char smem_raw[];
  T* X = reinterpret_cast<T*>(smem_raw);
  T* Y = X + kTile * kLd;
  const int P = N / kTile, nb = N / kBw;
  const bool vec = blockIdx.y >= P;
  const int pi = blockIdx.x, pj = vec ? blockIdx.y - P : blockIdx.y;
  int ilo, ihi, jlo, jhi;
  pair_of(nb, r, pi, &ilo, &ihi);
  pair_of(nb, r, pj, &jlo, &jhi);
  T* M = (vec ? V : W) + (size_t)b * N * N;
  const T* Jj = Jbuf + ((size_t)b * P + pj) * kTile * kTile;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    X[i * kLd + j] = M[(size_t)index_of(ilo, ihi, i) * N + index_of(jlo, jhi, j)];
    Y[i * kLd + j] = Jj[e];
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0;
  for (int k = 0; k < kTile; ++k) {
    T x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = X[(ty + 16 * a) * kLd + k];
    for (int c = 0; c < 4; ++c) y[c] = Y[k * kLd + tx + 16 * c];
    for (int a = 0; a < 4; ++a)
      for (int c = 0; c < 4; ++c) acc[a][c] += x[a] * y[c];
  }
  if (!vec) {
    // T = A Jj into X, then Ji^T T.
    const T* Ji = Jbuf + ((size_t)b * P + pi) * kTile * kTile;
    __syncthreads();
    for (int a = 0; a < 4; ++a)
      for (int c = 0; c < 4; ++c) X[(ty + 16 * a) * kLd + tx + 16 * c] = acc[a][c];
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) Y[(e / kTile) * kLd + e % kTile] = Ji[e];
    __syncthreads();
    for (int a = 0; a < 4; ++a)
      for (int c = 0; c < 4; ++c) acc[a][c] = 0;
    for (int k = 0; k < kTile; ++k) {
      T x[4], y[4];
      for (int a = 0; a < 4; ++a) x[a] = Y[k * kLd + ty + 16 * a];
      for (int c = 0; c < 4; ++c) y[c] = X[k * kLd + tx + 16 * c];
      for (int a = 0; a < 4; ++a)
        for (int c = 0; c < 4; ++c) acc[a][c] += x[a] * y[c];
    }
  }
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c)
      M[(size_t)index_of(ilo, ihi, ty + 16 * a) * N + index_of(jlo, jhi, tx + 16 * c)] = acc[a][c];
}

template <typename T>
int run(T* W, T* V, T* J, int* flags, double* norms, const uint8_t* due, int N, int batch, int max_sweeps,
        double eps, double tol, cudaStream_t stream) {
  const int P = N / kTile, nb = N / kBw;
  const size_t solve_smem = 2 * kTile * kLd * sizeof(double);
  const size_t apply_smem = 2 * kTile * kLd * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)solve_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)apply_smem);
  if (err != cudaSuccess) return (int)err;
  norms_kernel<T><<<batch, kNormThreads, 0, stream>>>(W, N, flags, norms, due, 1, tol);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    for (int r = 0; r < nb - 1; ++r) {
      solve_kernel<T><<<dim3(P, 1, batch), kThreads, solve_smem, stream>>>(W, J, N, r, flags, norms, due, eps);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      apply_kernel<T><<<dim3(P, 2 * P, batch), kThreads, apply_smem, stream>>>(W, V, J, N, r, flags, due);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    norms_kernel<T><<<batch, kNormThreads, 0, stream>>>(W, N, flags, norms, due, 0, tol);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// The Jacobi sweeps over `batch` padded n_pad x n_pad matrices W (row-major,
// overwritten: its diagonal ends as the eigenvalues) with V (the identity on
// entry, overwritten by the eigenvectors in its columns), on `stream`.  J is
// scratch of batch * n_pad * 64 values (a 64 x 64 J per block pair); flags (int32, batch x 4: done,
// sweeps, rotated, unused) must be zero on entry; norms (float64, batch x 2:
// |A|_F, off(A)); due (one byte a matrix) may be null.  `f64` picks double
// storage.  Returns 0, or the CUDA error of the first refused launch.
extern "C" int eigh_jacobi(void* W, void* V, void* J, void* flags, void* norms, const void* due, int n_pad,
                           int batch, int f64, int max_sweeps, double eps, double tol, void* stream) {
  if (n_pad <= 0 || n_pad % kTile != 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return run<double>((double*)W, (double*)V, (double*)J, (int*)flags, (double*)norms, (const uint8_t*)due,
                       n_pad, batch, max_sweeps, eps, tol, s);
  return run<float>((float*)W, (float*)V, (float*)J, (int*)flags, (double*)norms, (const uint8_t*)due, n_pad,
                    batch, max_sweeps, eps, tol, s);
}
