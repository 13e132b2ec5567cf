// Symmetric eigendecomposition for n > 32 that a CUDA graph can capture: a
// blocked two-sided cyclic Jacobi method, written out without any library.
//
// No TPU kernel is replaced: the JAX package decomposes CMA-ES's covariance
// with jnp.linalg.eigh (evox_tpu/algorithms/so/es_variants/cma_es.py,
// `decompose`) and takes ASEBO's directions from jnp.linalg.svd, XLA
// operations.  On the H100 torch.linalg.eigh reads cuSOLVER's `info` on the
// host and cuSOLVER's syevd/Xsyevd/syevj invalidate a capture; syevjBatched
// (csrc/linalg.cu) captures but stops at n = 32.  This file covers n > 32:
// one cooperative kernel launch a call, which reads nothing on the host and
// allocates nothing, so an eager call and a replayed graph run the same
// arithmetic and give the same bits (no atomics; every sum has an order
// fixed by the code, and no value depends on the grid's size or on which
// block computes it).
//
// The algorithm (evox_tpu_torch/ops/linalg.py, `eigh_jacobi_plain`, is the
// same arithmetic in PyTorch, operation for operation).  A stack of B
// symmetric matrices (the wrapper mirrors each lower triangle), each padded
// with zero rows and columns to N, a multiple of 2b (b = 32; a padded index
// has no off-diagonal entry, so it never rotates and stays decoupled), is
// cut into N/b column blocks.  A sweep pairs every block with every other
// once, in N/b - 1 rounds of the circle method (round-robin).  A round:
//   solve  the 2b x 2b sub-matrix of each block pair, in float64, takes one
//          sweep of scalar cyclic Jacobi (63 inner rounds of 32 disjoint
//          rotations), which accumulate into the orthogonal J, stored in the
//          storage type.  A pair whose sub-matrix has no entry above the
//          rotation test keeps J = I without its 63 rounds (the same bits:
//          none of them would rotate);
//   apply  each 2b x 2b tile (i, j), i <= j, of A: A[Pi, Pj] <- Ji^T A[Pi,
//          Pj] Jj, its transpose into A[Pj, Pi] (A stays exactly
//          symmetric); each tile of V: V[Pi, Pj] <- V[Pi, Pj] Jj.  A product
//          with J = I is skipped (its values are the other factor's).  The
//          pairs of a round are disjoint and cover every index, so each
//          tile depends on itself alone and is updated in place.
// After each sweep off(A) in float64 (below) sets the matrix's `done` flag:
// off(A) <= eps sqrt(N) |A|_F, or no pair rotated in the sweep (a pair that
// does not rotate keeps J = I exactly, so the matrix is then a fixed
// point).  A rotation of (p, q) is skipped when |a_pq| <= max(eps
// sqrt|a_pp| sqrt|a_qq|, eps |A|_F / 16) (the classic relative test, with a
// floor at the noise the storage type's rounding leaves), eps the storage
// type's; it has t = sign(theta) / (|theta| + sqrt(1 + theta^2)), theta =
// (a_qq - a_pp) / (2 a_pq), c = 1 / sqrt(1 + t^2), s = t c.  The inner solve
// runs in float64 for either storage type: in float32 the orthogonality of
// J, which the similarity transform relies on, then loses one rounding
// instead of one per rotation.  Pairs that do not rotate take c = 1, s = 0
// through the same operations.
//
// The sweep count is capped by the caller: 20 in float32 and 32 in float64
// (ops/linalg.py, MAX_SWEEPS).  Measured with the plain version on the CPU
// (one inner sweep), a spread spectrum (condition 1e3) takes 7 to 9 sweeps
// at n = 33 to 256 in float32 and 8 to 11 in float64; a spectrum of three
// values of multiplicity n/3, the slowest case (Jacobi converges only
// linearly until the clusters separate), 9 to 13 in float32 and 14 to 24 in
// float64 (n = 33 to 256).  The caps leave room for n = 1000 and such
// clusters (CMA-ES's C is a multiple of I plus a low-rank update).  The
// sweeps a matrix took and off(A) are left in device memory (flags, norms)
// and are never read on the host here.
//
// The order of every sum.  A product of the apply adds k = 0..63 from 0,
// one rounding a product and one a sum (built with --fmad=false, as every
// kernel of the port).  |A|_F and off(A): each 64 x 64 tile (row-major over
// the (N/64)^2 tiles) is summed by kThreads threads, thread t the squares
// of its entries t, t + kThreads, ... in that order, then a tree over the
// threads (t += t + s for s = kThreads/2, ..., 1); one thread adds the
// tiles' sums in row-major order and takes the square root.  Every divide
// and square root is IEEE-rounded, so the plain version run on the card
// gives the kernel's bits.
//
// The launch.  One cooperative kernel, every block resident (the wrapper
// sizes the grid from the occupancy query, at most 2 B (N/64)^2 blocks),
// walks the whole decomposition in phases separated by grid barriers:
//   the tiles' sums of squares | |A|_F, off(A), done (a block a matrix) |
//   per sweep, per round r: each pair's solver and J block, the other
//   blocks V(r - 1) | A(r) | then V(last round) beside the tiles' off(A) |
//   off(A), done.
// Every block reads `done` and `due` after the same barrier, so all leave
// together: a converged matrix drops out of the work lists while the rest
// of a batch goes on, the launch ends when every matrix is done or at the
// cap, and a call with no matrix due returns at once.
//
// What bounds it.  The least work is the rotations', about 12 n^3
// operations a sweep (chip_smoke.py's eigh_bound: under a millisecond at
// n = 1000).  This design is bound by latency: a round waits for its pair
// solves, 63 dependent inner rounds on one SM each (N/64 pairs: 16 of 132
// SMs at N = 1024), then for the apply.  What it does about that:
//   - one launch a call instead of the host-driven sequence of 1 + sweeps x
//     (2 (N/32 - 1) + 1) launches (1,261 at n = 1000 in float32, each
//     returning at once when the matrix was done or not due);
//   - an inner round has one barrier: warp 0 computes the next round's
//     rotations (each lane the three entries its pair needs, by the update's
//     operations) while the warps outside its scheduler partition update S
//     from one buffer into the other, both kept in the round's order (a
//     pair's p and q side by side, the upper triangle only: 528 of 1,024
//     2 x 2 blocks, vector loads without bank conflicts);
//   - J, a full 64 x 64 float64 read and write an inner round, is built on
//     a second SM: warp 4 of the solver publishes each round's rotations to
//     global memory (stores, a fence, a round count) and the pair's J
//     block applies them as they come (a bounded poll: a fault gives wrong
//     values, never a hang);
//   - pairs and products whose J is I are skipped; V's tiles, which no solve
//     reads, are applied during the next round by the blocks that hold no
//     pair; each half of a block applies its own tile; off(A) is summed over
//     the whole grid.
//
// Eigenvalues (the diagonal) and eigenvectors (the columns of V) are left
// unsorted; the wrapper sorts them on the device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBw = 32;                            // column block width b
constexpr int kTile = 2 * kBw;                     // 64: the sub-matrix of a block pair
constexpr int kLd = kTile + 1;                     // shared-memory row stride (no bank conflicts on columns)
constexpr int kPairs = kTile / 2;                  // 32 disjoint pairs in an inner round
constexpr int kUpper = kPairs * (kPairs - 1) / 2;  // 496 2 x 2 blocks above the diagonal
constexpr int kThreads = 512;                      // a block; the order of the sums of squares
constexpr int kHalf = kThreads / 2;                // the apply's half-block: a tile, 16 x 16 threads of 4 x 4 outputs
constexpr double kFloorRel = 1.0 / 16.0;

// flags[b * 4 + ...] and norms[b * 2 + ...] of matrix b.
constexpr int kDone = 0, kSweeps = 1, kRotated = 2;
constexpr int kFro = 0, kOff = 1;

// The solver's shared memory: S of the current and of the next inner round
// (64 x kLdS doubles each, rows 16-byte aligned for double2 loads), the
// square roots of S's diagonal, and two rounds' rotations (c, s, the new
// a_pp and a_qq and their square roots; whether it rotates).  The J
// block's: J of the current and of the next round, the 63 rounds' (c, s),
// and a word.
constexpr int kLdS = kTile + 2;
constexpr int kRounds = kTile - 1;
constexpr size_t kSolverBytes = (2 * kTile * kLdS + kTile + 6 * 2 * kPairs) * sizeof(double) + 2 * kPairs * sizeof(int);
constexpr size_t kJBlockBytes = (2 * kTile * kLdS + 2 * kRounds * kPairs) * sizeof(double) + sizeof(int);
constexpr size_t kSolveBytes = kSolverBytes > kJBlockBytes ? kSolverBytes : kJBlockBytes;
// A J block's polls of its solver's progress before it goes on regardless
// (a correct solver is never that late; the bound only keeps a fault from
// hanging the card).
constexpr long long kSpinLimit = 1LL << 24;
// A half-block's tiles (64 x kLd each): a tile of A or V, and a J.
constexpr size_t kHalfTiles = 2 * kTile * kLd;
constexpr size_t kApplyBytes = 2 * kHalfTiles * sizeof(double);
constexpr size_t kNormBytes = 2 * kThreads * sizeof(double);
constexpr size_t kSmem = kSolveBytes > kApplyBytes ? (kSolveBytes > kNormBytes ? kSolveBytes : kNormBytes)
                                                   : (kApplyBytes > kNormBytes ? kApplyBytes : kNormBytes);

// The inner rounds' layouts, in static shared memory, made once a launch.
// In inner round k the players (rows and columns 0..63 of the sub-matrix)
// of the pair at position m sit at positions 2m (p, the smaller) and
// 2m + 1 (q): pos0[x] is the position of player x in round 0, next[k][u]
// the position in round k + 1 of the player at position u of round k (of
// the last round, the player itself), look[k][u] the position in round k
// of the player at position u of round k + 1; upper[e] the e-th 2 x 2
// block (m, n), m < n.
struct Rounds {
  uint16_t upper[kUpper];
  uint8_t pos0[kTile];
  uint8_t next[kTile - 1][kTile];
  uint8_t look[kTile - 2][kTile];
};

template <typename T>
struct Problem {
  T* W;             // (B, N, N), overwritten: its diagonal ends as the eigenvalues
  T* V;             // (B, N, N), the identity on entry, overwritten by the eigenvectors
  T* J;             // (B, 2, N/64, 64, 64): each pair's J of the last two rounds
  double* part;     // (B, (N/64)^2, 2): each tile's sums of squares (all, off the diagonal)
  uint8_t* rot;     // (B, 2, N/64): whether each pair of the last two rounds rotated
  double2* cs;      // (B, N/64, 63, 32): each pair's inner rotations (c, s), the solver's to its J block
  int* ready;       // (B, N/64): the solver's progress, 128 epoch + rounds published (127: skipped)
  int* flags;       // (B, 4): done, sweeps, rotated, unused
  double* norms;    // (B, 2): |A|_F, off(A)
  const uint8_t* due;  // (B) or null
  int N, B, max_sweeps;
  double eps, tol;
};

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

// Data another block wrote in this launch is read through L2 (__ldcg): an
// SM's L1 may hold a line from before the last grid barrier.
template <typename T>
__device__ __forceinline__ bool idle(const Problem<T>& pb, int b) {
  return (pb.due != nullptr && !pb.due[b]) || __ldcg(pb.flags + b * 4 + kDone);
}

// Matrix b's tile t (row-major over the (N/64)^2 tiles of 64 x 64): the
// sums of squares of all its entries and of those off the diagonal, in
// float64, in the fixed order of the header note.
template <typename T>
__device__ __forceinline__ void tile_norms(const Problem<T>& pb, int b, int t, double* red) {
  const int N = pb.N, P = N / kTile;
  const int ti = t / P, tj = t % P;
  const T* A = pb.W + (size_t)b * N * N + (size_t)ti * kTile * N + tj * kTile;
  double all = 0.0, off = 0.0;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    const double v = (double)__ldcg(A + (size_t)r * N + c);
    const double v2 = v * v;
    all += v2;
    if (ti != tj || r != c) off += v2;
  }
  red[threadIdx.x] = all;
  red[kThreads + threadIdx.x] = off;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] += red[threadIdx.x + s];
      red[kThreads + threadIdx.x] += red[kThreads + threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double* out = pb.part + ((size_t)b * P * P + t) * 2;
    out[0] = red[0];
    out[1] = red[kThreads];
  }
  __syncthreads();
}

// Matrix b's |A|_F (with `init`) and off(A) from its tiles' sums, and the
// done flag; one thread.
template <typename T>
__device__ __forceinline__ void finish_norms(const Problem<T>& pb, int b, bool init) {
  const int P = pb.N / kTile;
  const double* part = pb.part + (size_t)b * P * P * 2;
  double all = 0.0, off = 0.0;
  for (int t = 0; t < P * P; ++t) {
    all += __ldcg(part + 2 * t);
    off += __ldcg(part + 2 * t + 1);
  }
  const double o = sqrt(off);
  int* f = pb.flags + b * 4;
  if (init) {
    const double fro = sqrt(all);
    pb.norms[b * 2 + kFro] = fro;
    f[kSweeps] = 0;
    f[kRotated] = 0;
    f[kDone] = o <= pb.tol * fro;
  } else {
    f[kSweeps] += 1;
    f[kDone] = o <= pb.tol * __ldcg(pb.norms + b * 2 + kFro) || !__ldcg(f + kRotated);
    f[kRotated] = 0;
  }
  pb.norms[b * 2 + kOff] = o;
}

// Position (u, v) of the upper triangle of a sub-matrix stored in round
// order (each round's S holds only u <= v).
__device__ __forceinline__ int at(int u, int v) { return u <= v ? u * kLdS + v : v * kLdS + u; }

// The rotation of (p, q) from a_pp, a_qq, a_pq and sqrt|a_pp|, sqrt|a_qq|:
// (c, s), the new a_pp and a_qq, and whether it rotates (|a_pq| above
// max(eps sqrt|a_pp| sqrt|a_qq|, floor)); c = 1, s = 0 and a_pp, a_qq kept
// where it does not.
__device__ __forceinline__ int rotation(double app, double aqq, double apq, double rpp, double rqq, double eps,
                                        double floor_abs, double* c, double* s, double* pp, double* qq) {
  const double thr = fmax(eps * rpp * rqq, floor_abs);
  const int rot = fabs(apq) > thr;
  double t = 0.0;
  *c = 1.0;
  *s = 0.0;
  if (rot) {
    const double theta = (aqq - app) / (2.0 * apq);
    t = copysign(1.0 / (fabs(theta) + sqrt(1.0 + theta * theta)), theta);
    *c = 1.0 / sqrt(1.0 + t * t);
    *s = t * *c;
  }
  *pp = app - t * apq;
  *qq = aqq + t * apq;
  return rot;
}

// Row a of the rows' rotation (c, s) then column b of the columns' (cc,
// sc) of the 2 x 2 block x: entry (a, b) of R^T x R, the order of
// operations of the whole block's update.
__device__ __forceinline__ double rotated_entry(double x00, double x01, double x10, double x11, double c, double s,
                                                double cc, double sc, int a, int b) {
  const double y0 = a ? s * x00 + c * x10 : c * x00 - s * x10;
  const double y1 = a ? s * x01 + c * x11 : c * x01 - s * x11;
  return b ? sc * y0 + cc * y1 : cc * y0 - sc * y1;
}

// The warps of an inner round: warp 0 computes the next round's rotations;
// the warps outside its scheduler partition (warp % 4 != 0) update S, so
// that warp 0's dependent chain issues alone; warp 4 publishes each round's
// rotations to the pair's J block.
constexpr int kWarps = kThreads / 32;
constexpr int kWorkerWarps = kWarps - kWarps / 4;
constexpr int kWorkers = 32 * kWorkerWarps;
constexpr int kUSlots = (kUpper + kPairs + kWorkers - 1) / kWorkers;
constexpr int kPublisher = 4;

__device__ __forceinline__ int worker_warp(int warp) { return warp % 4 ? warp - warp / 4 - 1 : -1; }

// S <- R^T S R of one inner round on this thread's 2 x 2 blocks `mine`
// (m << 8 | n, m < n: the row rotation, then the column one; 0x8000 | m: a
// pair's own block, which takes the new a_pp and a_qq and a_pq = 0 where
// it rotates; -1: none), from round k's S `Sc` into round k + 1's `Sn` in
// its order (`to`).  Pairs that do not rotate have c = 1 and s = 0: the
// same operations, as the plain version.  Every load of a thread's blocks
// is made before its stores.
__device__ __forceinline__ void update_s(const double* Sc, double* Sn, const uint8_t* to, const int* mine,
                                         const double* pc, const double* ps, const double* ppp,
                                         const double* pqq, const int* ir) {
  double z[kUSlots][4];
  int u0[kUSlots], u1[kUSlots], v0[kUSlots], v1[kUSlots];
#pragma unroll
  for (int u = 0; u < kUSlots; ++u) {
    const int e = mine[u];
    if (e < 0) continue;
    if (!(e & 0x8000)) {
      const int mm = e >> 8, nn = e & 0xff;
      const double2 r0 = *reinterpret_cast<const double2*>(Sc + 2 * mm * kLdS + 2 * nn);
      const double2 r1 = *reinterpret_cast<const double2*>(Sc + (2 * mm + 1) * kLdS + 2 * nn);
      const double cm = pc[mm], sm = ps[mm], cn = pc[nn], sn = ps[nn];
      const double y00 = cm * r0.x - sm * r1.x, y01 = cm * r0.y - sm * r1.y;
      const double y10 = sm * r0.x + cm * r1.x, y11 = sm * r0.y + cm * r1.y;
      z[u][0] = cn * y00 - sn * y01;
      z[u][1] = sn * y00 + cn * y01;
      z[u][2] = cn * y10 - sn * y11;
      z[u][3] = sn * y10 + cn * y11;
      u0[u] = to[2 * mm];
      u1[u] = to[2 * mm + 1];
      v0[u] = to[2 * nn];
      v1[u] = to[2 * nn + 1];
    } else {
      const int mm = e & 0xff;
      z[u][0] = ppp[mm];
      z[u][1] = ir[mm] ? 0.0 : Sc[2 * mm * kLdS + 2 * mm + 1];
      z[u][3] = pqq[mm];
      u0[u] = v0[u] = to[2 * mm];
      u1[u] = v1[u] = to[2 * mm + 1];
    }
  }
#pragma unroll
  for (int u = 0; u < kUSlots; ++u) {
    const int e = mine[u];
    if (e < 0) continue;
    Sn[at(u0[u], v0[u])] = z[u][0];
    Sn[at(u0[u], v1[u])] = z[u][1];
    Sn[at(u1[u], v1[u])] = z[u][3];
    if (!(e & 0x8000)) Sn[at(u1[u], v0[u])] = z[u][2];
  }
}

// J <- J R of one inner round, J's columns in the round's order (`Jc`)
// into the next round's (`Jn`, `to`): pair n (this thread's lane), (c, s)
// its rotation, on rows row0, row0 + 16, ... (row0 this thread's warp).
__device__ __forceinline__ void rotate_j(const double* Jc, double* Jn, const uint8_t* to, int row0, int n, double2 cs) {
  const int t0 = to[2 * n], t1 = to[2 * n + 1];
  constexpr int kRows = kTile / kWarps;
  double2 j[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) j[u] = *reinterpret_cast<const double2*>(Jc + (row0 + u * kWarps) * kLdS + 2 * n);
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = row0 + u * kWarps;
    Jn[i * kLdS + t0] = cs.x * j[u].x - cs.y * j[u].y;
    Jn[i * kLdS + t1] = cs.y * j[u].x + cs.x * j[u].y;
  }
}

// The rotation (c, s) of the pair at each lane of the calling warp for
// inner round k, published to the pair's J block: every lane's store, a
// fence, then the round count (128 epoch + k + 1).
__device__ __forceinline__ void publish(double2* cs, volatile int* ready, int epoch, int k, double c, double s) {
  const int lane = threadIdx.x & 31;
  cs[k * kPairs + lane] = make_double2(c, s);
  __threadfence();
  __syncwarp();
  if (lane == 0) *ready = 128 * epoch + k + 1;
}

// Diagonalise the sub-matrix of matrix b's pair at position m of round r
// (outer round `epoch` of the launch): its inner rotations to its J
// block (accumulate_j), whether it rotated into rot[b, r % 2, m].
//
// One sweep of scalar Jacobi: 63 inner rounds of 32 disjoint rotations,
// one barrier each.  S is kept in the round's order (a pair's p and q side
// by side, the upper triangle only) in two buffers: in round k the worker
// warps update S from round k's buffer into round k + 1's, in round k + 1's
// order, while warp 0 computes round k + 1's rotations from round k's
// buffer (each lane the three entries its pair needs, by the same
// operations as the update) and publishes them.
template <typename T>
__device__ __forceinline__ void solve_pair(const Problem<T>& pb, int b, int r, int m, int epoch, double* smem,
                                           const Rounds& rd) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = pb.N, P = N / kTile;
  double* Sb = smem;  // [2][64 x kLdS]
  double* sd = Sb + 2 * kTile * kLdS;
  double* pc = sd + kTile;  // [2][kPairs] each
  double* ps = pc + 2 * kPairs;
  double* ppp = ps + 2 * kPairs;
  double* pqq = ppp + 2 * kPairs;
  double* rpp = pqq + 2 * kPairs;  // sqrt|a_pp|, sqrt|a_qq| of the new diagonal
  double* rqq = rpp + 2 * kPairs;
  int* ir = reinterpret_cast<int*>(rqq + 2 * kPairs);
  double2* cs = pb.cs + ((size_t)b * P + m) * kRounds * kPairs;
  volatile int* ready = pb.ready + (size_t)b * P + m;

  int lo, hi;
  pair_of(N / kBw, r, m, &lo, &hi);
  const T* A = pb.W + (size_t)b * N * N;
  if (tid < kTile) {
    const int g = index_of(lo, hi, tid);
    sd[tid] = sqrt(fabs((double)__ldcg(A + (size_t)g * N + g)));
  }
  const double eps = pb.eps;
  const double floor_abs = eps * __ldcg(pb.norms + b * 2 + kFro) * kFloorRel;
  __syncthreads();
  // S into round 0's order; the rotation test of every (p, q), p < q, on
  // the entries as loaded: where none passes, none of the 63 rounds rotates.
  int above = 0;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    const double v = (double)__ldcg(A + (size_t)index_of(lo, hi, i) * N + index_of(lo, hi, j));
    const int u = rd.pos0[i], w = rd.pos0[j];
    if (u <= w) Sb[u * kLdS + w] = v;
    if (i < j) above |= fabs(v) > fmax(eps * sd[i] * sd[j], floor_abs);
  }
  int any = 0;
  if (__syncthreads_or(above)) {
    // This thread's S blocks, fixed for the solve.
    const int ww = worker_warp(warp);
    int mine[kUSlots];
#pragma unroll
    for (int u = 0; u < kUSlots; ++u) {
      const int e = ww * 32 + lane + u * kWorkers;
      mine[u] = ww < 0 || e >= kUpper + kPairs ? -1 : e < kUpper ? rd.upper[e] : 0x8000 | (e - kUpper);
    }
    if (warp == 0) {
      int p, q;
      pair_of(kTile, 0, lane, &p, &q);
      double c, s, pp, qq;
      const int rot = rotation(Sb[2 * lane * kLdS + 2 * lane], Sb[(2 * lane + 1) * kLdS + 2 * lane + 1],
                               Sb[2 * lane * kLdS + 2 * lane + 1], sd[p], sd[q], eps, floor_abs, &c, &s, &pp, &qq);
      pc[lane] = c;
      ps[lane] = s;
      ppp[lane] = pp;
      pqq[lane] = qq;
      rpp[lane] = sqrt(fabs(pp));
      rqq[lane] = sqrt(fabs(qq));
      ir[lane] = rot;
      any |= rot;
    }
    __syncthreads();
    for (int k = 0; k < kRounds - 1; ++k) {
      const int cur = (k & 1) * kPairs, nxt = kPairs - cur;
      const double* Sc = Sb + (k & 1) * kTile * kLdS;
      double* Sn = Sb + ((k + 1) & 1) * kTile * kLdS;
      if (warp == 0) {
        // Round k + 1's pair at position `lane`: its players' positions in
        // round k, then a_pp, a_qq and a_pq after round k.
        const int P1 = rd.look[k][2 * lane], Q1 = rd.look[k][2 * lane + 1];
        const int m1 = P1 >> 1, n1 = Q1 >> 1;
        const double app = P1 & 1 ? pqq[cur + m1] : ppp[cur + m1];
        const double aqq = Q1 & 1 ? pqq[cur + n1] : ppp[cur + n1];
        const double sqp = P1 & 1 ? rqq[cur + m1] : rpp[cur + m1];
        const double sqq = Q1 & 1 ? rqq[cur + n1] : rpp[cur + n1];
        // Block (lo, hi) of round k holds a_pq as its entry (ra, cb).
        const int lo1 = min(m1, n1), hi1 = max(m1, n1);
        const int ra = m1 < n1 ? P1 & 1 : Q1 & 1, cb = m1 < n1 ? Q1 & 1 : P1 & 1;
        const double* row = Sc + 2 * lo1 * kLdS + 2 * hi1;
        const double apq = rotated_entry(row[0], row[1], row[kLdS], row[kLdS + 1], pc[cur + lo1], ps[cur + lo1],
                                         pc[cur + hi1], ps[cur + hi1], ra, cb);
        double c, s, pp, qq;
        const int rot = rotation(app, aqq, apq, sqp, sqq, eps, floor_abs, &c, &s, &pp, &qq);
        pc[nxt + lane] = c;
        ps[nxt + lane] = s;
        ppp[nxt + lane] = pp;
        pqq[nxt + lane] = qq;
        rpp[nxt + lane] = sqrt(fabs(pp));
        rqq[nxt + lane] = sqrt(fabs(qq));
        ir[nxt + lane] = rot;
        any |= rot;
      } else if (ww >= 0) {
        update_s(Sc, Sn, rd.next[k], mine, pc + cur, ps + cur, ppp + cur, pqq + cur, ir + cur);
      } else if (warp == kPublisher) {
        publish(cs, ready, epoch, k, pc[cur + lane], ps[cur + lane]);
      }
      __syncthreads();
    }
    if (warp == kPublisher) publish(cs, ready, epoch, kRounds - 1, pc[lane], ps[lane]);  // round 62's, buffer 0
  } else if (tid == 0) {
    *ready = 128 * epoch + 127;  // skipped: J = I
  }
  any = __syncthreads_or(any);
  if (tid == 0) {
    pb.rot[((size_t)b * 2 + (r & 1)) * P + m] = any;
    if (any) pb.flags[b * 4 + kRotated] = 1;  // every pair that rotated stores the same value
  }
  __syncthreads();
}

// J of matrix b's pair at position m of round r, from the rotations its
// solver publishes (outer round `epoch`): J <- J R for each inner round as
// soon as it is published (the rounds published since the last look,
// staged in shared memory, then applied in turn), J's columns kept in the
// round's order in two buffers, then J into J[b, r % 2, m] in the storage
// type.  J = I where the solver skipped its rounds.
template <typename T>
__device__ __forceinline__ void accumulate_j(const Problem<T>& pb, int b, int r, int m, int epoch, double* smem,
                                             const Rounds& rd) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = pb.N / kTile;
  double* Jb = smem;  // [2][64 x kLdS]
  double2* cs = reinterpret_cast<double2*>(Jb + 2 * kTile * kLdS);  // [63][32]
  int* seen = reinterpret_cast<int*>(cs + kRounds * kPairs);
  const double2* src = pb.cs + ((size_t)b * P + m) * kRounds * kPairs;
  const volatile int* ready = pb.ready + (size_t)b * P + m;
  const int base = 128 * epoch;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    Jb[i * kLdS + rd.pos0[j]] = i == j ? 1.0 : 0.0;
  }
  bool skipped = false;
  for (int k0 = 0; k0 < kRounds;) {
    if (tid == 0) {
      int v = *ready;
      for (long long spin = 0; v < base + k0 + 1 && spin < kSpinLimit; ++spin) v = *ready;
      __threadfence();
      *seen = v;
    }
    __syncthreads();
    const int v = *seen;
    __syncthreads();  // `seen` is written again only after every thread read it
    if (v == base + 127) {
      skipped = true;
      break;
    }
    const int k1 = max(min(v - base, kRounds), k0 + 1);  // the rounds published
    for (int e = tid; e < (k1 - k0) * kPairs; e += kThreads) cs[k0 * kPairs + e] = __ldcg(src + k0 * kPairs + e);
    __syncthreads();
    for (int k = k0; k < k1; ++k) {
      rotate_j(Jb + (k & 1) * kTile * kLdS, Jb + ((k + 1) & 1) * kTile * kLdS, rd.next[k], warp, lane,
               cs[k * kPairs + lane]);
      __syncthreads();
    }
    k0 = k1;
  }
  // After the 63 rounds J's columns are in the natural order (buffer 1).
  T* Jout = pb.J + (((size_t)b * 2 + (r & 1)) * P + m) * kTile * kTile;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int i = e / kTile, j = e % kTile;
    Jout[e] = (T)(skipped ? (i == j ? 1.0 : 0.0) : Jb[kTile * kLdS + i * kLdS + j]);
  }
  __syncthreads();
}

// acc = X Y over the 64 x 64 tiles in shared memory (X row-major, or its
// transpose with `xt`), k = 0..63 from 0, one rounding a product and one a
// sum; thread (ty, tx) of a half's 16 x 16 the rows ty + 16a and columns
// tx + 16c.
template <typename T, bool xt>
__device__ __forceinline__ void product(const T* X, const T* Y, T acc[4][4]) {
  const int t = threadIdx.x % kHalf, tx = t % 16, ty = t / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    T x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = xt ? X[k * kLd + ty + 16 * a] : X[(ty + 16 * a) * kLd + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = Y[k * kLd + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = acc[a][c] + x[a] * y[c];
  }
}

template <typename T>
__device__ __forceinline__ void store_acc(T* Z, const T acc[4][4]) {
  const int t = threadIdx.x % kHalf, tx = t % 16, ty = t / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) Z[(ty + 16 * a) * kLd + tx + 16 * c] = acc[a][c];
}

// The tile rows of pair i and columns of pair j of M (N x N) into X, by
// the half's threads.
template <typename T>
__device__ __forceinline__ void load_tile(T* X, const T* M, int N, int ilo, int ihi, int jlo, int jhi) {
  for (int e = threadIdx.x % kHalf; e < kTile * kTile; e += kHalf) {
    const int i = e / kTile, j = e % kTile;
    X[i * kLd + j] = __ldcg(M + (size_t)index_of(ilo, ihi, i) * N + index_of(jlo, jhi, j));
  }
}

template <typename T>
__device__ __forceinline__ void load_j(T* Y, const T* Jsrc) {
  for (int e = threadIdx.x % kHalf; e < kTile * kTile; e += kHalf) Y[(e / kTile) * kLd + e % kTile] = __ldcg(Jsrc + e);
}

// Whether each pair of matrix b's round r rotated, and its J.
template <typename T>
__device__ __forceinline__ size_t pair_slot(const Problem<T>& pb, int b, int r) {
  return ((size_t)b * 2 + (r & 1)) * (pb.N / kTile);
}

// A[Pi, Pj] <- Ji^T A[Pi, Pj] Jj of matrix b, round r, i <= j, and its
// transpose into A[Pj, Pi] (of a diagonal tile, the entries on and above
// its diagonal into those below), on each half of the block: item w of
// B * P (P + 1) / 2 (none when w < 0).  Nothing when Ji = Jj = I; a product
// with an identity J is skipped (its values are its other factor's).  Both
// halves pass every barrier.
template <typename T>
__device__ __forceinline__ void apply_a(const Problem<T>& pb, int r, int w, T* base) {
  const int N = pb.N, P = N / kTile, nb = N / kBw, tri = P * (P + 1) / 2;
  const int b = w < 0 ? 0 : w / tri;
  int i = 0, rest = w < 0 ? 0 : w % tri;
  while (rest >= P - i) rest -= P - i++;
  const int j = i + rest;
  const size_t slot = pair_slot(pb, b, r);
  const bool live = w >= 0 && !idle(pb, b);
  const bool ri = live && __ldcg(pb.rot + slot + i), rj = live && __ldcg(pb.rot + slot + j);
  int ilo, ihi, jlo, jhi;
  pair_of(nb, r, i, &ilo, &ihi);
  pair_of(nb, r, j, &jlo, &jhi);
  T* M = pb.W + (size_t)b * N * N;
  T* X = base;
  T* Y = X + kTile * kLd;
  if (ri || rj) load_tile(X, M, N, ilo, ihi, jlo, jhi);
  if (rj) load_j(Y, pb.J + (slot + j) * kTile * kTile);
  __syncthreads();
  T acc[4][4];
  if (rj) product<T, false>(X, Y, acc);  // A Jj
  __syncthreads();
  if (rj) store_acc(X, acc);
  if (ri) load_j(Y, pb.J + (slot + i) * kTile * kTile);
  __syncthreads();
  if (ri) product<T, true>(Y, X, acc);  // Ji^T (A Jj)
  __syncthreads();
  if (ri) store_acc(X, acc);
  __syncthreads();
  if (ri || rj) {
    for (int e = threadIdx.x % kHalf; e < kTile * kTile; e += kHalf) {
      const int u = e / kTile, v = e % kTile;
      if (i == j) {
        M[(size_t)index_of(ilo, ihi, u) * N + index_of(ilo, ihi, v)] = u <= v ? X[u * kLd + v] : X[v * kLd + u];
      } else {
        M[(size_t)index_of(ilo, ihi, u) * N + index_of(jlo, jhi, v)] = X[u * kLd + v];
        M[(size_t)index_of(jlo, jhi, u) * N + index_of(ilo, ihi, v)] = X[v * kLd + u];
      }
    }
  }
  __syncthreads();
}

// V[Pi, Pj] <- V[Pi, Pj] Jj of matrix b, round r, on each half of the
// block: item w of B * P^2 (matrix w / P^2, tile (w / P % P, w % P); none
// when w < 0), or nothing when Jj = I.  Both halves pass every barrier.
template <typename T>
__device__ __forceinline__ void apply_v(const Problem<T>& pb, int r, int w, T* base) {
  const int N = pb.N, P = N / kTile, nb = N / kBw;
  const int b = w < 0 ? 0 : w / (P * P), i = w < 0 ? 0 : w / P % P, j = w < 0 ? 0 : w % P;
  const size_t slot = pair_slot(pb, b, r);
  const bool active = w >= 0 && !idle(pb, b) && __ldcg(pb.rot + slot + j);
  int ilo, ihi, jlo, jhi;
  pair_of(nb, r, i, &ilo, &ihi);
  pair_of(nb, r, j, &jlo, &jhi);
  T* M = pb.V + (size_t)b * N * N;
  T* X = base;
  T* Y = X + kTile * kLd;
  if (active) {
    load_tile(X, M, N, ilo, ihi, jlo, jhi);
    load_j(Y, pb.J + (slot + j) * kTile * kTile);
  }
  __syncthreads();
  if (active) {
    const int t = threadIdx.x % kHalf, tx = t % 16, ty = t / 16;
    T acc[4][4];
    product<T, false>(X, Y, acc);
    for (int a = 0; a < 4; ++a)
      for (int c = 0; c < 4; ++c)
        M[(size_t)index_of(ilo, ihi, ty + 16 * a) * N + index_of(jlo, jhi, tx + 16 * c)] = acc[a][c];
  }
  __syncthreads();
}

// Items first, first + stride, ... of `count`, two at a time: one on each
// half of the block (each half its own tiles).
template <typename T, typename F>
__device__ __forceinline__ void halves(int first, int stride, int count, T* smem_t, F apply) {
  T* base = smem_t + (threadIdx.x / kHalf) * kHalfTiles;
  for (int w = first; w < count; w += 2 * stride) {
    const int mine = w + (threadIdx.x / kHalf) * stride;
    apply(mine < count ? mine : -1, base);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) eigh_jacobi_kernel(Problem<T> pb) {
  extern __shared__ double smem[];
  __shared__ Rounds rd;
  T* tiles_smem = reinterpret_cast<T*>(smem);
  const int G = gridDim.x, B = pb.B, P = pb.N / kTile, R = pb.N / kBw - 1, tiles = P * P;
  const int tri = P * (P + 1) / 2;

  bool any_due = pb.due == nullptr;
  for (int b = 0; b < B && !any_due; ++b) any_due = pb.due[b];
  if (!any_due) return;  // every block reads the same predicates
  for (int e = threadIdx.x; e < kUpper; e += kThreads) {
    int m = 0, rest = e;
    while (rest >= kPairs - 1 - m) rest -= kPairs - 1 - m++;
    rd.upper[e] = (uint16_t)(m << 8 | (m + 1 + rest));
  }
  // Round k's positions by player, in the dynamic shared memory until the
  // first phase.
  uint8_t* pos = reinterpret_cast<uint8_t*>(smem);  // [63][64]
  uint8_t* player = pos + (kTile - 1) * kTile;     // [63][64]
  for (int e = threadIdx.x; e < (kTile - 1) * kPairs; e += kThreads) {
    const int k = e / kPairs, i = e % kPairs;
    int p, q;
    pair_of(kTile, k, i, &p, &q);
    player[k * kTile + 2 * i] = p;
    player[k * kTile + 2 * i + 1] = q;
    pos[k * kTile + p] = 2 * i;
    pos[k * kTile + q] = 2 * i + 1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (kTile - 1) * kTile; e += kThreads) {
    const int k = e / kTile, u = e % kTile, x = player[k * kTile + u];
    rd.next[k][u] = k < kTile - 2 ? pos[(k + 1) * kTile + x] : x;
    if (k < kTile - 2) rd.look[k][u] = pos[k * kTile + player[(k + 1) * kTile + u]];
  }
  if (threadIdx.x < kTile) rd.pos0[threadIdx.x] = pos[threadIdx.x];
  __syncthreads();
  cg::grid_group grid = cg::this_grid();

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * P; i += G * kThreads) pb.ready[i] = 0;
  for (int w = blockIdx.x; w < B * tiles; w += G)
    if (pb.due == nullptr || pb.due[w / tiles]) tile_norms(pb, w / tiles, w % tiles, smem);
  grid.sync();
  if (threadIdx.x == 0)
    for (int b = blockIdx.x; b < B; b += G)
      if (pb.due == nullptr || pb.due[b]) finish_norms(pb, b, true);
  grid.sync();

  for (int sweep = 0; sweep < pb.max_sweeps; ++sweep) {
    bool all_idle = true;
    for (int b = 0; b < B && all_idle; ++b) all_idle = idle(pb, b);
    if (all_idle) break;  // every block reads the same flags after the same barrier
    for (int r = 0; r < R; ++r) {
      // The round's solves on blocks 0, 1, ...; the previous round's V
      // tiles on the blocks after them (on all blocks, after their solves,
      // when the solves fill the grid).
      // Each pair's solver on block w, its J block on block w + B P (a
      // block's solver items all come before its J block items, so no
      // J block waits on a solver that cannot start).
      const int solves = 2 * B * P, epoch = sweep * R + r + 1;
      for (int w = blockIdx.x; w < solves; w += G) {
        const int v = w % (B * P), b = v / P;
        if (idle(pb, b)) continue;
        if (w < B * P) {
          solve_pair(pb, b, r, v % P, epoch, smem, rd);
        } else {
          accumulate_j(pb, b, r, v % P, epoch, smem, rd);
        }
      }
      if (r > 0) {
        auto v = [&](int w, T* base) { apply_v(pb, r - 1, w, base); };
        if (G > solves) {
          if (blockIdx.x >= solves) halves(blockIdx.x - solves, G - solves, B * tiles, tiles_smem, v);
        } else {
          halves(blockIdx.x, G, B * tiles, tiles_smem, v);
        }
      }
      grid.sync();
      halves(blockIdx.x, G, B * tri, tiles_smem, [&](int w, T* base) { apply_a(pb, r, w, base); });
      grid.sync();
    }
    // The last round's V tiles beside every tile's off(A), then off(A) and
    // the done flags.
    halves(blockIdx.x, G, B * tiles, tiles_smem, [&](int w, T* base) { apply_v(pb, R - 1, w, base); });
    for (int w = blockIdx.x; w < B * tiles; w += G)
      if (!idle(pb, w / tiles)) tile_norms(pb, w / tiles, w % tiles, smem);
    grid.sync();
    if (threadIdx.x == 0)
      for (int b = blockIdx.x; b < B; b += G)
        if (!idle(pb, b)) finish_norms(pb, b, false);
    grid.sync();
  }
}

template <typename T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(eigh_jacobi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
}

// The workspace's parts, in order: J, the tiles' sums, the pairs' rotation
// flags, the inner rotations, the solvers' progress; offsets[5] is the end.
void workspace_layout(int n_pad, int batch, int f64, size_t offsets[6]) {
  const size_t P = n_pad / kTile;
  const size_t bytes[5] = {(size_t)batch * 2 * P * kTile * kTile * (f64 ? sizeof(double) : sizeof(float)),
                           (size_t)batch * P * P * 2 * sizeof(double), (size_t)batch * 2 * P,
                           (size_t)batch * P * kRounds * kPairs * sizeof(double2), (size_t)batch * P * sizeof(int)};
  offsets[0] = 0;
  for (int i = 0; i < 5; ++i) offsets[i + 1] = offsets[i] + (bytes[i] + 255) / 256 * 256;
}

template <typename T>
int run(T* W, T* V, unsigned char* ws, int* flags, double* norms, const uint8_t* due, int N, int batch,
        int max_sweeps, double eps, double tol, int blocks, cudaStream_t stream) {
  size_t at[6];
  workspace_layout(N, batch, sizeof(T) == sizeof(double), at);
  Problem<T> pb;
  pb.W = W;
  pb.V = V;
  pb.J = reinterpret_cast<T*>(ws + at[0]);
  pb.part = reinterpret_cast<double*>(ws + at[1]);
  pb.rot = reinterpret_cast<uint8_t*>(ws + at[2]);
  pb.cs = reinterpret_cast<double2*>(ws + at[3]);
  pb.ready = reinterpret_cast<int*>(ws + at[4]);
  pb.flags = flags;
  pb.norms = norms;
  pb.due = due;
  pb.N = N;
  pb.B = batch;
  pb.max_sweeps = max_sweeps;
  pb.eps = eps;
  pb.tol = tol;
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, eigh_jacobi_kernel<T>, pb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch eigh_jacobi needs for `batch` n_pad x n_pad matrices.
extern "C" long long eigh_jacobi_workspace(int n_pad, int batch, int f64) {
  size_t at[6];
  workspace_layout(n_pad, batch, f64, at);
  return (long long)at[5];
}

// Blocks of the kernel one SM holds at once (its threads, registers and
// shared memory); 0 when none fits, -1 for an error.
extern "C" int eigh_jacobi_blocks_per_sm(int f64) {
  cudaError_t err = f64 ? allow_smem<double>() : allow_smem<float>();
  if (err != cudaSuccess) return -1;
  int per_sm = 0;
  err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eigh_jacobi_kernel<double>, kThreads, kSmem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eigh_jacobi_kernel<float>, kThreads, kSmem);
  return err == cudaSuccess ? per_sm : -1;
}

// The Jacobi sweeps over `batch` padded n_pad x n_pad matrices W (row-major,
// overwritten: its diagonal ends as the eigenvalues) with V (the identity on
// entry, overwritten by the eigenvectors in its columns), on `stream`, in
// one cooperative launch of `blocks` blocks (every one resident: at most
// eigh_jacobi_blocks_per_sm a multiprocessor).  `workspace` holds
// eigh_jacobi_workspace bytes, uninitialised; flags (int32, batch x 4:
// done, sweeps, rotated, unused) must be zero on entry; norms (float64,
// batch x 2: |A|_F, off(A)); due (one byte a matrix) may be null.  `f64`
// picks double storage.  Returns 0, or the CUDA error that refused the
// launch.
extern "C" int eigh_jacobi(void* W, void* V, void* workspace, void* flags, void* norms, const void* due, int n_pad,
                           int batch, int f64, int max_sweeps, double eps, double tol, int blocks, void* stream) {
  if (n_pad <= 0 || n_pad % kTile != 0 || batch <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* ws = (unsigned char*)workspace;
  if (f64)
    return run<double>((double*)W, (double*)V, ws, (int*)flags, (double*)norms, (const uint8_t*)due, n_pad, batch,
                       max_sweeps, eps, tol, blocks, s);
  return run<float>((float*)W, (float*)V, ws, (int*)flags, (double*)norms, (const uint8_t*)due, n_pad, batch,
                    max_sweeps, eps, tol, blocks, s);
}
