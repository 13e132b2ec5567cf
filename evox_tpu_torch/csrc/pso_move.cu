// Fused PSO move on Hopper (sm_90a).
//
// Replaces the TPU kernel `_pso_move_kernel` of evox_tpu/ops/pso_step.py
// (Pallas, called through `fused_pso_move`).  One pass over the (N, D)
// population does the personal-best fold, the two U[0, 1) draws, the
// velocity/position update and the bound clamps:
//
//   improved = f32(fit) < f32(lbf)               (per row; NaN gives false)
//   lbl'     = improved ? x : lbl
//   lbf'     = improved ? fit : lbf              (written once a row)
//   v'       = ((w*v) + ((phi_p*rp)*(lbl'-x))) + ((phi_g*rg)*(gbl-x))
//   x'       = min(max(x + v', lb), ub)          (NaN stays NaN)
//   v'       = min(max(v', lb), ub)
//
// Every operation is done in float32 and, for bfloat16, rounded to
// bfloat16 after it, in the order above; that is how the plain PyTorch
// version (evox_tpu_torch/ops/pso_step.py) rounds, eager operator by
// operator.  The build passes --fmad=false and the code uses the _rn
// intrinsics, so no multiply-add is contracted and float32 agrees with
// the plain version bit for bit.  The bfloat16 route computes on packed
// pairs (mul/add/sub.rn.bf16x2): each operand is a bfloat16 value, so the
// float32 product is exact and the float32 sum is exact or too far from a
// bfloat16 rounding boundary to move it, and "float32 operation, then
// round" is the correctly rounded bfloat16 operation that the packed
// instruction computes.  The clamps are max.NaN/min.NaN: NaN-propagating
// and -0 below +0, as torch.maximum/torch.minimum, so signed zeros come out
// as the plain version's too (the first design returned the bound on a
// tie of zeros).
//
// Draws: with rand_input, rp and rg are read from tensors.  Otherwise they
// come from Philox4x32-10 (csrc/philox.cuh), countered by the element's
// index within its instance (row * D + col): word 0 gives rp, word 1 gives
// rg, their high 24 bits (float32) or 7 bits (bfloat16) times 2^-m, so the
// upper bound 1 is strict.  The Philox key is read from the device: child
// `index` of the key tensor [seed, counter] (or its seed word alone, when
// `derive` is 0), so a replayed CUDA graph draws anew from the key the
// previous generation advanced.  evox_tpu_torch/utils/rng.py computes the
// same Philox in PyTorch.
//
// Instances: one launch moves a batch of B independent swarms (a vmapped
// workflow), laid out as (B, N, D) arrays, (B, N) fitness, a (B, D) global
// best, (B, 3) scalars, B keys, and bounds shared or (B, D).  Instance b
// reads key b and counts its Philox counters from 0, so it draws, and
// moves, exactly what a launch of that instance alone does.  One instance
// (B = 1) is the unbatched call.
//
// What held the first design back (H100 80GB HBM3 at 700 W, chip_smoke.py's
// timing phase at (100000, 1000); PERF.md): a block a row and a
// scalar element a thread, its Philox chain between its loads and its
// stores, so a thread kept 2-4 bytes of each array in flight.  The
// bfloat16 route, half the bytes, took as long as the float32 one (0.89 ms
// against 0.88; bounds 0.358 and 0.717), and the batched route at (8, 1024,
// 100) kept 100 of 256 threads busy (0.0215 ms against 0.0059).  Its SASS
// held 148 (float32) and 182 (bfloat16) instructions an element: the
// Philox round keys added again for each element (24 IADD3), the bfloat16
// roundings as F2F conversions (13), the NaN clamps as branches.
//
// The design.  A flat grid-stride loop over the B*N*D elements, V at a
// time: a vector of 16 bytes (4 float32, 8 bfloat16), narrower where D or
// an operand's alignment does not allow it, never across a row.  The host
// plans the launch (ops/pso_step.py `_launch_plan`): the width, a grid of
// the SMs times the blocks an SM holds (on the routes that read their
// draws, which derive no key, a thread a vector: there the block scheduler
// keeps more loads in flight than a vector of prefetch, float32 1.01 ms
// against 1.08), and multiply-high constants that divide by D and N, so a
// thread finds its row and instance without a divide, in 32-bit index
// arithmetic below 2^31 elements.  The instance's
// Philox key, round keys and scalars are derived again only when a
// thread's instance changes; a vector's V Philox evaluations are
// independent chains.  On the 16-byte routes that draw in the kernel, x, v
// and l go through a cp.async ring in shared memory, three vectors ahead of
// the one being moved (48 B of each array in flight a thread, no
// registers held); the other vector routes keep the next vector's loads in
// registers.  The row's fitness is read one vector ahead of the copies, so
// an improved row's local best is still not read.  Where a vector would
// hold fewer than 4 float32 or 2 bfloat16 elements and a row has a block's
// width or more, the first design's row layout stays (`pso_move_rows`, with
// this file's arithmetic): its row work, once a block, costs less there.
//
// What bounds it now: bytes, on every route at the headline (PERF.md §6
// gives each route's time against chip_smoke.py's bound, which counts the
// local bests of the rows the fold keeps and no others).  The SASS of the
// main loop holds ~103 (float32) and ~74 (bfloat16) instructions an
// element, ~16-18 IMAD.WIDE and ~20 LOP3 of them Philox's, under the byte
// time at the card's issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// A vector of BYTES bytes as 32-bit words (a 2-byte vector: the low half of
// one word).  Streamed operands are read through the read-only path.
// ---------------------------------------------------------------------------

template <int BYTES>
struct Raw;

template <>
struct Raw<16> {
  static constexpr int kWords = 4;
  __device__ __forceinline__ static void load(const void* p, uint32_t* w) {
    const uint4 t = __ldg(static_cast<const uint4*>(p));
    w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
  }
  __device__ __forceinline__ static void store(void* p, const uint32_t* w) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Raw<8> {
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void load(const void* p, uint32_t* w) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    w[0] = t.x, w[1] = t.y;
  }
  __device__ __forceinline__ static void store(void* p, const uint32_t* w) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
};

template <>
struct Raw<4> {
  static constexpr int kWords = 1;
  __device__ __forceinline__ static void load(const void* p, uint32_t* w) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ static void store(void* p, const uint32_t* w) {
    *static_cast<unsigned int*>(p) = w[0];
  }
};

template <>
struct Raw<2> {
  static constexpr int kWords = 1;
  __device__ __forceinline__ static void load(const void* p, uint32_t* w) {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void store(void* p, const uint32_t* w) {
    *static_cast<unsigned short*>(p) = (unsigned short)w[0];
  }
};

// ---------------------------------------------------------------------------
// Index arithmetic: 32-bit below 2^31 elements, 64-bit above.  x / d is
// mulhi(2x, m) >> l with m = ceil(2^(W + l) / d), l = ceil(log2 d), W = 31
// or 63 (the host's `_divisor`): exact for every x < 2^W.
// ---------------------------------------------------------------------------

template <typename I>
struct Index;

template <>
struct Index<uint32_t> {
  __device__ __forceinline__ static uint32_t div(uint32_t x, unsigned long long m, int l) {
    return __umulhi(x << 1, (uint32_t)m) >> l;
  }
};

template <>
struct Index<uint64_t> {
  __device__ __forceinline__ static uint64_t div(uint64_t x, unsigned long long m, int l) {
    return __umul64hi(x << 1, m) >> l;
  }
};

// ---------------------------------------------------------------------------
// The move's arithmetic: float32, and bfloat16 on packed pairs
// ---------------------------------------------------------------------------

// NaN-propagating max/min, as torch.maximum/torch.minimum and jnp.clip
// (fmaxf/fminf would drop the NaN), -0 below +0: one instruction each.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The packed bfloat16 operations of the chain, each rounded once.
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_max_nan(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_min_nan(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The bfloat16 pair (w, w) of a float32 scalar, rounded once.
__device__ __forceinline__ uint32_t bf2_splat(float s) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  return h | (h << 16);
}

// The draws of a pair from two Philox words: k / 128 with k the word's top
// 7 bits, built as (1 + k/128) - 1, exact (bfloat16 1.0 is 0x3F80 and its
// 7 mantissa bits take k).
__device__ __forceinline__ uint32_t bf2_uniform(uint32_t lo_word, uint32_t hi_word) {
  return bf2_sub(0x3F803F80u | (lo_word >> 25) | ((hi_word >> 25) << 16), 0x3F803F80u);
}

// What one instance needs: its Philox key and its scalars (float32, or
// bfloat16 pairs), derived when a thread's instance changes.
struct Instance {
  uint64_t seed;
  float w, phi_p, phi_g;
  uint32_t w2, phi_p2, phi_g2;
};

struct Args {
  const void* pop;
  const void* vel;
  const void* lbl;
  const void* fit;
  const void* lbf;
  const void* gbl;
  const void* lb;
  const void* ub;
  const float* scal;
  const void* rp;
  const void* rg;
  void* pop_out;
  void* vel_out;
  void* lbl_out;
  void* lbf_out;
  const long long* key;
  long long n, d, bound_stride, total;
  unsigned long long d_magic, n_magic;
  int d_shift, n_shift, index, derive;
};

struct F32 {
  using T = float;
  __device__ __forceinline__ static float scalar(const void* p, uint64_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  __device__ __forceinline__ static void store_scalar(void* p, uint64_t i, float x) {
    static_cast<float*>(p)[i] = x;
  }
  __device__ __forceinline__ static void instance(Instance& in, const float* scal) {
    in.w = scal[0], in.phi_p = scal[1], in.phi_g = scal[2];
  }

  // Moves V elements held as words (float bits); writes x' and v'.
  template <int V, bool kInput, typename I>
  __device__ __forceinline__ static void move(const Instance& in, I counter, const uint32_t* x,
                                              const uint32_t* v, const uint32_t* l, const uint32_t* g,
                                              const uint32_t* lo, const uint32_t* hi, const uint32_t* rpw,
                                              const uint32_t* rgw, uint32_t* xo, uint32_t* vo) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float rp, rg;
      if (kInput) {
        rp = __uint_as_float(rpw[i]);
        rg = __uint_as_float(rgw[i]);
      } else {
        uint32_t words[4];
        philox::philox4x32((unsigned long long)(counter + (I)i), in.seed, words);
        rp = philox::uniform_bits(words[0], 24);
        rg = philox::uniform_bits(words[1], 24);
      }
      const float xf = __uint_as_float(x[i]), lf = __uint_as_float(l[i]), gf = __uint_as_float(g[i]);
      const float t1 = __fmul_rn(in.w, __uint_as_float(v[i]));
      const float t2 = __fmul_rn(__fmul_rn(in.phi_p, rp), __fsub_rn(lf, xf));
      const float s = __fadd_rn(t1, t2);
      const float t3 = __fmul_rn(__fmul_rn(in.phi_g, rg), __fsub_rn(gf, xf));
      const float vn = __fadd_rn(s, t3);
      const float xn = __fadd_rn(xf, vn);
      const float lof = __uint_as_float(lo[i]), hif = __uint_as_float(hi[i]);
      xo[i] = __float_as_uint(min_nan(max_nan(xn, lof), hif));
      vo[i] = __float_as_uint(min_nan(max_nan(vn, lof), hif));
    }
  }
};

struct BF16 {
  using T = __nv_bfloat16;
  __device__ __forceinline__ static float scalar(const void* p, uint64_t i) {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(static_cast<const unsigned short*>(p) + i)));
  }
  __device__ __forceinline__ static void store_scalar(void* p, uint64_t i, float x) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static void instance(Instance& in, const float* scal) {
    in.w2 = bf2_splat(scal[0]), in.phi_p2 = bf2_splat(scal[1]), in.phi_g2 = bf2_splat(scal[2]);
  }

  // Moves V elements held as bfloat16 pairs (one word for V = 1, its high
  // half unused); writes x' and v'.
  template <int V, bool kInput, typename I>
  __device__ __forceinline__ static void move(const Instance& in, I counter, const uint32_t* x,
                                              const uint32_t* v, const uint32_t* l, const uint32_t* g,
                                              const uint32_t* lo, const uint32_t* hi, const uint32_t* rpw,
                                              const uint32_t* rgw, uint32_t* xo, uint32_t* vo) {
    constexpr int kPairs = (V + 1) / 2;
    uint32_t rp[kPairs], rg[kPairs];
    if (kInput) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) rp[p] = rpw[p], rg[p] = rgw[p];
    } else {
      uint32_t w0[2 * kPairs], w1[2 * kPairs];
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) {
        if (i < V) {
          uint32_t words[4];
          philox::philox4x32((unsigned long long)(counter + (I)i), in.seed, words);
          w0[i] = words[0], w1[i] = words[1];
        } else {
          w0[i] = 0u, w1[i] = 0u;
        }
      }
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        rp[p] = bf2_uniform(w0[2 * p], w0[2 * p + 1]);
        rg[p] = bf2_uniform(w1[2 * p], w1[2 * p + 1]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const uint32_t t1 = bf2_mul(in.w2, v[p]);
      const uint32_t t2 = bf2_mul(bf2_mul(in.phi_p2, rp[p]), bf2_sub(l[p], x[p]));
      const uint32_t s = bf2_add(t1, t2);
      const uint32_t t3 = bf2_mul(bf2_mul(in.phi_g2, rg[p]), bf2_sub(g[p], x[p]));
      const uint32_t vn = bf2_add(s, t3);
      const uint32_t xn = bf2_add(x[p], vn);
      xo[p] = bf2_min_nan(bf2_max_nan(xn, lo[p]), hi[p]);
      vo[p] = bf2_min_nan(bf2_max_nan(vn, lo[p]), hi[p]);
    }
  }
};

// The streamed operands of one vector.
template <int W, bool kInput>
struct Loads {
  uint32_t x[W], v[W], l[W], rp[kInput ? W : 1], rg[kInput ? W : 1];
};

// Vectors in flight a thread on the 16-byte in-kernel-draw routes: a ring
// of kStages slots for each of x, v and l in shared memory (48 KB a
// block), kStages - 1 vectors ahead of the one being moved.
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * 3 * kThreads * 16;
static_assert(kRingBytes <= 48 * 1024, "the ring fits a block's default shared memory");

__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <class L, int V, typename I, bool kInput>
struct Mover {
  using T = typename L::T;
  using R = Raw<V * (int)sizeof(T)>;
  static constexpr int W = R::kWords;
  // The ring takes the 16-byte routes that draw in the kernel; the routes
  // with drawn operands stream five arrays and keep them in registers, a
  // vector a thread (the plan's grid covers every vector).
  static constexpr bool kRing = V * (int)sizeof(T) == 16 && !kInput;

  const Args& a;
  const I total, d, nd, stride;
  Instance in;
  I b_cur = ~(I)0;
  const T *gbl = nullptr, *lb = nullptr, *ub = nullptr;

  __device__ __forceinline__ explicit Mover(const Args& args)
      : a(args), total((I)args.total), d((I)args.d), nd((I)(args.n * args.d)),
        stride((I)gridDim.x * (I)(kThreads * V)) {}

  __device__ __forceinline__ I row_of(I e) const { return Index<I>::div(e, a.d_magic, a.d_shift); }
  __device__ __forceinline__ const T* src(const void* p, I e) const { return static_cast<const T*>(p) + e; }

  // Moves vector e (row `row`, fitness pair f, fl) from its streamed words.
  __device__ __forceinline__ void move(I e, I row, float f, float fl, const Loads<W, kInput>& cur) {
    const I b = Index<I>::div(row, a.n_magic, a.n_shift);
    if (b != b_cur) {
      b_cur = b;
      in.seed = kInput ? 0ull : philox::draw_seed(a.key + 2 * b, a.index, a.derive);
      L::instance(in, a.scal + 3 * b);
      gbl = static_cast<const T*>(a.gbl) + b * d;
      lb = static_cast<const T*>(a.lb) + b * (I)a.bound_stride;
      ub = static_cast<const T*>(a.ub) + b * (I)a.bound_stride;
    }
    const I col = e - row * d;
    uint32_t g[W], lo[W], hi[W], xo[W], vo[W];
    R::load(gbl + col, g);
    R::load(lb + col, lo);
    R::load(ub + col, hi);
    if (col == 0) L::store_scalar(a.lbf_out, row, f < fl ? f : fl);
    L::template move<V, kInput, I>(in, e - b * nd, cur.x, cur.v, cur.l, g, lo, hi, cur.rp, cur.rg, xo, vo);
    R::store(static_cast<T*>(a.pop_out) + e, xo);
    R::store(static_cast<T*>(a.vel_out) + e, vo);
    R::store(static_cast<T*>(a.lbl_out) + e, cur.l);
  }

  // Narrow routes: the next vector's loads in registers, issued before this
  // one is moved; the row fitness two vectors ahead, so the local-best load
  // of an improved row is skipped.
  __device__ __forceinline__ void issue(I e, bool improved, Loads<W, kInput>& ld) const {
    R::load(src(a.pop, e), ld.x);
    R::load(src(a.vel, e), ld.v);
    if (improved) {
#pragma unroll
      for (int k = 0; k < W; ++k) ld.l[k] = ld.x[k];
    } else {
      R::load(src(a.lbl, e), ld.l);
    }
    if (kInput) {
      R::load(src(a.rp, e), ld.rp);
      R::load(src(a.rg, e), ld.rg);
    }
  }

  __device__ __forceinline__ void run_registers(I e) {
    I row = row_of(e);
    float f = L::scalar(a.fit, row), fl = L::scalar(a.lbf, row);
    Loads<W, kInput> cur, nxt;
    issue(e, f < fl, cur);
    I e1 = e + stride, row1 = 0;
    float f1 = 0.f, fl1 = 0.f;
    if (e1 < total) {
      row1 = row_of(e1);
      f1 = L::scalar(a.fit, row1), fl1 = L::scalar(a.lbf, row1);
    }
    for (;;) {
      const bool more = e1 < total;
      I e2 = 0, row2 = 0;
      float f2 = 0.f, fl2 = 0.f;
      if (more) {
        e2 = e1 + stride;
        if (e2 < total) {
          row2 = row_of(e2);
          f2 = L::scalar(a.fit, row2), fl2 = L::scalar(a.lbf, row2);
        }
        issue(e1, f1 < fl1, nxt);
      }
      move(e, row, f, fl, cur);
      if (!more) break;
      e = e1, row = row1, f = f1, fl = fl1, cur = nxt;
      e1 = e2, row1 = row2, f1 = f2, fl1 = fl2;
    }
  }

  // The ring: x, v and l copied asynchronously (cp.async) into the
  // thread's own slots, kStages - 1 vectors ahead; a vector's row fitness
  // is read one vector before its copies are issued, and the local best of
  // an improved row is not copied.
  __device__ __forceinline__ uint4* slot(uint4* ring, int stage, int array) const {
    return ring + (stage * 3 + array) * kThreads + threadIdx.x;
  }

  __device__ __forceinline__ void copy(uint4* ring, int stage, I e, bool improved) const {
    copy_async(slot(ring, stage, 0), src(a.pop, e));
    copy_async(slot(ring, stage, 1), src(a.vel, e));
    if (!improved) copy_async(slot(ring, stage, 2), src(a.lbl, e));
  }

  __device__ __forceinline__ void read(uint4* ring, int stage, bool improved, Loads<W, kInput>& ld) const {
    auto words = [&](int array, uint32_t* w) {
      const uint4 t = *slot(ring, stage, array);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    };
    words(0, ld.x);
    words(1, ld.v);
    if (improved) {
#pragma unroll
      for (int k = 0; k < W; ++k) ld.l[k] = ld.x[k];
    } else {
      words(2, ld.l);
    }
  }

  __device__ __forceinline__ void run_ring(I e0, uint4* ring) {
    // The queue of this thread's next kStages vectors: flat index (total
    // past the end), row and fitness pair.
    I e[kStages], row[kStages];
    float f[kStages], fl[kStages];
#pragma unroll
    for (int q = 0; q < kStages; ++q) {
      e[q] = q == 0 ? e0 : (e[q - 1] < total ? e[q - 1] + stride : total);
      if (e[q] > total) e[q] = total;
      row[q] = 0, f[q] = 0.f, fl[q] = 0.f;
      if (e[q] < total) {
        row[q] = row_of(e[q]);
        f[q] = L::scalar(a.fit, row[q]), fl[q] = L::scalar(a.lbf, row[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (e[q] < total) copy(ring, q, e[q], f[q] < fl[q]);
      commit_copies();
    }
    for (int stage = 0;; stage = stage == kStages - 1 ? 0 : stage + 1) {
      // Copies of the last vector of the queue, and the row fitness of the
      // one after it.
      const int last = stage == 0 ? kStages - 1 : stage - 1;
      if (e[kStages - 1] < total) copy(ring, last, e[kStages - 1], f[kStages - 1] < fl[kStages - 1]);
      commit_copies();
      I en = total, rown = 0;
      float fn = 0.f, fln = 0.f;
      if (e[kStages - 1] < total) {
        en = e[kStages - 1] + stride;
        if (en < total) {
          rown = row_of(en);
          fn = L::scalar(a.fit, rown), fln = L::scalar(a.lbf, rown);
        } else {
          en = total;
        }
      }
      wait_copies<kStages - 1>();
      Loads<W, kInput> cur;
      read(ring, stage, f[0] < fl[0], cur);
      move(e[0], row[0], f[0], fl[0], cur);
      if (e[1] >= total) break;
#pragma unroll
      for (int q = 0; q < kStages - 1; ++q)
        e[q] = e[q + 1], row[q] = row[q + 1], f[q] = f[q + 1], fl[q] = fl[q + 1];
      e[kStages - 1] = en, row[kStages - 1] = rown, f[kStages - 1] = fn, fl[kStages - 1] = fln;
    }
  }
};

// Shared memory of a route's ring (0 on the routes without one).
template <class L, int V, bool kInput>
constexpr int ring_bytes() {
  return Mover<L, V, uint32_t, kInput>::kRing ? kRingBytes : 0;
}

template <class L, int V, typename I, bool kInput>
__global__ void __launch_bounds__(kThreads, 2) pso_move_kernel(const Args a) {
  extern __shared__ uint4 ring[];
  Mover<L, V, I, kInput> m(a);
  const I e = ((I)blockIdx.x * kThreads + threadIdx.x) * (I)V;
  if (e >= m.total) return;
  if constexpr (Mover<L, V, I, kInput>::kRing)
    m.run_ring(e, ring);
  else
    m.run_registers(e);
}

// The row layout (the first design's, kept for narrow vectors at large D): a
// block a row of the batch, its threads striding over the columns an
// element at a time, the row's fitness, instance and key read once a block.
template <class L, typename I, bool kInput>
__global__ void __launch_bounds__(kThreads) pso_move_rows(const Args a) {
  using T = typename L::T;
  using R = Raw<(int)sizeof(T)>;
  const I row = blockIdx.x, d = (I)a.d, n = (I)a.n;
  const I b = row / n;
  Instance in;
  in.seed = kInput ? 0ull : philox::draw_seed(a.key + 2 * b, a.index, a.derive);
  L::instance(in, a.scal + 3 * b);
  const T* gbl = static_cast<const T*>(a.gbl) + b * d;
  const T* lb = static_cast<const T*>(a.lb) + b * (I)a.bound_stride;
  const T* ub = static_cast<const T*>(a.ub) + b * (I)a.bound_stride;
  const float f = L::scalar(a.fit, row), fl = L::scalar(a.lbf, row);
  const bool improved = f < fl;
  if (threadIdx.x == 0) L::store_scalar(a.lbf_out, row, improved ? f : fl);
  const I base = row * d, counter = (row - b * n) * d;
  for (I col = threadIdx.x; col < d; col += kThreads) {
    const I e = base + col;
    uint32_t x[1], v[1], l[1], g[1], lo[1], hi[1], rp[1] = {0u}, rg[1] = {0u}, xo[1], vo[1];
    R::load(static_cast<const T*>(a.pop) + e, x);
    R::load(static_cast<const T*>(a.vel) + e, v);
    if (improved)
      l[0] = x[0];
    else
      R::load(static_cast<const T*>(a.lbl) + e, l);
    if (kInput) {
      R::load(static_cast<const T*>(a.rp) + e, rp);
      R::load(static_cast<const T*>(a.rg) + e, rg);
    }
    R::load(gbl + col, g);
    R::load(lb + col, lo);
    R::load(ub + col, hi);
    L::template move<1, kInput, I>(in, counter + col, x, v, l, g, lo, hi, rp, rg, xo, vo);
    R::store(static_cast<T*>(a.pop_out) + e, xo);
    R::store(static_cast<T*>(a.vel_out) + e, vo);
    R::store(static_cast<T*>(a.lbl_out) + e, l);
  }
}

// A route's kernel and the shared memory it launches with.
struct Route {
  const void* kernel;
  int smem;
};

template <class L, int V>
Route vectors_of(int wide, int rand_input) {
  if (wide)
    return rand_input ? Route{(const void*)pso_move_kernel<L, V, uint64_t, true>, ring_bytes<L, V, true>()}
                      : Route{(const void*)pso_move_kernel<L, V, uint64_t, false>, ring_bytes<L, V, false>()};
  return rand_input ? Route{(const void*)pso_move_kernel<L, V, uint32_t, true>, ring_bytes<L, V, true>()}
                    : Route{(const void*)pso_move_kernel<L, V, uint32_t, false>, ring_bytes<L, V, false>()};
}

template <class L>
Route rows_of(int wide, int rand_input) {
  if (wide)
    return Route{rand_input ? (const void*)pso_move_rows<L, uint64_t, true>
                            : (const void*)pso_move_rows<L, uint64_t, false>, 0};
  return Route{rand_input ? (const void*)pso_move_rows<L, uint32_t, true>
                          : (const void*)pso_move_rows<L, uint32_t, false>, 0};
}

// The route of dtype 0 float32 (V 4, 2, 1) or 1 bfloat16 (V 8, 4, 2, 1), or
// its row layout; a null kernel for any other.
Route route_of(int dtype, int vec, int wide, int rand_input, int rows) {
  if (dtype == 0) {
    if (rows) return rows_of<F32>(wide, rand_input);
    switch (vec) {
      case 4: return vectors_of<F32, 4>(wide, rand_input);
      case 2: return vectors_of<F32, 2>(wide, rand_input);
      case 1: return vectors_of<F32, 1>(wide, rand_input);
    }
  } else if (dtype == 1) {
    if (rows) return rows_of<BF16>(wide, rand_input);
    switch (vec) {
      case 8: return vectors_of<BF16, 8>(wide, rand_input);
      case 4: return vectors_of<BF16, 4>(wide, rand_input);
      case 2: return vectors_of<BF16, 2>(wide, rand_input);
      case 1: return vectors_of<BF16, 1>(wide, rand_input);
    }
  }
  return Route{nullptr, 0};
}

bool aligned(const void* p, long long bytes) {
  return p == nullptr || ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

}  // namespace

// Blocks of an in-kernel-draw route's kernel one SM holds at once (the
// grid's size is this times the SMs), or -1 for a route that does not
// exist.
extern "C" int pso_move_blocks_per_sm(int dtype, int vec, int wide) {
  const Route r = route_of(dtype, vec, wide, 0, 0);
  int blocks = 0;
  if (r.kernel == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, r.kernel, kThreads, r.smem) != cudaSuccess)
    return -1;
  return blocks;
}

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every pointer is a device pointer to `batch` instances' operands (see
// above): pop/vel/lbl/rp/rg/outputs (batch, n, d), fit/lbf (batch, n), gbl
// (batch, d), scal (batch, 3) float32, key (batch, 2) int64 (see
// csrc/philox.cuh), lb/ub (batch, d) with bound_stride d or one (d,) row
// shared with bound_stride 0.  rp/rg may be null when rand_input == 0, and
// key when it is not.  The launch plan (ops/pso_step.py `_launch_plan`):
// `vec` elements a vector (d a multiple of it, every (n, d) and (d,)
// operand aligned to its bytes), `blocks` blocks, 64-bit indices when
// `wide` (required from 2^31 elements), and the multiply-high constants of
// the divisions by d and n; or, with `rows`, the row layout on batch * n
// blocks.  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for operands or a plan the
// kernel does not take.
extern "C" int pso_move(int dtype, const void* pop, const void* vel, const void* lbl, const void* fit,
                        const void* lbf, const void* gbl, const void* lb, const void* ub,
                        const void* scal, const void* rp, const void* rg, void* pop_out,
                        void* vel_out, void* lbl_out, void* lbf_out, long long batch, long long n,
                        long long d, long long bound_stride, const void* key, int index, int derive,
                        int rand_input, int vec, int blocks, int wide, int rows, unsigned long long d_magic,
                        int d_shift, unsigned long long n_magic, int n_shift, void* stream) {
  if (batch < 0 || n < 0 || d < 0 || batch * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long total = batch * n * d;
  if (total == 0) return (int)cudaGetLastError();
  const Route r = route_of(dtype, vec, wide, rand_input, rows);
  const long long bytes = (long long)vec * (dtype == 0 ? 4 : 2);
  if (r.kernel == nullptr || blocks < 1 || d % vec != 0 || (rows && blocks != batch * n) ||
      (!wide && total >= (1LL << 31)) || (rand_input && (rp == nullptr || rg == nullptr)) ||
      (!rand_input && key == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {pop, vel, lbl, gbl, lb, ub, rp, rg, (const void*)pop_out, (const void*)vel_out,
                        (const void*)lbl_out})
    if (!aligned(p, bytes)) return (int)cudaErrorInvalidValue;
  Args a{pop, vel, lbl, fit, lbf, gbl, lb, ub, (const float*)scal, rp, rg, pop_out, vel_out, lbl_out,
         lbf_out, (const long long*)key, n, d, bound_stride, total, d_magic, n_magic, d_shift, n_shift,
         index, derive};
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchKernel(r.kernel, dim3((unsigned int)blocks), dim3(kThreads), params,
                                           (size_t)r.smem, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
