// Sumcheck round kernels for Hopper (sm_90a), plain C ABI for ctypes.
//
// What each kernel replaces (zkcnn_tpu, the JAX/Pallas reference):
//   * role_kernel / tail_kernel<true> (zk_round_ladder with dots):
//     quadratic sumcheck rounds,
//     zkcnn_tpu/field/pallas_round2.py::_round2_kernel (entry
//     round_step2, XLA epilogue _finish_dots2) and its canonical-limb
//     twin zkcnn_tpu/field/pallas_round.py::_round_kernel (entry
//     round_step), which the JAX package drives through a multi-round
//     ladder (zkcnn_tpu/gkr/fused.py::_quad_ladder).  Per round, the
//     four pair dots
//       D_xy = sum_i mont(A[2i+x], V[2i+y])   (x, y in {0, 1})
//     and both folds X'_i = X[2i] + r (X[2i+1] - X[2i]).
//   * fold_kernel / tail_kernel<false> (zk_round_ladder without dots):
//     the fold alone, for every other fold on the CUDA path (MLE
//     evaluation).
//   * cubic_role_kernel / cubic_tail_kernel (zk_cubic_ladder): DOT_PROD
//     phase-1 rounds, zkcnn_tpu/field/pallas_round.py::_cubic_kernel
//     (entry cubic_round_step, epilogue _blocks_to_mont).  Per pair i,
//     with a/da from V1, b/db from V0 and m0/dm from m-pair
//     (i mod M/2):
//       e0 = a b, e1 = da b + a db, e2 = da db,
//       c0 += m0 e0, c1 += dm e0 + m0 e1, c2 += dm e1 + m0 e2,
//       c3 += dm e2,
//     and the folds of V0, V1 and of m itself.
//   * fold_round_kernel (zk_fold_round) and fold_cubic_round_kernel
//     (zk_fold_cubic_round): the same two functions rescheduled for a
//     Fiat-Shamir sumcheck, whose challenge r_j is drawn only after round
//     j's message: one launch folds at r_(j-1), then forms round j's dots
//     (or c0..c3) from the folded rows.
//
// Data: a field element is 8 little-endian 32-bit words of its
// canonical Montgomery residue (R = 2^256), one 32-byte row.  Every
// output is canonical, so it equals the JAX package bit for bit.
//
// A ladder is R rounds at R challenges that are all known beforehand
// (the seeded tape): the challenges arrive as one [R, 8] host array and
// travel in the kernels' parameters (no allocation, no copy: a copy from
// pageable host memory would make the host wait for the stream), round j
// writes its four values into row j of a [R, 4, 8] output, and nothing
// returns to the host in between.
//
// What bounds it on this card.  From about 2^20 rows: 32-bit integer
// multiplies, not bytes (a CIOS Montgomery product is 128 32x32->64-bit
// multiplies; a quadratic pair reads 128 bytes, writes 64 and runs 6
// products; a cubic pair runs 13; a fold pair reads 64, writes 32 and
// runs 1).  Below that, which is every round of a LeNet5 proof: the
// latency of a round -- one thread's chain of dependent multiplies (six
// products in a row take about 10 us whatever the row count), the
// reduction behind it and the launch -- not the card's throughput.
// What the design does about both:
//   * a round is split by role: each of a pair's products goes to another
//     thread (quadratic: four dots and two folds, six roles of two warps
//     in a block of 384; cubic: the three terms e0, e1, e2 with their
//     table products and the folds, four roles in a block of 256).  A
//     thread then chains one product (cubic: up to three) instead of six
//     (thirteen), keeps one accumulator (two) instead of four, and a
//     warp sums one value in five shuffles.  Fewer registers a thread
//     also put more warps on an SM, so the split is the faster form at
//     every size measured, up to 2^24 rows;
//   * wide rounds (more rows than the tail threshold): one launch a
//     round, a block taking 64 pairs a sweep, and the cross-block
//     reduction inside the same launch -- the last block to take a
//     ticket (atomic counter after __threadfence) sums the per-block
//     partials.  Modular sums are exact, so the result is the same in
//     every run whatever the order blocks finish in;
//   * the tail (at most the threshold): ONE block runs all remaining
//     rounds.  Its first round reads the pairs from device memory and
//     folds into shared memory; later rounds ping-pong between two
//     shared buffers with one __syncthreads a round; the last round
//     writes the result.  A ladder that starts under the threshold is
//     one launch in all.  A block has one SM's throughput, so the
//     threshold is low: TAIL_ROWS = 2^8 rows measured best of 2^6..2^12
//     (18 KiB of shared memory for the three operands of a cubic tail);
//   * lazy reduction of the dots from LAZY_ROWS = 2^18 rows, below which
//     it measured slower (LAZY): a thread adds
//     the unreduced 512-bit products a*b (64 multiplies each) into a
//     17-word accumulator and reduces once at the end (two Montgomery
//     divisions and one product with R^2), instead of 128 multiplies a
//     product.  The folds, and the cubic terms e, keep the full product.
// Tensor-core products, thread-block clusters for the tail and one
// cooperative launch for a whole ladder are later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

constexpr int NW = 8;              // words per field element
constexpr int THREADS = 256;       // a block of fold_kernel
constexpr int QUAD_THREADS = 384;  // a block of six roles (role_sweep)
constexpr int ROLE_THREADS = 64;   // threads (two warps) of one role
constexpr int CUBIC_THREADS = 256;  // a block of four cubic roles
constexpr int CUBIC_TERMS = 3;      // the cubic roles that form a term
constexpr int TAIL_ROWS = 1 << 8;  // rounds on at most this many rows: tail
constexpr int TAIL_ROUNDS = 8;     // most rounds of a tail: log2(TAIL_ROWS)
constexpr int LAZY_ROWS = 1 << 18;  // wide rounds from here up: lazy dots
constexpr int NVAL = 4;            // dot / coefficient outputs per round
constexpr int NACC = 2 * NW + 1;   // words of a lazy accumulator
constexpr int LAZY_PAIRS = 8;      // least pairs per thread of a lazy round
constexpr int MAX_BLOCKS = 1024;   // blocks of a wide launch: 128 KiB partials

// BLS12-381 Fr modulus, little-endian 32-bit words; -p^-1 mod 2^32; and
// R^2 mod p (R = 2^256).
__constant__ u32 P[NW] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                          0x53bda402u, 0x09a1d805u, 0x3339d808u,
                          0x299d7d48u, 0x73eda753u};
__constant__ u32 R2[NW] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u,
                           0x2b6cedcbu, 0x7254398fu, 0x05d31496u,
                           0x9f59ff11u, 0x0748d9d9u};
constexpr u32 PINV = 0xffffffffu;

struct Fe {
  u32 w[NW];
};

// The challenges of a tail's rounds, passed by value.
struct Challenges {
  u32 w[TAIL_ROUNDS][NW];
};

__device__ __forceinline__ void load(u32 x[NW], const u32* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = s[0], b = s[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A load that reads L2, for data another block wrote in this launch.
__device__ __forceinline__ void load_cg(u32 x[NW], const u32* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = __ldcg(s), b = __ldcg(s + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store(u32* dst, const u32 x[NW]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(x[0], x[1], x[2], x[3]);
  d[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void set_zero(u32 x[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) x[k] = 0;
}

// r = t - p if t >= p else t, for t < 2p (t has a 9th word t8).
__device__ __forceinline__ void cond_sub(u32 r[NW], const u32 t[NW], u32 t8) {
  u32 d[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 s = (u64)t[k] - P[k] - borrow;
    d[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  // t >= p exactly when the subtraction does not borrow past t8
  bool ge = t8 != 0 || borrow == 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = ge ? d[k] : t[k];
}

__device__ __forceinline__ void add_mod(u32 r[NW], const u32 a[NW],
                                        const u32 b[NW]) {
  u32 t[NW];
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 s = (u64)a[k] + b[k] + c;
    t[k] = (u32)s;
    c = s >> 32;
  }
  cond_sub(r, t, (u32)c);
}

__device__ __forceinline__ void sub_mod(u32 r[NW], const u32 a[NW],
                                        const u32 b[NW]) {
  u32 t[NW];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 s = (u64)a[k] - b[k] - borrow;
    t[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  // a < b: add p back (the result then lies in [0, p))
  u64 c = 0;
  u32 mask = borrow ? 0xffffffffu : 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    u64 s = (u64)t[k] + (P[k] & mask) + c;
    r[k] = (u32)s;
    c = s >> 32;
  }
}

// CIOS Montgomery product r = a b R^-1 mod p, canonical.
__device__ __forceinline__ void mont_mul(u32 r[NW], const u32 a[NW],
                                         const u32 b[NW]) {
  u32 t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)a[j] * b[i] + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[NW] + c;
    t[NW] = (u32)s;
    t[NW + 1] = (u32)(s >> 32);
    u32 m = t[0] * PINV;
    s = (u64)m * P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (u64)m * P[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[NW] + c;
    t[NW - 1] = (u32)s;
    t[NW] = t[NW + 1] + (u32)(s >> 32);
  }
  cond_sub(r, t, t[NW]);
}

// x + r d, the fold of a pair with even row x and difference d.
__device__ __forceinline__ void fold_pair(u32 out[NW], const u32 x[NW],
                                          const u32 d[NW], const u32 r[NW]) {
  u32 t[NW];
  mont_mul(t, d, r);
  add_mod(out, t, x);
}

// One Montgomery division of a 17-word value in place: afterwards words
// 8..16 hold (w + m p) / 2^256 and words 0..7 are zero.  The sum must
// stay below 2^544, which holds for w < 2^543.
__device__ __forceinline__ void redc_words(u32 w[NACC]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    u32 m = w[i] * PINV;
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      u64 s = (u64)m * P[j] + w[i + j] + c;
      w[i + j] = (u32)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + NW; k < NACC; ++k) {
      u64 s = (u64)w[k] + c;
      w[k] = (u32)s;
      c = s >> 32;
    }
  }
}

// The sum of Montgomery products sum_i mont(a_i, b_i) mod p, kept either
// as a canonical residue that takes a full CIOS product each time
// (LAZY = false) or as the unreduced sum of the 512-bit products a_i b_i
// (LAZY = true): below 2^543 for up to 2^33 products, one reduction at
// the end.
template <bool LAZY>
struct Acc;

template <>
struct Acc<false> {
  u32 w[NW];
  __device__ __forceinline__ void clear() { set_zero(w); }
  __device__ __forceinline__ void add_prod(const u32 a[NW], const u32 b[NW]) {
    u32 t[NW];
    mont_mul(t, a, b);
    add_mod(w, w, t);
  }
  __device__ __forceinline__ void finish(u32 out[NW]) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) out[k] = w[k];
  }
};

template <>
struct Acc<true> {
  u32 w[NACC];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < NACC; ++k) w[k] = 0;
  }
  __device__ __forceinline__ void add_prod(const u32 a[NW], const u32 b[NW]) {
    u32 t[2 * NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      u64 c = 0;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        u64 s = (u64)a[j] * b[i] + t[i + j] + c;
        t[i + j] = (u32)s;
        c = s >> 32;
      }
      t[i + NW] = (u32)c;
    }
    u64 c = 0;
#pragma unroll
    for (int k = 0; k < 2 * NW; ++k) {
      u64 s = (u64)w[k] + t[k] + c;
      w[k] = (u32)s;
      c = s >> 32;
    }
    w[2 * NW] += (u32)c;
  }
  // T -> T R^-2 (two divisions: below 2^287, then below 2^31 + p < 2p),
  // canonical, then times R^2 R^-1: T R^-1 mod p.
  __device__ __forceinline__ void finish(u32 out[NW]) const {
    u32 z[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) z[k] = w[k];
    redc_words(z);
#pragma unroll
    for (int k = 0; k <= NW; ++k) z[k] = z[k + NW];
#pragma unroll
    for (int k = NW + 1; k < NACC; ++k) z[k] = 0;
    redc_words(z);
    u32 x[NW];
    cond_sub(x, z + NW, z[2 * NW]);
    mont_mul(out, x, R2);
  }
};

// The folds X2[i] = X[2i] + r (X[2i+1] - X[2i]) of pairs first,
// first + stride, ... below npairs.
__device__ __forceinline__ void fold_sweep(const u32* X, u32* X2,
                                           long long npairs, long long first,
                                           long long stride,
                                           const u32 r[NW]) {
  for (long long i = first; i < npairs; i += stride) {
    u32 x0[NW], x1[NW], d[NW];
    load(x0, X + (2 * i) * NW);
    load(x1, X + (2 * i + 1) * NW);
    sub_mod(d, x1, x0);
    fold_pair(x1, x0, d, r);
    store(X2 + i * NW, x1);
  }
}

// A quadratic round split by role: a pair's six products go to six
// threads, so that a round's latency is one product, not six in a chain.
// Roles 0..3 sum the dot D_xy (role = 2x + y) of their pairs into sum
// (canonical); role 4 folds A, role 5 folds V.
template <bool LAZY>
__device__ __forceinline__ void role_sweep(const u32* A, const u32* V,
                                           u32* A2, u32* V2,
                                           long long npairs, long long first,
                                           long long stride, const u32 r[NW],
                                           int role, u32 sum[NW]) {
  if (role < NVAL) {
    const u32* a_row = A + (role >> 1) * NW;
    const u32* v_row = V + (role & 1) * NW;
    Acc<LAZY> acc;
    acc.clear();
    for (long long i = first; i < npairs; i += stride) {
      u32 a[NW], v[NW];
      load(a, a_row + (2 * i) * NW);
      load(v, v_row + (2 * i) * NW);
      acc.add_prod(a, v);
    }
    acc.finish(sum);
  } else if (role == NVAL) {
    fold_sweep(A, A2, npairs, first, stride, r);
  } else {
    fold_sweep(V, V2, npairs, first, stride, r);
  }
}

// Sum x over the lanes of the warp whose index agrees modulo GROUP (a
// power of two; 1: over all 32 lanes).
template <int GROUP>
__device__ __forceinline__ void warp_sum(u32 x[NW]) {
#pragma unroll
  for (int off = 16; off >= GROUP; off >>= 1) {
    u32 o[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k)
      o[k] = __shfl_xor_sync(0xffffffffu, x[k], off);
    add_mod(x, x, o);
  }
}

// After role_sweep: the warps of the dot roles leave their sums in
// sums[warp]; after a __syncthreads, role_value gives thread t < 4 the
// block's value t (the two warps of role t).
__device__ __forceinline__ void role_warp_sums(u32 sum[NW], int role,
                                               u32 (*sums)[NW]) {
  if (role < NVAL) {
    warp_sum<1>(sum);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) sums[threadIdx.x >> 5][k] = sum[k];
    }
  }
}

__device__ __forceinline__ void role_value(u32 (*sums)[NW], int t,
                                           u32 x[NW]) {
  u32 y[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    x[k] = sums[2 * t][k];
    y[k] = sums[2 * t + 1][k];
  }
  add_mod(x, x, y);
}

// One wide fold of X alone: grid-stride over pairs.
__global__ void __launch_bounds__(THREADS)
fold_kernel(const u32* __restrict__ X, u32* __restrict__ X2,
            long long npairs, Fe rj) {
  fold_sweep(X, X2, npairs, blockIdx.x * (long long)THREADS + threadIdx.x,
             (long long)gridDim.x * THREADS, rj.w);
}

// The grid's sums of NVAL values, of which thread t < 4 of each block
// holds the block's value t in x, into out [4, 8], within this launch:
// every block writes its values to its row of partials and takes a
// ticket; the block that takes the last one sums the rows.  *ticket is 0
// at the launch.  Any whole number of warps up to 12.
__device__ void grid_finish(u32 x[NW], u32* partials, unsigned* ticket,
                            u32* out) {
  __shared__ u32 rows[QUAD_THREADS / 32][NVAL][NW];
  __shared__ bool is_last;
  if (threadIdx.x < NVAL)
    store(gridDim.x == 1
              ? out + threadIdx.x * NW
              : partials + (blockIdx.x * NVAL + threadIdx.x) * NW, x);
  if (gridDim.x == 1) return;
  __threadfence();            // this block's row before its ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();            // the other blocks' rows after their tickets
  // thread t sums value t & 3 over blocks t >> 2, t >> 2 + threads / 4, ...
  const int v = threadIdx.x & (NVAL - 1);
  set_zero(x);
  for (int b = threadIdx.x / NVAL; b < gridDim.x; b += blockDim.x / NVAL) {
    u32 y[NW];
    load_cg(y, partials + (b * NVAL + v) * NW);
    add_mod(x, x, y);
  }
  warp_sum<NVAL>(x);          // lanes 0..3: the warp's sums of values 0..3
  if ((threadIdx.x & 31) < NVAL) {
#pragma unroll
    for (int k = 0; k < NW; ++k) rows[threadIdx.x >> 5][v][k] = x[k];
  }
  __syncthreads();
  if (threadIdx.x < NVAL) {
    set_zero(x);
    for (int w = 0; w < blockDim.x / 32; ++w) {
      u32 y[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) y[k] = rows[w][v][k];
      add_mod(x, x, y);
    }
    store(out + v * NW, x);
  }
}

// One wide quadratic round split by role (role_sweep): a block takes 64
// pairs a sweep, two warps a role; the grid's sums go to dots [4, 8].
template <bool LAZY>
__global__ void __launch_bounds__(QUAD_THREADS)
role_kernel(const u32* __restrict__ A, const u32* __restrict__ V,
            u32* __restrict__ A2, u32* __restrict__ V2,
            u32* __restrict__ partials, unsigned* __restrict__ ticket,
            u32* __restrict__ dots, long long npairs, Fe rj) {
  __shared__ u32 sums[QUAD_THREADS / 32][NW];
  const int role = threadIdx.x / ROLE_THREADS;
  u32 x[NW];
  role_sweep<LAZY>(
      A, V, A2, V2, npairs,
      blockIdx.x * (long long)ROLE_THREADS + threadIdx.x % ROLE_THREADS,
      (long long)gridDim.x * ROLE_THREADS, rj.w, role, x);
  role_warp_sums(x, role, sums);
  __syncthreads();
  if (threadIdx.x < NVAL) role_value(sums, threadIdx.x, x);
  grid_finish(x, partials, ticket, dots);
}

// A DOT_PROD phase-1 round split by role.  Per pair i, with a/da from V1,
// b/db from V0 and m0/dm from m-pair (i mod half_m): role 0 takes
// e0 = a b, role 1 e1 = da b + a db, role 2 e2 = da db, and each adds
// m0 e to lo and dm e to hi (canonical on return), so that
// c0 = lo_0, c1 = hi_0 + lo_1, c2 = hi_1 + lo_2, c3 = hi_2; role 3 folds
// V1, V0 and, where i < half_m, m.
template <bool LAZY>
__device__ __forceinline__ void cubic_role_sweep(
    const u32* M, const u32* V0, const u32* V1, u32* Mo, u32* V0o, u32* V1o,
    long long npairs, long long half_m, long long first, long long stride,
    const u32 r[NW], int role, u32 lo[NW], u32 hi[NW]) {
  if (role < CUBIC_TERMS) {
    Acc<LAZY> alo, ahi;
    alo.clear();
    ahi.clear();
    for (long long i = first; i < npairs; i += stride) {
      const long long j = i % half_m;
      u32 a[NW], b[NW], x[NW], e[NW];
      load(a, V1 + (2 * i) * NW);
      load(b, V0 + (2 * i) * NW);
      if (role == 0) {
        mont_mul(e, a, b);
      } else {
        u32 da[NW], db[NW];
        load(x, V1 + (2 * i + 1) * NW);
        sub_mod(da, x, a);
        load(x, V0 + (2 * i + 1) * NW);
        sub_mod(db, x, b);
        if (role == 1) {
          mont_mul(e, da, b);
          mont_mul(x, a, db);
          add_mod(e, e, x);
        } else {
          mont_mul(e, da, db);
        }
      }
      load(a, M + (2 * j) * NW);             // m0
      load(x, M + (2 * j + 1) * NW);
      sub_mod(b, x, a);                      // dm
      alo.add_prod(a, e);
      ahi.add_prod(b, e);
    }
    alo.finish(lo);
    ahi.finish(hi);
  } else {
    fold_sweep(V1, V1o, npairs, first, stride, r);
    fold_sweep(V0, V0o, npairs, first, stride, r);
    fold_sweep(M, Mo, half_m, first, stride, r);
  }
}

// After cubic_role_sweep: the warps of the term roles leave their sums
// in sums[warp]; after a __syncthreads, cubic_role_value gives thread
// t < 4 the block's coefficient c_t.
__device__ __forceinline__ void cubic_role_warp_sums(u32 lo[NW], u32 hi[NW],
                                                     int role,
                                                     u32 (*sums)[2][NW]) {
  if (role < CUBIC_TERMS) {
    warp_sum<1>(lo);
    warp_sum<1>(hi);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        sums[threadIdx.x >> 5][0][k] = lo[k];
        sums[threadIdx.x >> 5][1][k] = hi[k];
      }
    }
  }
}

__device__ __forceinline__ void cubic_role_value(u32 (*sums)[2][NW], int t,
                                                 u32 x[NW]) {
  set_zero(x);
#pragma unroll
  for (int w = 0; w < 2; ++w) {              // the two warps of a role
    u32 y[NW];
    if (t < CUBIC_TERMS) {                   // lo of role t
#pragma unroll
      for (int k = 0; k < NW; ++k) y[k] = sums[2 * t + w][0][k];
      add_mod(x, x, y);
    }
    if (t > 0) {                             // hi of role t - 1
#pragma unroll
      for (int k = 0; k < NW; ++k) y[k] = sums[2 * (t - 1) + w][1][k];
      add_mod(x, x, y);
    }
  }
}

// One wide DOT_PROD phase-1 round split by role (cubic_role_sweep): a
// block takes 64 pairs a sweep; coefficients to coeffs [4, 8].
template <bool LAZY>
__global__ void __launch_bounds__(CUBIC_THREADS)
cubic_role_kernel(const u32* __restrict__ M, const u32* __restrict__ V0,
                  const u32* __restrict__ V1, u32* __restrict__ Mo,
                  u32* __restrict__ V0o, u32* __restrict__ V1o,
                  u32* __restrict__ partials, unsigned* __restrict__ ticket,
                  u32* __restrict__ coeffs, long long npairs,
                  long long half_m, Fe rj) {
  __shared__ u32 sums[CUBIC_THREADS / 32][2][NW];
  const int role = threadIdx.x / ROLE_THREADS;
  u32 x[NW], y[NW];
  cubic_role_sweep<LAZY>(
      M, V0, V1, Mo, V0o, V1o, npairs, half_m,
      blockIdx.x * (long long)ROLE_THREADS + threadIdx.x % ROLE_THREADS,
      (long long)gridDim.x * ROLE_THREADS, rj.w, role, x, y);
  cubic_role_warp_sums(x, y, role, sums);
  __syncthreads();
  if (threadIdx.x < NVAL) cubic_role_value(sums, threadIdx.x, x);
  grid_finish(x, partials, ticket, coeffs);
}

// The tail of a quadratic ladder: one block, R rounds on `rows` rows.
// Round 0 reads A and V from device memory; round j < R-1 writes its
// folds to shared buffer j & 1 (rows/2 and rows/4 rows an operand) and
// round R-1 to A_out and V_out; dots is [R, 4, 8].  With DOTS a round is
// split by role (role_sweep); without, every thread folds pairs of A.
template <bool DOTS>
__global__ void __launch_bounds__(QUAD_THREADS)
tail_kernel(const u32* A, const u32* V, u32* A_out, u32* V_out, u32* dots,
            const __grid_constant__ Challenges rs, int rows, int R) {
  extern __shared__ uint4 smem4[];
  // per-warp sums of the dots, for rounds of either parity: a warp may
  // write round j + 1's while threads 0..3 still read round j's
  __shared__ u32 sums[2][QUAD_THREADS / 32][NW];
  u32* smem = reinterpret_cast<u32*>(smem4);
  const int h = rows / 2, q = rows / 4;
  u32* sA[2] = {smem, smem + h * NW};
  u32* sV[2] = {smem + (h + q) * NW, smem + (2 * h + q) * NW};
  const int role = threadIdx.x / ROLE_THREADS;
  const u32 *srcA = A, *srcV = V;
  for (int j = 0; j < R; ++j) {
    const int npairs = rows >> (j + 1);
    const bool last = j == R - 1;
    u32* dstA = last ? A_out : sA[j & 1];
    u32* dstV = last ? V_out : sV[j & 1];
    u32 r[NW], x[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = rs.w[j][k];
    if constexpr (DOTS) {
      role_sweep<false>(srcA, srcV, dstA, dstV, npairs,
                        threadIdx.x % ROLE_THREADS, ROLE_THREADS, r, role, x);
      role_warp_sums(x, role, sums[j & 1]);
    } else {
      fold_sweep(srcA, dstA, npairs, threadIdx.x, QUAD_THREADS, r);
    }
    __syncthreads();      // round j's folds and sums before they are read
    if (DOTS && threadIdx.x < NVAL) {
      role_value(sums[j & 1], threadIdx.x, x);
      store(dots + (j * NVAL + threadIdx.x) * NW, x);
    }
    srcA = dstA;
    srcV = dstV;
  }
}

// The tail of a cubic ladder: as tail_kernel, with three operands (m of
// m_rows rows, V0 and V1 of rows rows each) in shared memory and the
// rounds split by role (cubic_role_sweep).
__global__ void __launch_bounds__(CUBIC_THREADS)
cubic_tail_kernel(const u32* M, const u32* V0, const u32* V1, u32* M_out,
                  u32* V0_out, u32* V1_out, u32* coeffs,
                  const __grid_constant__ Challenges rs, int rows,
                  int m_rows, int R) {
  extern __shared__ uint4 smem4[];
  __shared__ u32 sums[2][CUBIC_THREADS / 32][2][NW];
  u32* smem = reinterpret_cast<u32*>(smem4);
  const int h = rows / 2, q = rows / 4, mh = m_rows / 2;
  u32* s0[2] = {smem, smem + h * NW};
  u32* s1[2] = {smem + (h + q) * NW, smem + (2 * h + q) * NW};
  u32* sM[2] = {smem + 2 * (h + q) * NW, smem + (2 * (h + q) + mh) * NW};
  const int role = threadIdx.x / ROLE_THREADS;
  const u32 *srcM = M, *src0 = V0, *src1 = V1;
  for (int j = 0; j < R; ++j) {
    const bool last = j == R - 1;
    u32* dstM = last ? M_out : sM[j & 1];
    u32* dst0 = last ? V0_out : s0[j & 1];
    u32* dst1 = last ? V1_out : s1[j & 1];
    u32 r[NW], x[NW], y[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = rs.w[j][k];
    cubic_role_sweep<false>(srcM, src0, src1, dstM, dst0, dst1,
                            rows >> (j + 1), m_rows >> (j + 1),
                            threadIdx.x % ROLE_THREADS, ROLE_THREADS, r, role,
                            x, y);
    cubic_role_warp_sums(x, y, role, sums[j & 1]);
    __syncthreads();      // round j's folds and sums before they are read
    if (threadIdx.x < NVAL) {
      cubic_role_value(sums[j & 1], threadIdx.x, x);
      store(coeffs + (j * NVAL + threadIdx.x) * NW, x);
    }
    srcM = dstM;
    src0 = dst0;
    src1 = dst1;
  }
}

// ---------------------------------------------------------------------
// One round of a Fiat-Shamir sumcheck: "fold at r_(j-1), then round j".
// Under Fiat-Shamir r_j is drawn only after round j's message, so a
// round cannot end with its own fold as a ladder's does: its launch first
// folds the operands at the previous round's challenge, then forms the
// message from the folded rows.  Without FOLD (round 1) the message comes
// from the operands as given.
//
// A block takes ROUND_PAIRS pairs of the folded operands a sweep.  First
// every thread folds (or loads) one row of the sweep into shared memory,
// writing a folded row out as well; then, after a __syncthreads, the
// threads split by role as in role_sweep, each adding one product of its
// pair to its accumulator.  A thread so chains one fold and one product a
// sweep.  The grid's sums go to out [4, 8] through grid_finish.

constexpr int ROUND_THREADS = 256;  // a block of a one-round kernel
constexpr int ROUND_PAIRS = 64;     // pairs of folded rows a block a sweep
constexpr int SWEEP_ROWS = 2 * ROUND_PAIRS;

// Row f of the round's operand X: X[2f] + r (X[2f+1] - X[2f]) when FOLD,
// else X[f].
template <bool FOLD>
__device__ __forceinline__ void round_row(u32 x[NW], const u32* X,
                                          long long f, const u32 r[NW]) {
  if (FOLD) {
    u32 x1[NW], d[NW];
    load(x, X + (2 * f) * NW);
    load(x1, X + (2 * f + 1) * NW);
    sub_mod(d, x1, x);
    fold_pair(x, x, d, r);
  } else {
    load(x, X + f * NW);
  }
}

__device__ __forceinline__ void copy_row(u32* dst, const u32 x[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) dst[k] = x[k];
}

// One quadratic round: the four pair dots D_xy = sum_i mont(A'[2i+x],
// V'[2i+y]) of the round's operands A', V' (npairs pairs), which are A and
// V folded at rj when FOLD (written to A2, V2), else A and V themselves.
template <bool FOLD, bool LAZY>
__global__ void __launch_bounds__(ROUND_THREADS)
fold_round_kernel(const u32* __restrict__ A, const u32* __restrict__ V,
                  u32* __restrict__ A2, u32* __restrict__ V2,
                  u32* __restrict__ partials, unsigned* __restrict__ ticket,
                  u32* __restrict__ dots, long long npairs, Fe rj) {
  __shared__ u32 ops[2][SWEEP_ROWS][NW];   // the sweep's rows of A', V'
  __shared__ u32 sums[ROUND_THREADS / 32][NW];
  const int t = threadIdx.x;
  const int role = t / ROLE_THREADS, lane = t % ROLE_THREADS;
  const int op = t / SWEEP_ROWS, k = t % SWEEP_ROWS;
  Acc<LAZY> acc;
  acc.clear();
  for (long long base = blockIdx.x * (long long)ROUND_PAIRS; base < npairs;
       base += (long long)gridDim.x * ROUND_PAIRS) {
    const long long f = 2 * base + k;
    if (f < 2 * npairs) {
      u32 x[NW];
      round_row<FOLD>(x, op ? V : A, f, rj.w);
      if (FOLD) store((op ? V2 : A2) + f * NW, x);
      copy_row(ops[op][k], x);
    }
    __syncthreads();      // the sweep's rows before the products read them
    if (base + lane < npairs)
      acc.add_prod(ops[0][2 * lane + (role >> 1)],
                   ops[1][2 * lane + (role & 1)]);
    __syncthreads();      // the products before the next sweep's rows
  }
  u32 x[NW];
  acc.finish(x);
  role_warp_sums(x, role, sums);
  __syncthreads();
  if (t < NVAL) role_value(sums, t, x);
  grid_finish(x, partials, ticket, dots);
}

// One DOT_PROD phase-1 round: c0..c3 of the round's operands m', V0', V1'
// (npairs pairs of V'), which are m (while it has more than one row), V0
// and V1 folded at rj when FOLD (written to Mo, V0o, V1o), else m, V0,
// V1.  Per pair i, as cubic_role_sweep: roles 0, 1, 2 form e0, e1, e2
// from V1' (a, da) and V0' (b, db) and add m0 e and dm e with the m' pair
// (i mod half_m).  When m' has one row (half_m = 0) both rows of every
// pair are m'[0], so dm = 0: c3 = 0 and c0..c2 are m'[0] times the
// quadratic coefficients of (V1', V0').  Role 3 has no product.
template <bool FOLD, bool LAZY>
__global__ void __launch_bounds__(ROUND_THREADS)
fold_cubic_round_kernel(const u32* __restrict__ M, const u32* __restrict__ V0,
                        const u32* __restrict__ V1, u32* __restrict__ Mo,
                        u32* __restrict__ V0o, u32* __restrict__ V1o,
                        u32* __restrict__ partials,
                        unsigned* __restrict__ ticket,
                        u32* __restrict__ coeffs, long long npairs,
                        long long m_rows, Fe rj) {
  // the sweep's rows of V0', V1' and, for each of its pairs, its m' pair
  __shared__ u32 ops[3][SWEEP_ROWS][NW];
  __shared__ u32 sums[ROUND_THREADS / 32][2][NW];
  const bool fold_m = FOLD && m_rows > 1;
  const long long half_m = (fold_m ? m_rows / 2 : m_rows) / 2;
  const int t = threadIdx.x;
  const int role = t / ROLE_THREADS, lane = t % ROLE_THREADS;
  const int op = t / SWEEP_ROWS, k = t % SWEEP_ROWS;
  Acc<LAZY> alo, ahi;
  alo.clear();
  ahi.clear();
  for (long long base = blockIdx.x * (long long)ROUND_PAIRS; base < npairs;
       base += (long long)gridDim.x * ROUND_PAIRS) {
    const long long f = 2 * base + k;
    if (f < 2 * npairs) {
      u32 x[NW];
      round_row<FOLD>(x, op ? V1 : V0, f, rj.w);
      if (FOLD) store((op ? V1o : V0o) + f * NW, x);
      copy_row(ops[op][k], x);
    }
    // thread t < SWEEP_ROWS: row t & 1 of the m' pair of local pair t / 2;
    // the thread whose pair i is that m' pair itself writes it out
    const long long i = base + k / 2;
    if (op == 0 && i < npairs) {
      const long long row = half_m ? 2 * (i % half_m) + (k & 1) : 0;
      const bool own = half_m ? i < half_m : (i == 0 && (k & 1) == 0);
      u32 x[NW];
      if (fold_m) {
        round_row<true>(x, M, row, rj.w);
        if (own) store(Mo + row * NW, x);
      } else {
        load(x, M + row * NW);
      }
      copy_row(ops[2][k], x);
    }
    __syncthreads();      // the sweep's rows before the products read them
    if (role < CUBIC_TERMS && base + lane < npairs) {
      const int p0 = 2 * lane, p1 = 2 * lane + 1;
      u32 e[NW], x[NW];
      if (role == 0) {
        mont_mul(e, ops[1][p0], ops[0][p0]);
      } else {
        u32 da[NW], db[NW];
        sub_mod(da, ops[1][p1], ops[1][p0]);
        sub_mod(db, ops[0][p1], ops[0][p0]);
        if (role == 1) {
          mont_mul(e, da, ops[0][p0]);
          mont_mul(x, ops[1][p0], db);
          add_mod(e, e, x);
        } else {
          mont_mul(e, da, db);
        }
      }
      sub_mod(x, ops[2][p1], ops[2][p0]);   // dm
      alo.add_prod(ops[2][p0], e);
      ahi.add_prod(x, e);
    }
    __syncthreads();      // the products before the next sweep's rows
  }
  u32 lo[NW], hi[NW];
  alo.finish(lo);
  ahi.finish(hi);
  cubic_role_warp_sums(lo, hi, role, sums);
  __syncthreads();
  if (t < NVAL) cubic_role_value(sums, t, lo);
  grid_finish(lo, partials, ticket, coeffs);
}

// ---------------------------------------------------------------------
// host side

// Carves the scratch of one ladder; with base 0 it only measures.
struct Bump {
  uintptr_t base;
  size_t off = 0;
  template <typename T>
  T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base + off);
    off += (n * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

// The rounds of a ladder that run as wide launches: round j while its
// operand has more than TAIL_ROWS rows.
int wide_rounds(long long rows, int R) {
  int w = 0;
  while (w < R && (rows >> w) > TAIL_ROWS) ++w;
  return w;
}

Fe to_fe(const u32* r8) {
  Fe r;
  for (int k = 0; k < NW; ++k) r.w[k] = r8[k];
  return r;
}

Challenges to_challenges(const u32* rs, int rounds) {
  Challenges c = {};
  for (int j = 0; j < rounds; ++j)
    for (int k = 0; k < NW; ++k) c.w[j][k] = rs[j * NW + k];
  return c;
}

bool lazy_round(long long rows) { return rows >= LAZY_ROWS; }

// Blocks of a wide launch over npairs pairs, pairs_per_block a sweep; a
// lazy round gives each thread at least LAZY_PAIRS pairs.
int blocks_for(long long npairs, int pairs_per_block, bool lazy) {
  const long long per_block =
      (long long)pairs_per_block * (lazy ? LAZY_PAIRS : 1);
  long long nb = (npairs + per_block - 1) / per_block;
  if (nb > MAX_BLOCKS) nb = MAX_BLOCKS;
  return nb < 1 ? 1 : (int)nb;
}

// Scratch of a ladder over n_ops operands of `rows` rows and, for the
// cubic ladder, m of m_rows rows: tickets and partials for the wide
// rounds with sums, and two buffers an operand for the folds that a
// wide round hands to the next round (round j writes buffer j & 1).
struct Scratch {
  unsigned* tickets = nullptr;
  u32* partials = nullptr;
  u32* op[3][2] = {};
  int wide = 0;
};

Scratch carve(Bump& b, long long rows, long long m_rows, int n_ops, int R) {
  Scratch s;
  s.wide = wide_rounds(rows, R);
  if (s.wide == 0) return s;
  if (n_ops > 1) {
    s.tickets = b.take<unsigned>(s.wide);
    // the most blocks any wide kernel launches
    s.partials = b.take<u32>(
        (size_t)blocks_for(rows / 2, ROLE_THREADS, false) * NVAL * NW);
  }
  // the last round of the ladder writes the caller's outputs
  const int handed = s.wide == R ? s.wide - 1 : s.wide;
  for (int o = 0; o < n_ops; ++o) {
    const long long n = (m_rows && o == 2) ? m_rows : rows;
    if (handed >= 1) s.op[o][0] = b.take<u32>((size_t)(n / 2) * NW);
    if (handed >= 2) s.op[o][1] = b.take<u32>((size_t)(n / 4) * NW);
  }
  return s;
}

// Round j of a quadratic ladder as a wide launch.
int launch_quad_wide(const u32* A, const u32* V, u32* A2, u32* V2,
                     const Scratch& sc, int j, u32* dots, long long rows,
                     const u32* rs, cudaStream_t s) {
  const long long npairs = rows / 2;
  const Fe r = to_fe(rs + j * NW);
  if (!V) {
    fold_kernel<<<blocks_for(npairs, THREADS, false), THREADS, 0, s>>>(
        A, A2, npairs, r);
    return cudaGetLastError();
  }
  const bool lazy = lazy_round(rows);
  unsigned* ticket = sc.tickets + j;
  u32* out = dots + (size_t)j * NVAL * NW;
  const int nb = blocks_for(npairs, ROLE_THREADS, lazy);
  if (lazy)
    role_kernel<true><<<nb, QUAD_THREADS, 0, s>>>(
        A, V, A2, V2, sc.partials, ticket, out, npairs, r);
  else
    role_kernel<false><<<nb, QUAD_THREADS, 0, s>>>(
        A, V, A2, V2, sc.partials, ticket, out, npairs, r);
  return cudaGetLastError();
}

// R quadratic rounds on (A, V), or R folds of A alone when V is null.
template <bool DOTS>
int quad_ladder(const u32* A, const u32* V, u32* A_out, u32* V_out,
                u32* dots, const u32* rs, void* scratch, long long rows,
                int R, cudaStream_t s, int* launches) {
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const Scratch sc = carve(b, rows, 0, DOTS ? 2 : 1, R);
  int err = 0, n = 0;
  if (sc.tickets) {
    err = cudaMemsetAsync(sc.tickets, 0, sc.wide * sizeof(unsigned), s);
    if (err) return err;
  }
  const u32 *srcA = A, *srcV = V;
  for (int j = 0; j < sc.wide; ++j) {
    const bool last = j == R - 1;
    u32* dstA = last ? A_out : sc.op[0][j & 1];
    u32* dstV = last ? V_out : sc.op[1][j & 1];
    err = launch_quad_wide(srcA, srcV, dstA, dstV, sc, j, dots, rows >> j,
                           rs, s);
    if (err) return err;
    ++n;
    srcA = dstA;
    srcV = dstV;
  }
  if (sc.wide < R) {
    const int tr = (int)(rows >> sc.wide), rounds = R - sc.wide;
    const size_t smem = rounds == 1 ? 0 :
        (size_t)(DOTS ? 2 : 1) * (tr / 2 + tr / 4) * NW * sizeof(u32);
    tail_kernel<DOTS><<<1, QUAD_THREADS, smem, s>>>(
        srcA, srcV, A_out, V_out,
        DOTS ? dots + (size_t)sc.wide * NVAL * NW : nullptr,
        to_challenges(rs + sc.wide * NW, rounds), tr, rounds);
    err = cudaGetLastError();
    if (err) return err;
    ++n;
  }
  *launches = n;
  return 0;
}

// Round j of a cubic ladder as a wide launch.
int launch_cubic_wide(const u32* M, const u32* V0, const u32* V1, u32* Mo,
                      u32* V0o, u32* V1o, const Scratch& sc, int j,
                      u32* coeffs, long long rows, long long m_rows,
                      const u32* rs, cudaStream_t s) {
  const long long npairs = rows / 2;
  const bool lazy = lazy_round(rows);
  const Fe r = to_fe(rs + j * NW);
  u32* out = coeffs + (size_t)j * NVAL * NW;
  const int nb = blocks_for(npairs, ROLE_THREADS, lazy);
  if (lazy)
    cubic_role_kernel<true><<<nb, CUBIC_THREADS, 0, s>>>(
        M, V0, V1, Mo, V0o, V1o, sc.partials, sc.tickets + j, out, npairs,
        m_rows / 2, r);
  else
    cubic_role_kernel<false><<<nb, CUBIC_THREADS, 0, s>>>(
        M, V0, V1, Mo, V0o, V1o, sc.partials, sc.tickets + j, out, npairs,
        m_rows / 2, r);
  return cudaGetLastError();
}

// The grid of a one-round launch over npairs pairs of the round's
// operands, and its scratch: a ticket and the blocks' partials when it has
// more than one block.
struct RoundGrid {
  int blocks;
  bool lazy;
  unsigned* ticket = nullptr;
  u32* partials = nullptr;
};

RoundGrid round_grid(long long npairs, void* scratch) {
  RoundGrid g;
  g.lazy = lazy_round(2 * npairs);
  g.blocks = blocks_for(npairs, ROUND_PAIRS, g.lazy);
  if (g.blocks > 1) {
    Bump b{reinterpret_cast<uintptr_t>(scratch)};
    g.ticket = b.take<unsigned>(1);
    g.partials = b.take<u32>((size_t)g.blocks * NVAL * NW);
  }
  return g;
}

// The pairs of a one-round launch's operands: rows / 4 after a fold,
// rows / 2 without.
long long round_pairs(long long rows, bool fold) {
  return fold ? rows / 4 : rows / 2;
}

int start_round(const RoundGrid& g, cudaStream_t s) {
  return g.ticket ? cudaMemsetAsync(g.ticket, 0, sizeof(unsigned), s) : 0;
}

}  // namespace

extern "C" {

// Bytes of scratch that one fold_round / fold_cubic_round launch on
// operands of `rows` rows needs (fold: at a challenge or not).
long long zk_round_scratch_bytes(long long rows, int fold) {
  const RoundGrid g = round_grid(round_pairs(rows, fold), nullptr);
  if (g.blocks == 1) return 0;
  Bump b{0};
  b.take<unsigned>(1);
  b.take<u32>((size_t)g.blocks * NVAL * NW);
  return (long long)b.off;
}

// One quadratic round: A, V [rows, 8]; r: the previous round's
// Montgomery challenge [8] on the host, or null for round 1.  With r,
// A_out and V_out [rows / 2, 8] receive the folds and rows must be a
// multiple of 4; without, rows is even and the outputs are unused.  dots:
// [4, 8] of the round's operands.  scratch: zk_round_scratch_bytes bytes.
int zk_fold_round(const void* A, const void* V, void* A_out, void* V_out,
                  void* dots, const void* r, void* scratch, long long rows,
                  void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = r != nullptr;
  const long long npairs = round_pairs(rows, fold);
  const RoundGrid g = round_grid(npairs, scratch);
  int err = start_round(g, s);
  if (err) return err;
  const Fe rj = fold ? to_fe(static_cast<const u32*>(r)) : Fe{};
  const u32* a = static_cast<const u32*>(A);
  const u32* v = static_cast<const u32*>(V);
  u32* a2 = static_cast<u32*>(A_out);
  u32* v2 = static_cast<u32*>(V_out);
  u32* d = static_cast<u32*>(dots);
#define ZK_FOLD_ROUND(F, L)                                               \
  fold_round_kernel<F, L><<<g.blocks, ROUND_THREADS, 0, s>>>(             \
      a, v, a2, v2, g.partials, g.ticket, d, npairs, rj)
  if (fold && g.lazy) ZK_FOLD_ROUND(true, true);
  else if (fold) ZK_FOLD_ROUND(true, false);
  else if (g.lazy) ZK_FOLD_ROUND(false, true);
  else ZK_FOLD_ROUND(false, false);
#undef ZK_FOLD_ROUND
  *launches = 1;
  return cudaGetLastError();
}

// One DOT_PROD phase-1 round: m [m_rows, 8], V0, V1 [rows, 8], with
// m_rows a divisor of rows; r as for zk_fold_round.  With r: rows a
// multiple of 4, V0_out, V1_out [rows / 2, 8] and, when m_rows > 1,
// m_out [m_rows / 2, 8] receive the folds (m_rows is then 2 or a multiple
// of 4).  coeffs: [4, 8].
int zk_fold_cubic_round(const void* m, const void* V0, const void* V1,
                        void* m_out, void* V0_out, void* V1_out,
                        void* coeffs, const void* r, void* scratch,
                        long long rows, long long m_rows, void* stream,
                        int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = r != nullptr;
  const long long npairs = round_pairs(rows, fold);
  const RoundGrid g = round_grid(npairs, scratch);
  int err = start_round(g, s);
  if (err) return err;
  const Fe rj = fold ? to_fe(static_cast<const u32*>(r)) : Fe{};
  const u32* mm = static_cast<const u32*>(m);
  const u32* v0 = static_cast<const u32*>(V0);
  const u32* v1 = static_cast<const u32*>(V1);
  u32* mo = static_cast<u32*>(m_out);
  u32* v0o = static_cast<u32*>(V0_out);
  u32* v1o = static_cast<u32*>(V1_out);
  u32* c = static_cast<u32*>(coeffs);
#define ZK_FOLD_CUBIC_ROUND(F, L)                                         \
  fold_cubic_round_kernel<F, L><<<g.blocks, ROUND_THREADS, 0, s>>>(       \
      mm, v0, v1, mo, v0o, v1o, g.partials, g.ticket, c, npairs, m_rows,  \
      rj)
  if (fold && g.lazy) ZK_FOLD_CUBIC_ROUND(true, true);
  else if (fold) ZK_FOLD_CUBIC_ROUND(true, false);
  else if (g.lazy) ZK_FOLD_CUBIC_ROUND(false, true);
  else ZK_FOLD_CUBIC_ROUND(false, false);
#undef ZK_FOLD_CUBIC_ROUND
  *launches = 1;
  return cudaGetLastError();
}

const char* zk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of scratch that a ladder of R rounds needs: n_ops operands of
// `rows` rows (1: fold ladder, 2: quadratic, 3: cubic, whose third
// operand m has m_rows rows).  0 when the ladder is one tail launch.
long long zk_ladder_scratch_bytes(long long rows, long long m_rows,
                                  int n_ops, int R) {
  Bump b{0};
  carve(b, rows, m_rows, n_ops, R);
  return (long long)b.off;
}

// R quadratic rounds (with_dots) or folds of A alone (!with_dots).
// A, V: [rows, 8] with rows a multiple of 2^R; A_out, V_out:
// [rows >> R, 8]; dots: [R, 4, 8]; rs: [R, 8] Montgomery challenges on
// the host; scratch: zk_ladder_scratch_bytes(rows, 0, with_dots ? 2 : 1,
// R) bytes.  *launches: the kernels launched.
int zk_round_ladder(const void* A, const void* V, void* A_out, void* V_out,
                    void* dots, const void* rs, void* scratch,
                    long long rows, int R, int with_dots, void* stream,
                    int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dots)
    return quad_ladder<true>(
        static_cast<const u32*>(A), static_cast<const u32*>(V),
        static_cast<u32*>(A_out), static_cast<u32*>(V_out),
        static_cast<u32*>(dots), static_cast<const u32*>(rs), scratch, rows,
        R, s, launches);
  return quad_ladder<false>(
      static_cast<const u32*>(A), nullptr, static_cast<u32*>(A_out),
      nullptr, nullptr, static_cast<const u32*>(rs), scratch, rows, R, s,
      launches);
}

// R DOT_PROD phase-1 rounds.  m: [m_rows, 8]; V0, V1: [rows, 8], with
// m_rows and rows multiples of 2^R and m_rows a divisor of rows; the
// outputs have m_rows >> R and rows >> R rows; coeffs: [R, 4, 8];
// scratch: zk_ladder_scratch_bytes(rows, m_rows, 3, R) bytes.
int zk_cubic_ladder(const void* m, const void* V0, const void* V1,
                    void* m_out, void* V0_out, void* V1_out, void* coeffs,
                    const void* rs, void* scratch, long long rows,
                    long long m_rows, int R, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u32* r8 = static_cast<const u32*>(rs);
  u32* co = static_cast<u32*>(coeffs);
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const Scratch sc = carve(b, rows, m_rows, 3, R);
  int err = 0, n = 0;
  if (sc.tickets) {
    err = cudaMemsetAsync(sc.tickets, 0, sc.wide * sizeof(unsigned), s);
    if (err) return err;
  }
  const u32* src0 = static_cast<const u32*>(V0);
  const u32* src1 = static_cast<const u32*>(V1);
  const u32* srcM = static_cast<const u32*>(m);
  for (int j = 0; j < sc.wide; ++j) {
    const bool last = j == R - 1;
    u32* dst0 = last ? static_cast<u32*>(V0_out) : sc.op[0][j & 1];
    u32* dst1 = last ? static_cast<u32*>(V1_out) : sc.op[1][j & 1];
    u32* dstM = last ? static_cast<u32*>(m_out) : sc.op[2][j & 1];
    err = launch_cubic_wide(srcM, src0, src1, dstM, dst0, dst1, sc, j, co,
                            rows >> j, m_rows >> j, r8, s);
    if (err) return err;
    ++n;
    src0 = dst0;
    src1 = dst1;
    srcM = dstM;
  }
  if (sc.wide < R) {
    const int tr = (int)(rows >> sc.wide), tm = (int)(m_rows >> sc.wide);
    const int rounds = R - sc.wide;
    const size_t smem = rounds == 1 ? 0 :
        (size_t)(2 * (tr / 2 + tr / 4) + tm / 2 + tm / 4) * NW * sizeof(u32);
    cubic_tail_kernel<<<1, CUBIC_THREADS, smem, s>>>(
        srcM, src0, src1, static_cast<u32*>(m_out),
        static_cast<u32*>(V0_out), static_cast<u32*>(V1_out),
        co + (size_t)sc.wide * NVAL * NW,
        to_challenges(r8 + sc.wide * NW, rounds), tr, tm, rounds);
    err = cudaGetLastError();
    if (err) return err;
    ++n;
  }
  *launches = n;
  return 0;
}

}  // extern "C"
