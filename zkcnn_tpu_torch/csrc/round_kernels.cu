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
//   * fold_round_kernel, fold_round_tail_kernel (zk_fold_round_phase,
//     and zk_fold_round for one round) and fold_cubic_round_kernel,
//     fold_cubic_round_tail_kernel (zk_fold_cubic_round_phase,
//     zk_fold_cubic_round): the same two functions rescheduled for a
//     Fiat-Shamir sumcheck, whose challenge r_j is drawn only after round
//     j's message: a launch folds at r_(j-1), then forms round j's dots
//     (or c0..c3) from the folded rows, and in a phase also forms the
//     message, absorbs it and draws r_j on the device tape (fs_tape.cuh),
//     so that a whole phase runs with no host in between (the JAX package
//     draws on its host: zkcnn_tpu/gkr/tape.py:58-86,
//     zkcnn_tpu/gkr/verifier.py:636-650).
//
// Data: a field element is 8 little-endian 32-bit words of its
// canonical Montgomery residue (R = 2^256), one 32-byte row; the Fr
// arithmetic is fr_arith.cuh's.  Every output is canonical, so it equals
// the JAX package bit for bit.
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

#include "fs_tape.cuh"      // Fr (fr_arith.cuh) and the Fiat-Shamir tape

using namespace fr;         // NW, P, R2, the sums and the product fr_mul

namespace {

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

// x + r d, the fold of a pair with even row x and difference d.
__device__ __forceinline__ void fold_pair(u32 out[NW], const u32 x[NW],
                                          const u32 d[NW], const u32 r[NW]) {
  u32 t[NW];
  fr_mul(t, d, r);
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
    fr_mul(t, a, b);
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
    fr_mul(out, x, R2);
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

// The grid's sums of NVAL values for each of nsides sides: thread t < 4 of
// each block holds the block's value t in x, and the blocks first[s] up to
// first[s + 1] (the grid's end for the last side) belong to side s.  Every
// block writes its values to its row of partials and takes a ticket
// (*ticket is 0 at the launch); in the block that takes the last one
// (every block of a one-block grid) out[s][v] then holds side s's sum of
// value v, and grid_sums returns true in all its threads.  Any whole
// number of warps up to 12.
__device__ bool grid_sums(u32 x[NW], u32* partials, unsigned* ticket,
                          int nsides, const int* first,
                          u32 (*out)[NVAL][NW]) {
  __shared__ u32 rows[QUAD_THREADS / 32][NVAL][NW];
  __shared__ bool is_last;
  if (gridDim.x == 1) {
    if (threadIdx.x < NVAL) copy(out[0][threadIdx.x], x);
    __syncthreads();
    return true;
  }
  if (threadIdx.x < NVAL)
    store(partials + (blockIdx.x * NVAL + threadIdx.x) * NW, x);
  __threadfence();            // this block's row before its ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();            // the other blocks' rows after their tickets
  // thread t sums value t & 3 over the side's blocks t >> 2,
  // t >> 2 + threads / 4, ...
  const int v = threadIdx.x & (NVAL - 1);
  for (int s = 0; s < nsides; ++s) {
    const int end = s + 1 < nsides ? first[s + 1] : (int)gridDim.x;
    set_zero(x);
    for (int b = first[s] + threadIdx.x / NVAL; b < end;
         b += blockDim.x / NVAL) {
      u32 y[NW];
      load_cg(y, partials + (b * NVAL + v) * NW);
      add_mod(x, x, y);
    }
    warp_sum<NVAL>(x);        // lanes 0..3: the warp's sums of values 0..3
    if ((threadIdx.x & 31) < NVAL) copy(rows[threadIdx.x >> 5][v], x);
    __syncthreads();
    if (threadIdx.x < NVAL) {
      set_zero(x);
      for (int w = 0; w < blockDim.x / 32; ++w) add_mod(x, x, rows[w][v]);
      copy(out[s][v], x);
    }
    __syncthreads();
  }
  return true;
}

// The grid's sums of NVAL values, of which thread t < 4 of each block
// holds the block's value t in x, into out [4, 8], within this launch
// (grid_sums over one side).
__device__ void grid_finish(u32 x[NW], u32* partials, unsigned* ticket,
                            u32* out) {
  __shared__ u32 sums[1][NVAL][NW];
  const int first = 0;
  if (grid_sums(x, partials, ticket, 1, &first, sums) && threadIdx.x < NVAL)
    store(out + threadIdx.x * NW, sums[0][threadIdx.x]);
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
        fr_mul(e, a, b);
      } else {
        u32 da[NW], db[NW];
        load(x, V1 + (2 * i + 1) * NW);
        sub_mod(da, x, a);
        load(x, V0 + (2 * i + 1) * NW);
        sub_mod(db, x, b);
        if (role == 1) {
          fr_mul(e, da, b);
          fr_mul(x, a, db);
          add_mod(e, e, x);
        } else {
          fr_mul(e, da, db);
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
// A Fiat-Shamir sumcheck: "fold at r_(j-1), then round j".
// Under Fiat-Shamir r_j is drawn only after round j's message, so a
// round cannot end with its own fold as a ladder's does: its launch first
// folds the operands at the previous round's challenge, then forms the
// message from the folded rows.  In round 0 the message comes from the
// operands as given.
//
// A phase runs as one launch sequence that the host enqueues without
// waiting (zk_fold_round_phase, zk_fold_cubic_round_phase): the
// challenge lives in device memory, in the phase buffer of fs_tape.cuh,
// and the launch that forms round j's message also absorbs it and draws
// r_j there, on the device tape, for the next launch to fold at.  So the
// host fetches once a phase, not once a round.
//   * A wide round (an operand of more than TAIL_ROWS rows) is one launch
//     over every active side of the phase, the sides' blocks one after the
//     other in the grid.  A block takes ROUND_PAIRS pairs of the folded
//     operands a sweep: every thread folds (or loads) one row of the sweep
//     into shared memory, writing the folded row out as well; then, after
//     a __syncthreads, the threads split by role as in role_sweep, each
//     adding one product of its pair to its accumulator.  The block that
//     takes the last ticket (grid_sums) holds every side's sums, and one
//     of its threads finishes the round: the message as the engine forms
//     it (fs::quad_finish, with add_term and the sides that exhaust in the
//     round), its absorb and the draw of r_j.
//   * The tail (every operand at most TAIL_ROWS rows): ONE block runs all
//     remaining rounds of the phase, as tail_kernel runs a ladder's, and
//     the fold at the last challenge, so that the sides end on their last
//     rows (the engines' `receive`).  Its operands ping-pong between two
//     shared regions; a round is the pair dots, the finish in one thread,
//     then the fold at the r_j it drew.
// The device tape is one thread's chain of SHA-512 compressions (three a
// round): a few microseconds a round that no host round trip waits on.
// The one-round form (zk_fold_round, zk_fold_cubic_round: the JAX
// package's per-round API) runs the wide kernels on one side, with the
// challenge written into a device slot from the host and no finish.

constexpr int ROUND_THREADS = 256;  // a block of a one-round kernel
constexpr int ROUND_PAIRS = 64;     // pairs of folded rows a block a sweep
constexpr int SWEEP_ROWS = 2 * ROUND_PAIRS;
constexpr int MAX_SIDES = 2;        // sides of a quadratic phase
// rows of an operand of a tail in shared memory: the first fold's (at
// most TAIL_ROWS / 2) and the second's, in turns
constexpr int TAIL_SLOT = TAIL_ROWS / 2 + TAIL_ROWS / 4;

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

// One side of a quadratic round: its stored operands, their folds at r
// (FOLD), the pairs of the round's operands and the side's first block.
struct QuadSide {
  const u32* A;
  const u32* V;
  u32* A2;
  u32* V2;
  long long npairs;
  int first;
};

// A side that exhausts in the round (fs::join_side): its stored rows (two,
// folded at r_(j-1); one in round 0) and fin [2, 8], its last rows.
struct Join {
  const u32* A;
  const u32* V;
  u32* fin;
};

struct QuadRound {
  QuadSide side[MAX_SIDES];
  int nsides;           // sides with blocks
  const u32* r;         // r_(j-1) in device memory (FOLD)
  u32* partials;
  unsigned* ticket;
  u32* dots;            // the one-round form: side 0's dots [4, 8]
  u32* buf;             // a phase's buffer; null in the one-round form
  int n, j, njoin;
  bool include;         // add_term in the messages (not in Liu's phase)
  Join join[MAX_SIDES];
  fs::Head head;        // round 0: the phase's head
};

// One quadratic round on every side of a: the four pair dots
// D_xy = sum_i mont(A'[2i+x], V'[2i+y]) of each side's round operands A',
// V', which are A and V folded at r when FOLD (written to A2, V2), else A
// and V themselves; then the one-round form's dots, or the phase's finish.
template <bool FOLD, bool LAZY>
__global__ void __launch_bounds__(ROUND_THREADS)
fold_round_kernel(const __grid_constant__ QuadRound a) {
  __shared__ u32 ops[2][SWEEP_ROWS][NW];   // the sweep's rows of A', V'
  __shared__ u32 sums[ROUND_THREADS / 32][NW];
  __shared__ u32 dots[MAX_SIDES][NVAL][NW];
  const int t = threadIdx.x;
  const int role = t / ROLE_THREADS, lane = t % ROLE_THREADS;
  const int op = t / SWEEP_ROWS, k = t % SWEEP_ROWS;
  const int s = a.nsides > 1 && (int)blockIdx.x >= a.side[1].first;
  const QuadSide& d = a.side[s];
  const long long blk = (long long)blockIdx.x - d.first;
  const long long nblk =
      (s + 1 < a.nsides ? a.side[s + 1].first : (int)gridDim.x) - d.first;
  u32 r[NW] = {};
  if (FOLD) load(r, a.r);
  Acc<LAZY> acc;
  acc.clear();
  for (long long base = blk * ROUND_PAIRS; base < d.npairs;
       base += nblk * ROUND_PAIRS) {
    const long long f = 2 * base + k;
    if (f < 2 * d.npairs) {
      u32 x[NW];
      round_row<FOLD>(x, op ? d.V : d.A, f, r);
      if (FOLD) store((op ? d.V2 : d.A2) + f * NW, x);
      copy(ops[op][k], x);
    }
    __syncthreads();      // the sweep's rows before the products read them
    if (base + lane < d.npairs)
      acc.add_prod(ops[0][2 * lane + (role >> 1)],
                   ops[1][2 * lane + (role & 1)]);
    __syncthreads();      // the products before the next sweep's rows
  }
  u32 x[NW];
  acc.finish(x);
  role_warp_sums(x, role, sums);
  __syncthreads();
  if (t < NVAL) role_value(sums, t, x);
  const int first[MAX_SIDES] = {a.side[0].first, a.side[1].first};
  if (!grid_sums(x, a.partials, a.ticket, a.nsides, first, dots)) return;
  if (a.dots && t < NVAL) store(a.dots + t * NW, dots[0][t]);
  if (a.buf && t == 0) {
    if (a.j == 0) fs::phase_init(a.buf, a.head);
    const u32* rp = a.j ? fs::phase_r(a.buf, a.j - 1) : nullptr;
    u32 prod[MAX_SIDES][NW];
    for (int i = 0; i < a.njoin; ++i)
      fs::join_side(prod[i], a.join[i].fin, a.join[i].A, a.join[i].V, rp);
    fs::quad_finish(a.buf, a.n, a.j, dots[0][0], a.nsides, prod[0],
                    a.njoin, a.include);
  }
}

struct CubicRound {
  const u32* M;
  const u32* V0;
  const u32* V1;
  u32* Mo;
  u32* V0o;
  u32* V1o;
  long long npairs;     // pairs of V0', V1'
  long long m_rows;     // rows of the stored m
  const u32* r;         // r_(j-1) in device memory (FOLD)
  u32* partials;
  unsigned* ticket;
  u32* coeffs;          // the one-round form: c0..c3 [4, 8]
  u32* buf;             // a phase's buffer; null in the one-round form
  int n, j;
  fs::Head head;        // round 0: the phase's head
};

// One DOT_PROD phase-1 round: c0..c3 of the round's operands m', V0', V1'
// (npairs pairs of V'), which are m (while it has more than one row), V0
// and V1 folded at r when FOLD (written to Mo, V0o, V1o), else m, V0,
// V1.  Per pair i, as cubic_role_sweep: roles 0, 1, 2 form e0, e1, e2
// from V1' (a, da) and V0' (b, db) and add m0 e and dm e with the m' pair
// (i mod half_m).  When m' has one row (half_m = 0) both rows of every
// pair are m'[0], so dm = 0: c3 = 0 and c0..c2 are m'[0] times the
// quadratic coefficients of (V1', V0').  Role 3 has no product.  Then the
// one-round form's coefficients, or the phase's finish.
template <bool FOLD, bool LAZY>
__global__ void __launch_bounds__(ROUND_THREADS)
fold_cubic_round_kernel(const __grid_constant__ CubicRound a) {
  // the sweep's rows of V0', V1' and, for each of its pairs, its m' pair
  __shared__ u32 ops[3][SWEEP_ROWS][NW];
  __shared__ u32 sums[ROUND_THREADS / 32][2][NW];
  __shared__ u32 coeffs[1][NVAL][NW];
  const bool fold_m = FOLD && a.m_rows > 1;
  const long long half_m = (fold_m ? a.m_rows / 2 : a.m_rows) / 2;
  const int t = threadIdx.x;
  const int role = t / ROLE_THREADS, lane = t % ROLE_THREADS;
  const int op = t / SWEEP_ROWS, k = t % SWEEP_ROWS;
  u32 r[NW] = {};
  if (FOLD) load(r, a.r);
  Acc<LAZY> alo, ahi;
  alo.clear();
  ahi.clear();
  for (long long base = blockIdx.x * (long long)ROUND_PAIRS; base < a.npairs;
       base += (long long)gridDim.x * ROUND_PAIRS) {
    const long long f = 2 * base + k;
    if (f < 2 * a.npairs) {
      u32 x[NW];
      round_row<FOLD>(x, op ? a.V1 : a.V0, f, r);
      if (FOLD) store((op ? a.V1o : a.V0o) + f * NW, x);
      copy(ops[op][k], x);
    }
    // thread t < SWEEP_ROWS: row t & 1 of the m' pair of local pair t / 2;
    // the thread whose pair i is that m' pair itself writes it out
    const long long i = base + k / 2;
    if (op == 0 && i < a.npairs) {
      const long long row = half_m ? 2 * (i % half_m) + (k & 1) : 0;
      const bool own = half_m ? i < half_m : (i == 0 && (k & 1) == 0);
      u32 x[NW];
      if (fold_m) {
        round_row<true>(x, a.M, row, r);
        if (own) store(a.Mo + row * NW, x);
      } else {
        load(x, a.M + row * NW);
      }
      copy(ops[2][k], x);
    }
    __syncthreads();      // the sweep's rows before the products read them
    if (role < CUBIC_TERMS && base + lane < a.npairs) {
      const int p0 = 2 * lane, p1 = 2 * lane + 1;
      u32 e[NW], x[NW];
      if (role == 0) {
        fr_mul(e, ops[1][p0], ops[0][p0]);
      } else {
        u32 da[NW], db[NW];
        sub_mod(da, ops[1][p1], ops[1][p0]);
        sub_mod(db, ops[0][p1], ops[0][p0]);
        if (role == 1) {
          fr_mul(e, da, ops[0][p0]);
          fr_mul(x, ops[1][p0], db);
          add_mod(e, e, x);
        } else {
          fr_mul(e, da, db);
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
  const int first = 0;
  if (!grid_sums(lo, a.partials, a.ticket, 1, &first, coeffs)) return;
  if (a.coeffs && t < NVAL) store(a.coeffs + t * NW, coeffs[0][t]);
  if (a.buf && t == 0) {
    if (a.j == 0) fs::phase_init(a.buf, a.head);
    fs::cubic_finish(a.buf, a.n, a.j, coeffs[0][0]);
  }
}

// The check entry of the device tape (zk_fs_tape_check): case i absorbs
// the k values vals[i] into states[i] (to out_states[i]), draws from that
// state at counters[i] (r to out_r[i], the counter after to
// out_counters[i]), and reduces the digest digests[i] (to out_red[i]).
__global__ void fs_tape_check_kernel(const u32* states, const u32* vals,
                                     int k, const u32* counters,
                                     const u32* digests, u32* out_states,
                                     u32* out_r, u32* out_counters,
                                     u32* out_red, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 st[fs::STATE_WORDS], ctr[2];
  for (int w = 0; w < fs::STATE_WORDS; ++w)
    st[w] = states[i * fs::STATE_WORDS + w];
  fs::fs_absorb(st, vals + i * k * NW, k);
  ctr[0] = counters[2 * i];
  ctr[1] = counters[2 * i + 1];
  fs::fs_draw(out_r + i * NW, st, ctr);
  for (int w = 0; w < fs::STATE_WORDS; ++w)
    out_states[i * fs::STATE_WORDS + w] = st[w];
  out_counters[2 * i] = ctr[0];
  out_counters[2 * i + 1] = ctr[1];
  fs::digest_to_fr(out_red + i * NW, digests + i * fs::STATE_WORDS);
}

// An operand of a tail: its current rows (cur, rows of them; rows 0: none
// left), its shared slot of TAIL_SLOT rows, where its one row goes once it
// has one (last), and whether it folds at this round's challenge.
struct TailOp {
  const u32* cur;
  int rows;
  u32* slot;
  u32* last;
  bool fold;
};

// The folds at r of the nops operands that fold, by all threads of the
// block: to region `turn` of their slot, or to `last` where one row
// results.  Every thread then points cur at the folded rows.
__device__ void tail_fold(TailOp* op, int nops, const u32* r, int turn) {
  for (int o = 0; o < nops; ++o) {
    if (!op[o].fold) continue;
    const int h = op[o].rows / 2;
    u32* dst = h == 1 ? op[o].last
                      : op[o].slot + (turn ? TAIL_ROWS / 2 : 0) * NW;
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      fold_at(dst + i * NW, op[o].cur + 2 * i * NW,
              op[o].cur + (2 * i + 1) * NW, r);
    op[o].cur = dst;
    op[o].rows = h;
  }
  __syncthreads();        // the folds before anything reads them
}

struct QuadTail {
  const u32* A[MAX_SIDES];  // a side's stored operands at round j0; null:
  const u32* V[MAX_SIDES];  // no side, or one that exhausted before j0
  int nb[MAX_SIDES];        // log2 of its rows at the phase's start
  u32* fin[MAX_SIDES];      // [2, 8]: its last A and V rows
  u32* buf;
  int n, j0;
  bool include;
  fs::Head head;            // j0 = 0: the phase's head
};

// Rounds j0..n-1 of a quadratic phase in one block, and the fold at
// r_(n-1): a side is active in round j < nb (its stored rows at j0 are
// 2^nb, or 2^(nb - j0 + 1) after a fold at r_(j0-1)), exhausts in round
// nb < n, and ends on its last rows after the fold at r_(n-1) when nb = n.
__global__ void __launch_bounds__(ROUND_THREADS)
fold_round_tail_kernel(const __grid_constant__ QuadTail a) {
  __shared__ u32 slot[2 * MAX_SIDES][TAIL_SLOT][NW];
  __shared__ u32 dots[MAX_SIDES][NVAL][NW];
  __shared__ u32 r[NW];
  const int t = threadIdx.x;
  TailOp op[2 * MAX_SIDES];
  for (int o = 0; o < 2 * MAX_SIDES; ++o) {
    const int s = o >> 1;
    op[o].cur = (o & 1) ? a.V[s] : a.A[s];
    op[o].rows = !op[o].cur ? 0
                 : 1 << (a.j0 ? a.nb[s] - a.j0 + 1 : a.nb[s]);
    op[o].slot = slot[o][0];
    op[o].last = a.fin[s] + (o & 1) * NW;
    op[o].fold = op[o].rows > 1;
  }
  int turn = 0;
  if (a.j0 > 0) {         // the fold at r_(j0-1) that the wide rounds left
    if (t < NW) r[t] = fs::phase_r(a.buf, a.j0 - 1)[t];
    __syncthreads();
    tail_fold(op, 2 * MAX_SIDES, r, turn);
    turn ^= 1;
  }
  for (int j = a.j0; j < a.n; ++j) {
    // the pair dots of the active sides (two rows or more): 128 threads a
    // side, a warp a dot
    int act[MAX_SIDES], nact = 0;
    for (int s = 0; s < MAX_SIDES; ++s)
      if (op[2 * s].rows > 1) act[nact++] = s;
    const int k = t >> 7, v = (t >> 5) & 3, lane = t & 31;
    if (k < nact) {
      const TailOp& A = op[2 * act[k]];
      const TailOp& V = op[2 * act[k] + 1];
      Acc<false> acc;
      acc.clear();
      for (int i = lane; i < A.rows / 2; i += 32)
        acc.add_prod(A.cur + (2 * i + (v >> 1)) * NW,
                     V.cur + (2 * i + (v & 1)) * NW);
      u32 x[NW];
      acc.finish(x);
      warp_sum<1>(x);
      if (lane == 0) copy(dots[k][v], x);
    }
    __syncthreads();
    if (t == 0) {
      if (j == 0) fs::phase_init(a.buf, a.head);
      u32 prod[MAX_SIDES][NW];
      int nj = 0;
      for (int s = 0; s < MAX_SIDES; ++s)   // a side of one row exhausts
        if (op[2 * s].rows == 1)
          fs::join_side(prod[nj++], a.fin[s], op[2 * s].cur,
                        op[2 * s + 1].cur, nullptr);
      fs::quad_finish(a.buf, a.n, j, dots[0][0], nact, prod[0], nj,
                      a.include);
      copy(r, fs::phase_r(a.buf, j));
    }
    __syncthreads();
    for (int o = 0; o < 2 * MAX_SIDES; ++o) {
      if (op[o & ~1].rows == 1) op[o].rows = 0;   // it joined add_term
      op[o].fold = op[o].rows > 1;
    }
    tail_fold(op, 2 * MAX_SIDES, r, turn);
    turn ^= 1;
  }
  if (t == 0) fs::quad_receive(a.buf, a.n, a.include);
}

struct CubicTail {
  const u32* M;             // the stored operands at round j0
  const u32* V0;
  const u32* V1;
  int rows, m_rows;         // their rows
  u32* fin;                 // [3, 8]: the last rows of m, V0, V1
  u32* buf;
  int n, j0;
  fs::Head head;            // j0 = 0: the phase's head
};

// The terms of a DOT_PROD round on operands in the tail (cubic_role_sweep's
// sums without its folds): roles 0..2 of the block, each lane a pair in
// ROLE_THREADS; m has m_rows rows (one row: dm = 0).
__device__ void tail_cubic_terms(const u32* M, int m_rows, const u32* V0,
                                 const u32* V1, int npairs, int role,
                                 int lane, u32 lo[NW], u32 hi[NW]) {
  Acc<false> alo, ahi;
  alo.clear();
  ahi.clear();
  const int half_m = m_rows / 2;
  for (int i = lane; role < CUBIC_TERMS && i < npairs; i += ROLE_THREADS) {
    const u32* a0 = V1 + 2 * i * NW;
    const u32* b0 = V0 + 2 * i * NW;
    u32 e[NW], x[NW];
    if (role == 0) {
      fr_mul(e, a0, b0);
    } else {
      u32 da[NW], db[NW];
      sub_mod(da, a0 + NW, a0);
      sub_mod(db, b0 + NW, b0);
      if (role == 1) {
        fr_mul(e, da, b0);
        fr_mul(x, a0, db);
        add_mod(e, e, x);
      } else {
        fr_mul(e, da, db);
      }
    }
    const u32* m0 = half_m ? M + 2 * (i % half_m) * NW : M;
    if (half_m) sub_mod(x, m0 + NW, m0);     // dm
    else set_zero(x);
    alo.add_prod(m0, e);
    ahi.add_prod(x, e);
  }
  alo.finish(lo);
  ahi.finish(hi);
}

// Rounds j0..n-1 of a DOT_PROD phase 1 in one block, and the fold at
// r_(n-1); m folds while it has more than one row.
__global__ void __launch_bounds__(ROUND_THREADS)
fold_cubic_round_tail_kernel(const __grid_constant__ CubicTail a) {
  __shared__ u32 slot[3][TAIL_SLOT][NW];
  __shared__ u32 sums[ROUND_THREADS / 32][2][NW];
  __shared__ u32 c[NVAL][NW];
  __shared__ u32 r[NW];
  const int t = threadIdx.x;
  const int role = t / ROLE_THREADS, lane = t % ROLE_THREADS;
  TailOp op[3];           // m, V0, V1
  const u32* src[3] = {a.M, a.V0, a.V1};
  for (int o = 0; o < 3; ++o) {
    op[o].cur = src[o];
    op[o].rows = o ? a.rows : a.m_rows;
    op[o].slot = slot[o][0];
    op[o].last = a.fin + o * NW;
    op[o].fold = op[o].rows > 1;
  }
  int turn = 0;
  if (a.j0 > 0) {         // the fold at r_(j0-1) that the wide rounds left
    if (t < NW) r[t] = fs::phase_r(a.buf, a.j0 - 1)[t];
    __syncthreads();
    tail_fold(op, 3, r, turn);
    turn ^= 1;
  }
  for (int j = a.j0; j < a.n; ++j) {
    u32 lo[NW], hi[NW];
    tail_cubic_terms(op[0].cur, op[0].rows, op[1].cur, op[2].cur,
                     op[1].rows / 2, role, lane, lo, hi);
    cubic_role_warp_sums(lo, hi, role, sums);
    __syncthreads();
    if (t < NVAL) {
      cubic_role_value(sums, t, lo);
      copy(c[t], lo);
    }
    __syncthreads();
    if (t == 0) {
      if (j == 0) fs::phase_init(a.buf, a.head);
      fs::cubic_finish(a.buf, a.n, j, c[0]);
      copy(r, fs::phase_r(a.buf, j));
    }
    __syncthreads();
    for (int o = 0; o < 3; ++o) op[o].fold = op[o].rows > 1;
    tail_fold(op, 3, r, turn);
    turn ^= 1;
  }
  if (t == 0 && op[0].cur != a.fin) copy(a.fin, op[0].cur);  // m of one row
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

// A one-round launch of either form: the round's kernel, at FOLD and LAZY.
int launch_quad_round(const QuadRound& a, bool fold, bool lazy, int blocks,
                      cudaStream_t s) {
#define ZK_FOLD_ROUND(F, L) \
  fold_round_kernel<F, L><<<blocks, ROUND_THREADS, 0, s>>>(a)
  if (fold && lazy) ZK_FOLD_ROUND(true, true);
  else if (fold) ZK_FOLD_ROUND(true, false);
  else if (lazy) ZK_FOLD_ROUND(false, true);
  else ZK_FOLD_ROUND(false, false);
#undef ZK_FOLD_ROUND
  return cudaGetLastError();
}

int launch_cubic_round(const CubicRound& a, bool fold, bool lazy, int blocks,
                       cudaStream_t s) {
#define ZK_FOLD_CUBIC_ROUND(F, L) \
  fold_cubic_round_kernel<F, L><<<blocks, ROUND_THREADS, 0, s>>>(a)
  if (fold && lazy) ZK_FOLD_CUBIC_ROUND(true, true);
  else if (fold) ZK_FOLD_CUBIC_ROUND(true, false);
  else if (lazy) ZK_FOLD_CUBIC_ROUND(false, true);
  else ZK_FOLD_CUBIC_ROUND(false, false);
#undef ZK_FOLD_CUBIC_ROUND
  return cudaGetLastError();
}

// The pairs of a one-round launch's operands: rows / 4 after a fold,
// rows / 2 without.
long long round_pairs(long long rows, bool fold) {
  return fold ? rows / 4 : rows / 2;
}

// The scratch of a one-round launch: the challenge's slot (fold), and a
// ticket and the blocks' partials when it has more than one block.
struct RoundScratch {
  u32* r = nullptr;
  unsigned* ticket = nullptr;
  u32* partials = nullptr;
};

RoundScratch carve_round(Bump& b, int blocks, bool fold) {
  RoundScratch sc;
  if (fold) sc.r = b.take<u32>(NW);
  if (blocks > 1) {
    sc.ticket = b.take<unsigned>(1);
    sc.partials = b.take<u32>((size_t)blocks * NVAL * NW);
  }
  return sc;
}

// The challenge from the host into its slot, and the ticket cleared.
int start_round(const RoundScratch& sc, const void* r, cudaStream_t s) {
  int err = 0;
  if (sc.r)
    err = cudaMemcpyAsync(sc.r, r, NW * sizeof(u32), cudaMemcpyHostToDevice,
                          s);
  if (!err && sc.ticket)
    err = cudaMemsetAsync(sc.ticket, 0, sizeof(unsigned), s);
  return err;
}

// A quadratic phase of n rounds on sides of 2^nb[s] rows (nb[s] < 0: no
// side): side s is active in rounds j < nb[s], with 2^nb[s] stored rows in
// round 0 and 2^(nb[s] - j + 1) in round j > 0, and exhausts in round
// nb[s] (or ends with the fold at r_(n-1) when nb[s] = n).
long long stored_rows(int nb, int j) {
  return j ? 1LL << (nb - j + 1) : 1LL << nb;
}

long long side_pairs(int nb, int j) {
  return stored_rows(nb, j) >> (j ? 2 : 1);
}

// The wide rounds of a quadratic phase: round j while an active side has
// more than TAIL_ROWS stored rows.
int quad_phase_wide(const int* nb, int n) {
  int w = 0;
  for (; w < n; ++w) {
    bool wide = false;
    for (int s = 0; s < MAX_SIDES; ++s)
      wide |= w < nb[s] && stored_rows(nb[s], w) > TAIL_ROWS;
    if (!wide) break;
  }
  return w;
}

// A quadratic phase's grid in wide round j: each active side's first
// block into first[s] (-1: no blocks), the grid's blocks returned, and
// whether a side's dots are lazy.
int quad_phase_grid(const int* nb, int j, int* first, bool* lazy) {
  int blocks = 0;
  *lazy = false;
  for (int s = 0; s < MAX_SIDES; ++s) {
    first[s] = -1;
    if (j >= nb[s]) continue;
    const long long np = side_pairs(nb[s], j);
    const bool lz = lazy_round(2 * np);
    first[s] = blocks;
    blocks += blocks_for(np, ROUND_PAIRS, lz);
    *lazy |= lz;
  }
  return blocks;
}

// The scratch of a quadratic phase: a ticket a wide round, the partials
// of the largest grid, and two buffers an operand of a side that a wide
// round j > 0 folds (round j writes buffer (j - 1) & 1).
struct QuadPhaseScratch {
  unsigned* tickets = nullptr;
  u32* partials = nullptr;
  u32* op[MAX_SIDES][2][2] = {};
  int wide = 0;
};

QuadPhaseScratch carve_quad_phase(Bump& b, const int* nb, int n) {
  QuadPhaseScratch sc;
  sc.wide = quad_phase_wide(nb, n);
  if (!sc.wide) return sc;
  sc.tickets = b.take<unsigned>(sc.wide);
  int most = 0, first[MAX_SIDES];
  bool lazy;
  for (int j = 0; j < sc.wide; ++j) {
    const int blocks = quad_phase_grid(nb, j, first, &lazy);
    most = blocks > most ? blocks : most;
  }
  sc.partials = b.take<u32>((size_t)most * NVAL * NW);
  for (int s = 0; s < MAX_SIDES; ++s) {
    const int folded = nb[s] < sc.wide ? nb[s] : sc.wide;  // rounds 1..
    for (int o = 0; o < 2; ++o) {
      if (folded > 1) sc.op[s][o][0] = b.take<u32>((1LL << (nb[s] - 1)) * NW);
      if (folded > 2) sc.op[s][o][1] = b.take<u32>((1LL << (nb[s] - 2)) * NW);
    }
  }
  return sc;
}

// A DOT_PROD phase 1 of n rounds: V0, V1 of rows = 2^n rows, m of m_rows
// (a power of two at most rows), which folds while it has more than one
// row.  The stored rows of V and of m in round j:
long long cubic_stored(long long rows, int j) {
  return j ? rows >> (j - 1) : rows;
}

long long cubic_m_stored(long long m_rows, int j) {
  const long long m = j ? m_rows >> (j - 1) : m_rows;
  return m > 1 ? m : 1;
}

int cubic_phase_wide(long long rows, int n) {
  int w = 0;
  while (w < n && cubic_stored(rows, w) > TAIL_ROWS) ++w;
  return w;
}

struct CubicPhaseScratch {
  unsigned* tickets = nullptr;
  u32* partials = nullptr;
  u32* op[3][2] = {};   // m, V0, V1
  int wide = 0;
};

CubicPhaseScratch carve_cubic_phase(Bump& b, long long rows,
                                    long long m_rows, int n) {
  CubicPhaseScratch sc;
  sc.wide = cubic_phase_wide(rows, n);
  if (!sc.wide) return sc;
  sc.tickets = b.take<unsigned>(sc.wide);
  // the largest grid is round 0's
  sc.partials = b.take<u32>((size_t)blocks_for(
      rows / 2, ROUND_PAIRS, lazy_round(rows)) * NVAL * NW);
  for (int k = 0; k < 2 && k + 1 < sc.wide; ++k) {
    const long long m = (m_rows >> (k + 1)) > 1 ? m_rows >> (k + 1) : 1;
    sc.op[0][k] = b.take<u32>((size_t)m * NW);
    sc.op[1][k] = b.take<u32>((size_t)(rows >> (k + 1)) * NW);
    sc.op[2][k] = b.take<u32>((size_t)(rows >> (k + 1)) * NW);
  }
  return sc;
}

int clear_tickets(unsigned* tickets, int n, cudaStream_t s) {
  return tickets ? cudaMemsetAsync(tickets, 0, n * sizeof(unsigned), s) : 0;
}

fs::Head to_head(const void* head, const void* add) {
  fs::Head h;
  for (int i = 0; i < fs::HEAD_WORDS; ++i)
    h.w[i] = static_cast<const u32*>(head)[i];
  h.add = static_cast<const u32*>(add);
  return h;
}

}  // namespace

extern "C" {

// Bytes of scratch that one fold_round / fold_cubic_round launch on
// operands of `rows` rows needs (fold: at a challenge or not).
long long zk_round_scratch_bytes(long long rows, int fold) {
  const long long npairs = round_pairs(rows, fold);
  Bump b{0};
  carve_round(b, blocks_for(npairs, ROUND_PAIRS, lazy_round(2 * npairs)),
              fold);
  return (long long)b.off;
}

// One quadratic round: A, V [rows, 8]; r: the previous round's
// Montgomery challenge [8] on the host, or null for round 1, which goes
// to its device slot.  With r, A_out and V_out [rows / 2, 8] receive the
// folds and rows must be a multiple of 4; without, rows is even and the
// outputs are unused.  dots: [4, 8] of the round's operands.  scratch:
// zk_round_scratch_bytes bytes.
int zk_fold_round(const void* A, const void* V, void* A_out, void* V_out,
                  void* dots, const void* r, void* scratch, long long rows,
                  void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fold = r != nullptr;
  const long long npairs = round_pairs(rows, fold);
  const bool lazy = lazy_round(2 * npairs);
  const int blocks = blocks_for(npairs, ROUND_PAIRS, lazy);
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const RoundScratch sc = carve_round(b, blocks, fold);
  int err = start_round(sc, r, s);
  if (err) return err;
  QuadRound a = {};
  a.side[0] = {static_cast<const u32*>(A), static_cast<const u32*>(V),
               static_cast<u32*>(A_out), static_cast<u32*>(V_out), npairs,
               0};
  a.nsides = 1;
  a.r = sc.r;
  a.partials = sc.partials;
  a.ticket = sc.ticket;
  a.dots = static_cast<u32*>(dots);
  *launches = 1;
  return launch_quad_round(a, fold, lazy, blocks, s);
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
  const bool lazy = lazy_round(2 * npairs);
  const int blocks = blocks_for(npairs, ROUND_PAIRS, lazy);
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const RoundScratch sc = carve_round(b, blocks, fold);
  int err = start_round(sc, r, s);
  if (err) return err;
  CubicRound a = {};
  a.M = static_cast<const u32*>(m);
  a.V0 = static_cast<const u32*>(V0);
  a.V1 = static_cast<const u32*>(V1);
  a.Mo = static_cast<u32*>(m_out);
  a.V0o = static_cast<u32*>(V0_out);
  a.V1o = static_cast<u32*>(V1_out);
  a.npairs = npairs;
  a.m_rows = m_rows;
  a.r = sc.r;
  a.partials = sc.partials;
  a.ticket = sc.ticket;
  a.coeffs = static_cast<u32*>(coeffs);
  *launches = 1;
  return launch_cubic_round(a, fold, lazy, blocks, s);
}

// The words of a phase buffer's head (fs_tape.cuh), for the wrappers.
int zk_phase_head_words() { return fs::HEAD_WORDS; }

// Bytes of scratch of a quadratic phase (zk_fold_round_phase).
long long zk_fold_round_phase_scratch(const int* nb, int n) {
  Bump b{0};
  carve_quad_phase(b, nb, n);
  return (long long)b.off;
}

// A quadratic sumcheck phase of n rounds under the Fiat-Shamir tape, one
// launch sequence: a launch a wide round, then one tail.  ops: A0, V0, A1,
// V1, side s's operands of 2^nb[s] rows (nb[s] < 0: no side; nb[s] <= n).
// fin: [2, 2, 8], each side's last A and V rows.  buf: the phase buffer
// (fs_tape.cuh) of HEAD_ROWS + 4 n rows, which it fills: the tape's state
// and counter after the phase, add_term after the last fold, r_0..r_(n-1)
// and the messages.  head: HEAD_WORDS words on the host (the tape's state,
// counter and add_term at the start); add: add_term in device memory
// instead, or null.  include: add_term in the messages.  scratch:
// zk_fold_round_phase_scratch bytes.  *launches: the kernels launched.
int zk_fold_round_phase(const void* const* ops, const int* nb, void* fin,
                        void* buf, const void* head, const void* add,
                        void* scratch, int n, int include, void* stream,
                        int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const QuadPhaseScratch sc = carve_quad_phase(b, nb, n);
  int err = clear_tickets(sc.tickets, sc.wide, s), count = 0;
  if (err) return err;
  const fs::Head h = to_head(head, add);
  u32* pb = static_cast<u32*>(buf);
  u32* fins = static_cast<u32*>(fin);
  const u32* cur[MAX_SIDES][2];
  for (int side = 0; side < MAX_SIDES; ++side)
    for (int o = 0; o < 2; ++o)
      cur[side][o] = static_cast<const u32*>(ops[2 * side + o]);
  for (int j = 0; j < sc.wide; ++j) {
    QuadRound a = {};
    int first[MAX_SIDES];
    bool lazy;
    const int blocks = quad_phase_grid(nb, j, first, &lazy);
    for (int side = 0; side < MAX_SIDES; ++side) {
      if (first[side] >= 0) {
        QuadSide& d = a.side[a.nsides++];
        d.A = cur[side][0];
        d.V = cur[side][1];
        if (j) {
          d.A2 = sc.op[side][0][(j - 1) & 1];
          d.V2 = sc.op[side][1][(j - 1) & 1];
        }
        d.npairs = side_pairs(nb[side], j);
        d.first = first[side];
      } else if (j == nb[side]) {
        a.join[a.njoin++] = {cur[side][0], cur[side][1],
                             fins + 2 * side * NW};
      }
    }
    a.r = j ? pb + (fs::HEAD_ROWS + j - 1) * NW : nullptr;  // r_(j-1)
    a.partials = sc.partials;
    a.ticket = sc.tickets + j;
    a.buf = pb;
    a.n = n;
    a.j = j;
    a.include = include != 0;
    a.head = h;
    err = launch_quad_round(a, j > 0, lazy, blocks, s);
    if (err) return err;
    ++count;
    for (int side = 0; side < MAX_SIDES && j; ++side) {
      if (first[side] < 0) continue;
      const QuadSide& d = a.side[first[side] ? a.nsides - 1 : 0];
      cur[side][0] = d.A2;
      cur[side][1] = d.V2;
    }
  }
  QuadTail t = {};
  for (int side = 0; side < MAX_SIDES; ++side) {
    if (nb[side] >= sc.wide) {      // not exhausted in a wide round
      t.A[side] = cur[side][0];
      t.V[side] = cur[side][1];
    }
    t.nb[side] = nb[side];
    t.fin[side] = fins + 2 * side * NW;
  }
  t.buf = pb;
  t.n = n;
  t.j0 = sc.wide;
  t.include = include != 0;
  t.head = h;
  fold_round_tail_kernel<<<1, ROUND_THREADS, 0, s>>>(t);
  err = cudaGetLastError();
  if (err) return err;
  *launches = count + 1;
  return 0;
}

// Bytes of scratch of a DOT_PROD phase 1 (zk_fold_cubic_round_phase).
long long zk_fold_cubic_round_phase_scratch(long long rows, long long m_rows,
                                            int n) {
  Bump b{0};
  carve_cubic_phase(b, rows, m_rows, n);
  return (long long)b.off;
}

// A DOT_PROD phase 1 of n rounds under the Fiat-Shamir tape, one launch
// sequence: m [m_rows, 8] (a power of two, at most rows), V0, V1
// [rows, 8] with rows = 2^n.  fin: [3, 8], the last rows of m, V0, V1;
// buf: the phase buffer of HEAD_ROWS + 5 n rows; head as for
// zk_fold_round_phase (its add_term unused); scratch:
// zk_fold_cubic_round_phase_scratch bytes.
int zk_fold_cubic_round_phase(const void* m, const void* V0, const void* V1,
                              void* fin, void* buf, const void* head,
                              void* scratch, long long rows,
                              long long m_rows, int n, void* stream,
                              int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Bump b{reinterpret_cast<uintptr_t>(scratch)};
  const CubicPhaseScratch sc = carve_cubic_phase(b, rows, m_rows, n);
  int err = clear_tickets(sc.tickets, sc.wide, s), count = 0;
  if (err) return err;
  const fs::Head h = to_head(head, nullptr);
  u32* pb = static_cast<u32*>(buf);
  const u32* cur[3] = {static_cast<const u32*>(m),
                       static_cast<const u32*>(V0),
                       static_cast<const u32*>(V1)};
  for (int j = 0; j < sc.wide; ++j) {
    CubicRound a = {};
    const long long npairs = cubic_stored(rows, j) >> (j ? 2 : 1);
    const bool lazy = lazy_round(2 * npairs);
    a.M = cur[0];
    a.V0 = cur[1];
    a.V1 = cur[2];
    a.m_rows = cubic_m_stored(m_rows, j);
    if (j) {
      if (a.m_rows > 1) a.Mo = sc.op[0][(j - 1) & 1];
      a.V0o = sc.op[1][(j - 1) & 1];
      a.V1o = sc.op[2][(j - 1) & 1];
    }
    a.npairs = npairs;
    a.r = j ? pb + (fs::HEAD_ROWS + j - 1) * NW : nullptr;  // r_(j-1)
    a.partials = sc.partials;
    a.ticket = sc.tickets + j;
    a.buf = pb;
    a.n = n;
    a.j = j;
    a.head = h;
    err = launch_cubic_round(a, j > 0, lazy,
                             blocks_for(npairs, ROUND_PAIRS, lazy), s);
    if (err) return err;
    ++count;
    if (j) {
      if (a.Mo) cur[0] = a.Mo;
      cur[1] = a.V0o;
      cur[2] = a.V1o;
    }
  }
  CubicTail t = {};
  t.M = cur[0];
  t.V0 = cur[1];
  t.V1 = cur[2];
  t.rows = (int)cubic_stored(rows, sc.wide);
  t.m_rows = (int)cubic_m_stored(m_rows, sc.wide);
  t.fin = static_cast<u32*>(fin);
  t.buf = pb;
  t.n = n;
  t.j0 = sc.wide;
  t.head = h;
  fold_cubic_round_tail_kernel<<<1, ROUND_THREADS, 0, s>>>(t);
  err = cudaGetLastError();
  if (err) return err;
  *launches = count + 1;
  return 0;
}

// The device tape against the host's (chip_smoke.py): n cases of
// fs_tape_check_kernel, a thread each.  states, out_states, digests:
// [n, 16] words; vals: [n, k, 8] Montgomery; counters, out_counters:
// [n, 2] (low word first); out_r, out_red: [n, 8] Montgomery.
int zk_fs_tape_check(const void* states, const void* vals, int k,
                     const void* counters, const void* digests,
                     void* out_states, void* out_r, void* out_counters,
                     void* out_red, long long n, void* stream) {
  const int threads = 128;
  fs_tape_check_kernel<<<(int)((n + threads - 1) / threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(states), static_cast<const u32*>(vals), k,
      static_cast<const u32*>(counters), static_cast<const u32*>(digests),
      static_cast<u32*>(out_states), static_cast<u32*>(out_r),
      static_cast<u32*>(out_counters), static_cast<u32*>(out_red), n);
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
