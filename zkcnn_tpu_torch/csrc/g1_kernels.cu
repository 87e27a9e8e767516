// BLS12-381 G1 kernels for Hopper (sm_90a), plain C ABI for ctypes.
//
// The Hyrax commitment's curve arithmetic.  The JAX package has no Pallas
// kernel here: its curve programs are XLA programs that fuse a whole
// formula.  Plain PyTorch cannot stand in for them on the card (one Fp
// product is a few hundred small launches, one scalar multiplication about
// 255 x 24 products), so each program is one kernel or two:
//   * g1_add_kernel (zk_g1_add): zkcnn_tpu/pcs/curve.py::padd and, with no
//     second operand, ::pdouble, elementwise over n points;
//   * g1_scalar_mul_kernel (zk_g1_scalar_mul): curve.py::scalar_mul with a
//     point a thread (the inner-product opening's folds of G) and one plain
//     scalar (or one shared scalar) a thread.  The thread keeps its
//     accumulator and a table of 15 multiples over all steps (4-bit
//     windows: 254 doublings and up to 64 additions), where the XLA
//     program runs a 255-step loop of whole-batch programs;
//   * g1_table_lanes_kernel, then g1_table_round_kernel three times
//     (zk_g1_msm_table):
//     zkcnn_tpu/pcs/msm.py:100 build_table (called from :269), the
//     fixed-base table that FixedBaseMSM builds when it is made.  For each
//     base P and window j it holds d 2^(4j) P, d = 1..15 (4-bit digits,
//     unsigned; the JAX package's signed radix-256 digits and GLV are not
//     carried over).  Its first kernel runs the chain 2^t P, t < 4 nwin,
//     and stores each as entry d = 1, 2, 4 or 8 of its window; then three
//     launches add the other 11 digits in rounds (entry m + e = entry m +
//     entry e, e < m, m = 2, 4, 8).  The chain bounds the table: 255
//     doublings, each waiting for the last, whatever N, so its time is
//     latency.  One thread a base ran it at 7 dependent Fp products a
//     doubling (2.8 ms for one base); here a group of lanes of one warp
//     runs a base's chain (g1_arith.cuh, table_chain_lanes): the three
//     products of each of a doubling's three dependency levels at once on
//     three sub-groups, each product split by words over the TABLE_LANES
//     lanes of its sub-group, so a doubling waits for 3 products of about
//     a third of the latency, and the group's lanes share its stores.  A
//     block takes TABLE_WARPS warps, so 512 bases spread over 256 blocks.
//     The digits run a thread an addition, a launch a round.
//     g1_table_thread_kernel (the one-thread chain this replaced) stays as
//     the reference that chip_smoke.py holds the lane chain against;
//   * ipa_round_kernel (zk_ipa_round): round k of the inner-product
//     opening on the original generators and Q (zkcnn_tpu_torch/pcs/
//     ipa.py), the JAX package's round zkcnn_tpu/pcs/ipa.py:86-108 without
//     its curve work: the folds of b and x at the previous challenge
//     (:52-59, its _fold_scalars), the two Q-column dots (:94-95) and, in
//     place of its fold of G by a scalar multiplication (:62), the weights
//     by that challenge and the two MSM rows (g1_arith.cuh: ipa_fold_dots,
//     ipa_dot_step, ipa_rows).  In plain PyTorch a round is four Fr ops
//     and the rows' gathers, about a thousand small launches; here it is
//     one block: each thread folds a few pairs and sums its share of the
//     dots, a tree of modular sums in shared memory joins the shares, and
//     after a barrier (b' is read at partner indices that other threads
//     wrote) each thread forms a few terms of the rows.  Bound by its
//     launch: at 512 generators a round moves at most about 130 KB and
//     does at most about 2,300 Fr products, tens of nanoseconds of the
//     card's bytes or multiplies, against tens of microseconds of launch
//     and wrapper; one block keeps every step in one launch with no
//     ticket between blocks, and a round's work grows with L in that one
//     block (at most IPA_MAX_L generators, zk_ipa_max_l);
//   * g1_msm_kernel + g1_sum_rows_kernel (zk_g1_msm):
//     msm.py::FixedBaseMSM.compute and ipa.py::_msm_small on that table,
//     and curve.py::scalar_mul with one shared point (one base, a row a
//     scalar).  Row r is the sum over terms i and windows j of
//     T_i[j][digit_j(k_ri)]: no doubling.  A thread takes one term and
//     MSM_SPLIT windows of it (at most 16 additions), a block sums its
//     threads by a tree in shared memory, and a second launch sums a
//     row's block sums.  The XLA design (a gather of [R, 2N] points a
//     window, a dense tree and a Horner step of 8 doublings between
//     windows) exists because XLA is dense; no gathered tensor is made.
//
// Data: a point is [3, 12] words (X, Y, Z), each coordinate the canonical
// Montgomery residue (R = 2^384) in 12 little-endian 32-bit words; Z == 0
// is infinity.  A scalar is 8 words.  A table is [N, nwin, 15, 3, 12]
// words (Jacobian entries, 144 bytes each: 70.8 MB for 512 bases).
// Results are group elements: they equal the plain PyTorch versions and
// the JAX package as points (after normalising Z), not word for word,
// because the order of additions differs.
//
// What bounds it on this card: 32-bit integer multiplies.  An Fp product
// is 288 of them (144 for the product, 144 for its reduction), a doubling
// 7 products, an addition 16.  The table costs 255 doublings a base and
// 11 additions a window; an MSM then costs one addition a nonzero digit
// (about 64 a 255-bit term), against 144 bytes a table entry read.  For
// one or two rows the bound is a chain: the table's 255 dependent
// doublings (on lane groups, above), then a thread's 16 additions and the
// trees.  Left for later work: GLV, signed digits, Z = 1 entries with
// mixed addition (a batch inversion), Pippenger buckets for very large N.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "g1_arith.cuh"

namespace {

using namespace g1;

constexpr int ADD_THREADS = 128;   // a block of g1_add_kernel
constexpr int MUL_THREADS = 64;    // a block of g1_scalar_mul_kernel
constexpr int CHAIN_THREADS = 64;  // bases a block of g1_table_thread_kernel
constexpr int TABLE_LANES = 6;     // lanes a product of g1_table_lanes_kernel
constexpr int TABLE_GROUPS = 3;    // products a doubling level runs at once
constexpr int TABLE_WARPS = 2;     // warps a block of g1_table_lanes_kernel
constexpr int ROUND_THREADS = 64;  // a block of g1_table_round_kernel
constexpr int MSM_SPLIT = 4;       // threads a term: NWIN / 4 windows each
constexpr int MSM_THREADS = 64;    // the largest block of the MSM kernels
constexpr int FP_THREADS = 128;    // a block of fp_mul_kernel
constexpr int IPA_THREADS = 256;   // the one block of ipa_round_kernel
constexpr long long IPA_MAX_L = 1LL << 16;   // generators ipa_round takes

// out[i] = p[i] + q[i], or 2 p[i] where q is null.
__global__ void g1_add_kernel(const u32* __restrict__ p,
                              const u32* __restrict__ q,
                              u32* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, b;
  pt_load(&a, p + i * PW);
  if (q) {
    pt_load(&b, q + i * PW);
    pt_add(&a, &a, &b);
  } else {
    pt_double(&a, &a);
  }
  pt_store(out + i * PW, &a);
}

// out[i] = k[i] p[i] over the low nbits bits of the plain scalar k[i]; a
// stride of 0 shares one scalar among all threads.
__global__ void g1_scalar_mul_kernel(const u32* __restrict__ pts,
                                     const u32* __restrict__ ks,
                                     long long k_stride,
                                     u32* __restrict__ out, long long n,
                                     int nbits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, acc;
  u32 k[NR];
  pt_load(&p, pts + i * PW);
#pragma unroll
  for (int j = 0; j < NR; ++j) k[j] = ks[i * k_stride + j];
  pt_scalar_mul(&acc, &p, k, nbits);
  pt_store(out + i * PW, &acc);
}

// Thread i: entries d = 1, 2, 4, 8 of every window of base i's table, one
// thread's chain (for comparison with g1_table_lanes_kernel).
__global__ void g1_table_thread_kernel(const u32* __restrict__ pts,
                                      u32* __restrict__ tab, long long N,
                                      int nwin) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  Pt p;
  pt_load(&p, pts + i * PW);
  table_chain(tab + i * nwin * WTAB * PW, &p, nwin);
}

// The same on lane groups: TABLE_LANES lanes a product, TABLE_GROUPS
// products at once (table_chain_lanes).
__global__ void g1_table_lanes_kernel(const u32* __restrict__ pts,
                                      u32* __restrict__ tab, long long N,
                                      int nwin) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  table_chain_lanes<TABLE_LANES, TABLE_GROUPS>(tab, pts, N, nwin, t / WARP,
                                               (int)(threadIdx.x % WARP));
}

// Round m of the digit multiples, one thread an addition: thread a <
// pairs (m - 1) makes entry m + e of pair a / (m - 1), e = a mod (m - 1)
// + 1 (table_step).
__global__ void g1_table_round_kernel(u32* tab, long long pairs, int m) {
  const long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= pairs * (m - 1)) return;
  table_step(tab + a / (m - 1) * WTAB * PW, m, (int)(a % (m - 1)) + 1);
}

// The points of a block summed by a tree in shared memory; the sum ends
// in sh[0].  Every thread of the block calls it; blockDim.x is a power of
// two.
__device__ __forceinline__ void block_sum(Pt* sh) {
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      pt_add(&sh[threadIdx.x], &sh[threadIdx.x], &sh[threadIdx.x + s]);
    __syncthreads();
  }
}

// Block (r, b) sums terms b * tpb .. b * tpb + tpb - 1 of row r on the
// table: thread (term, q) adds the entries of windows q * per ..
// (q + 1) * per - 1, per = nwin / MSM_SPLIT rounded up.  ks: [R, N, 8]
// scalars, Montgomery (mont) or plain; tab: [N, nwin, 15, 3, 12]; out:
// [R, blocks_per_row, 3, 12].
__global__ void g1_msm_kernel(const u32* __restrict__ tab,
                              const u32* __restrict__ ks,
                              u32* __restrict__ out, long long N,
                              int blocks_per_row, int nwin, int nbits,
                              int mont) {
  __shared__ Pt sh[MSM_THREADS];
  const int tpb = blockDim.x / MSM_SPLIT;
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x % blocks_per_row;
  const long long i = (long long)b * tpb + threadIdx.x / MSM_SPLIT;
  const int q = threadIdx.x % MSM_SPLIT;
  Pt acc;
  pt_set_inf(&acc);
  if (i < N) {
    u32 k[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) k[j] = ks[(r * N + i) * NR + j];
    if (mont) fr_from_mont(k);
    const int per = (nwin + MSM_SPLIT - 1) / MSM_SPLIT;
    const int j0 = q * per;
    const int j1 = j0 + per < nwin ? j0 + per : nwin;
    table_sum(&acc, tab + i * nwin * WTAB * PW, k, j0, j1, nbits);
  }
  pt_copy(&sh[threadIdx.x], &acc);
  block_sum(sh);
  if (threadIdx.x == 0) pt_store(out + (size_t)blockIdx.x * PW, &sh[0]);
}

// Block r sums the `parts` points of row r: parts [R, parts, 3, 12] ->
// out [R, 3, 12].
__global__ void g1_sum_rows_kernel(const u32* __restrict__ parts,
                                   u32* __restrict__ out, int n_parts) {
  __shared__ Pt sh[MSM_THREADS];
  const u32* row = parts + (size_t)blockIdx.x * n_parts * PW;
  Pt acc, t;
  pt_set_inf(&acc);
  for (int j = threadIdx.x; j < n_parts; j += blockDim.x) {
    pt_load(&t, row + (size_t)j * PW);
    pt_add(&acc, &acc, &t);
  }
  pt_copy(&sh[threadIdx.x], &acc);
  block_sum(sh);
  if (threadIdx.x == 0) pt_store(out + (size_t)blockIdx.x * PW, &sh[0]);
}

// (c, c^-1) of the inner-product opening's last round, by value.
struct FrPair {
  u32 w[2 * NR];
};

// Round k of the opening in one block (g1_arith.cuh): the fold and the
// thread's share of the dots, the tree of the dots, a barrier, the rows.
__global__ void __launch_bounds__(IPA_THREADS)
    ipa_round_kernel(const u32* b, const u32* x, const u32* s_in, u32* s_out,
                     FrPair c, int fold, u32* b_out, u32* x_out, u32* rows,
                     long long L, long long n) {
  __shared__ u32 sums[2 * IPA_THREADS * NR];
  const int t = threadIdx.x;
  const u32* cp = fold ? c.w : nullptr;
  ipa_fold_dots(b, x, cp, b_out, x_out, n, t, IPA_THREADS, sums + t * NR,
                sums + (IPA_THREADS + t) * NR);
  for (int step = IPA_THREADS / 2; step > 0; step >>= 1) {
    __syncthreads();
    ipa_dot_step(sums, IPA_THREADS, t, step);
  }
  __syncthreads();   // the sums, and b' in device memory, for the block
  ipa_rows(fold ? b_out : b, s_in, fold ? s_out : nullptr, cp, sums, rows,
           L, n, t, IPA_THREADS);
}

// The Fp product alone, for checking it and its latency: out[i] =
// a[i] b[i] R^-1 (chain = 0), or, in one thread, x <- x b[0] `chain` times
// from x = a[0] (dependent products).
__global__ void fp_mul_kernel(const u32* __restrict__ a,
                              const u32* __restrict__ b,
                              u32* __restrict__ out, long long n,
                              long long chain) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[NP], y[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    x[k] = a[i * NP + k];
    y[k] = b[i * NP + k];
  }
  if (chain == 0) {
    fp_mul(x, x, y);
  } else {
    for (long long s = 0; s < chain; ++s) fp_mul(x, x, y);
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) out[i * NP + k] = x[k];
}

// The lane product alone (fp_mul_lanes): a pair a sub-group of
// TABLE_LANES lanes.
__global__ void fp_mul_lanes_kernel(const u32* __restrict__ a,
                                    const u32* __restrict__ b,
                                    u32* __restrict__ out, long long n,
                                    long long chain) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  fp_mul_lanes<TABLE_LANES>(out, a, b, n, chain, t / WARP,
                            (int)(threadIdx.x % WARP));
}

// The chain of a table (entries d = 1, 2, 4, 8 of every window): on lane
// groups, or in one thread a base where one_thread is set.
int launch_chain(const u32* pts, u32* tab, long long N, int nwin,
                 int one_thread, cudaStream_t s) {
  if (one_thread) {
    g1_table_thread_kernel<<<(unsigned)((N + CHAIN_THREADS - 1) /
                                        CHAIN_THREADS),
                             CHAIN_THREADS, 0, s>>>(pts, tab, N, nwin);
  } else {
    constexpr int per = WARP / (TABLE_LANES * TABLE_GROUPS);   // bases a warp
    const long long warps = (N + per - 1) / per;
    g1_table_lanes_kernel<<<(unsigned)((warps + TABLE_WARPS - 1) /
                                       TABLE_WARPS),
                            TABLE_WARPS * WARP, 0, s>>>(pts, tab, N, nwin);
  }
  return cudaGetLastError();
}

// The digit multiples of a table whose chain entries are in place: a
// launch a round, a thread an addition.
int launch_digits(u32* tab, long long N, int nwin, cudaStream_t s) {
  const long long pairs = N * nwin;
  if (pairs > (1LL << 30)) return cudaErrorInvalidValue;   // grid sizes
  for (int m = 2; m < WTAB; m *= 2) {
    const long long adds = pairs * (m - 1);
    g1_table_round_kernel<<<(unsigned)((adds + ROUND_THREADS - 1) /
                                       ROUND_THREADS),
                            ROUND_THREADS, 0, s>>>(tab, pairs, m);
    const int err = cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// Threads a block of the MSM for N terms: MSM_SPLIT a term, up to 16
// terms, a power of two.
int msm_block(long long N) {
  int tpb = 1;
  while (tpb < N && tpb * MSM_SPLIT < MSM_THREADS) tpb *= 2;
  return tpb * MSM_SPLIT;
}

}  // namespace

extern "C" {

const char* zk_g1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[i] = p[i] + q[i] for i < n, or 2 p[i] where q is null.  p, q, out:
// [n, 3, 12].
int zk_g1_add(const void* p, const void* q, void* out, long long n,
              void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + ADD_THREADS - 1) / ADD_THREADS);
  g1_add_kernel<<<blocks, ADD_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(p), static_cast<const u32*>(q),
      static_cast<u32*>(out), n);
  return cudaGetLastError();
}

// out[i] = k[i] p[i] for i < n over the low nbits (1..256) bits of the
// plain scalars.  pts: [n, 3, 12] (one shared point goes to the table:
// zk_g1_msm_table and zk_g1_msm with N = 1); k_stride: 8 for [n, 8]
// scalars, 0 for one shared scalar.
int zk_g1_scalar_mul(const void* pts, const void* ks, long long k_stride,
                     void* out, long long n, int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 1 || nbits > 32 * NR) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + MUL_THREADS - 1) / MUL_THREADS);
  g1_scalar_mul_kernel<<<blocks, MUL_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(pts), static_cast<const u32*>(ks), k_stride,
      static_cast<u32*>(out), n, nbits);
  return cudaGetLastError();
}

// The table of N bases over nwin (1..64) windows: pts [N, 3, 12] -> tab
// [N, nwin, 15, 3, 12].  *launches: the kernels launched.
int zk_g1_msm_table(const void* pts, void* tab, long long N, int nwin,
                    void* stream, int* launches) {
  *launches = 0;
  if (N <= 0 || nwin < 1 || nwin > NWIN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch_chain(static_cast<const u32*>(pts), static_cast<u32*>(tab),
                         N, nwin, 0, s);
  if (err) return err;
  *launches = 1;
  err = launch_digits(static_cast<u32*>(tab), N, nwin, s);
  if (err) return err;
  *launches = 4;                   // the chain and three rounds of digits
  return 0;
}

// The two stages of zk_g1_msm_table apart, for timing them: the chain
// (entries d = 1, 2, 4, 8) on lane groups, or in one thread a base where
// one_thread is set (the reference), and the other digits on a table
// whose chain is in place.
int zk_g1_table_chain(const void* pts, void* tab, long long N, int nwin,
                      int one_thread, void* stream) {
  if (N <= 0 || nwin < 1 || nwin > NWIN) return cudaErrorInvalidValue;
  return launch_chain(static_cast<const u32*>(pts), static_cast<u32*>(tab), N,
                      nwin, one_thread, static_cast<cudaStream_t>(stream));
}

int zk_g1_table_digits(void* tab, long long N, int nwin, void* stream) {
  if (N <= 0 || nwin < 1 || nwin > NWIN) return cudaErrorInvalidValue;
  return launch_digits(static_cast<u32*>(tab), N, nwin,
                       static_cast<cudaStream_t>(stream));
}

// The lanes of zk_g1_msm_table's chain: *product lanes a product, *base
// lanes a base.
void zk_g1_table_lanes(int* product, int* base) {
  *product = TABLE_LANES;
  *base = TABLE_LANES * TABLE_GROUPS;
}

// The block sums a row of N terms is cut into; with 1 the sums of
// g1_msm_kernel are the result and `parts` is not needed.
long long zk_g1_msm_parts(long long N) {
  const int tpb = msm_block(N) / MSM_SPLIT;
  return (N + tpb - 1) / tpb;
}

// out[r] = sum_i ks[r, i] P_i from the table of the P_i.  tab: [N, nwin,
// 15, 3, 12] (zk_g1_msm_table); ks: [R, N, 8] scalars, Montgomery where
// mont is 1, else plain, of which the low nbits bits count (nbits <=
// 4 nwin); out: [R, 3, 12]; parts: [R, zk_g1_msm_parts(N), 3, 12]
// scratch, or null where that count is 1.  *launches: the kernels
// launched.
int zk_g1_msm(const void* tab, const void* ks, void* out, void* parts,
              long long R, long long N, int nwin, int nbits, int mont,
              void* stream, int* launches) {
  *launches = 0;
  if (R <= 0 || N <= 0 || nwin < 1 || nwin > NWIN || nbits < 1 ||
      nbits > WBITS * nwin)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_row = zk_g1_msm_parts(N);
  if (R * per_row > 0x7fffffffLL) return cudaErrorInvalidValue;
  u32* first = static_cast<u32*>(per_row == 1 ? out : parts);
  if (!first) return cudaErrorInvalidValue;
  g1_msm_kernel<<<(unsigned)(R * per_row), msm_block(N), 0, s>>>(
      static_cast<const u32*>(tab), static_cast<const u32*>(ks), first, N,
      (int)per_row, nwin, nbits, mont);
  int err = cudaGetLastError();
  if (err) return err;
  *launches = 1;
  if (per_row > 1) {
    g1_sum_rows_kernel<<<(unsigned)R, MSM_THREADS, 0, s>>>(
        first, static_cast<u32*>(out), (int)per_row);
    err = cudaGetLastError();
    if (err) return err;
    *launches = 2;
  }
  return 0;
}

// Round k of the inner-product opening on the original generators and Q,
// one launch: b, x [m, 8] (m = 2n where chal is given, else n) fold at the
// previous round's (c, c^-1) (chal: host words [2, 8]) to b_out, x_out
// [n, 8], and the weights s_in [L, 8] of the round before become s_out
// [L, 8]; in round 0 (chal null: no fold) b, x and s_in are the round's
// own and b_out, x_out and s_out are not written (they may be null).
// rows [2, L + 1, 8] get the two MSM rows with the Q column
// (<b'_lo, x'_hi>, <b'_hi, x'_lo>).  All Montgomery words; L and n powers
// of two, 2 <= n <= L <= zk_ipa_max_l().  s_out may be s_in; b_out and
// x_out must not overlap b or x.
long long zk_ipa_max_l() { return IPA_MAX_L; }

int zk_ipa_round(const void* b, const void* x, const void* s_in, void* s_out,
                 const void* chal, void* b_out, void* x_out, void* rows,
                 long long L, long long n, void* stream) {
  if (n < 2 || n > L || L > IPA_MAX_L || (n & (n - 1)) || (L & (L - 1)))
    return cudaErrorInvalidValue;
  FrPair c = {};
  if (chal)
    for (int j = 0; j < 2 * NR; ++j) c.w[j] = static_cast<const u32*>(chal)[j];
  ipa_round_kernel<<<1, IPA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(b), static_cast<const u32*>(x),
      static_cast<const u32*>(s_in), static_cast<u32*>(s_out), c,
      chal != nullptr, static_cast<u32*>(b_out), static_cast<u32*>(x_out),
      static_cast<u32*>(rows), L, n);
  return cudaGetLastError();
}

// The check entry of the Fp product: out[i] = a[i] b[i] R^-1 mod p for
// i < n ([n, 12] canonical Montgomery words) where chain is 0; else one
// thread multiplies a[0] by b[0] `chain` times over, each product waiting
// for the last, into out[0].
int zk_fp_mul(const void* a, const void* b, void* out, long long n,
              long long chain, void* stream) {
  if (n <= 0 || chain < 0 || (chain && n != 1)) return cudaErrorInvalidValue;
  fp_mul_kernel<<<(unsigned)((n + FP_THREADS - 1) / FP_THREADS), FP_THREADS,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(a), static_cast<const u32*>(b),
      static_cast<u32*>(out), n, chain);
  return cudaGetLastError();
}

// The check entry of the lane product: the same as zk_fp_mul with a
// product split over TABLE_LANES lanes.
int zk_fp_mul_lanes(const void* a, const void* b, void* out, long long n,
                    long long chain, void* stream) {
  if (n <= 0 || chain < 0 || (chain && n != 1)) return cudaErrorInvalidValue;
  constexpr int per = WARP / TABLE_LANES;   // pairs a warp
  const long long warps = (n + per - 1) / per;
  fp_mul_lanes_kernel<<<(unsigned)((warps * WARP + FP_THREADS - 1) /
                                   FP_THREADS),
                        FP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(a), static_cast<const u32*>(b),
      static_cast<u32*>(out), n, chain);
  return cudaGetLastError();
}

}  // extern "C"
