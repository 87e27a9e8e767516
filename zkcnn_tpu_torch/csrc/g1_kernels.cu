// BLS12-381 G1 kernels for Hopper (sm_90a), plain C ABI for ctypes.
//
// The Hyrax commitment's curve arithmetic.  The JAX package has no Pallas
// kernel here: its curve programs are XLA programs that fuse a whole
// formula.  Plain PyTorch cannot stand in for them on the card (one Fp
// product is a few hundred small launches, one scalar multiplication about
// 255 x 24 products), so each program is one kernel:
//   * g1_add_kernel (zk_g1_add): zkcnn_tpu/pcs/curve.py::padd and, with no
//     second operand, ::pdouble, elementwise over n points;
//   * g1_scalar_mul_kernel (zk_g1_scalar_mul): curve.py::scalar_mul, one
//     point (or one shared point) and one plain scalar (or one shared
//     scalar) a thread.  The thread keeps its accumulator and a table of
//     15 multiples over all steps (4-bit windows), where the XLA program
//     runs a 255-step loop of whole-batch programs;
//   * g1_msm_kernel + g1_sum_rows_kernel (zk_g1_msm):
//     zkcnn_tpu/pcs/msm.py::FixedBaseMSM.compute and ipa.py::_msm_small.
//     For each of R rows, sum_i k[r, i] P_i with Montgomery scalars in.  A
//     thread takes one term (scalar out of Montgomery form, the same
//     windowed loop in registers and local memory), a block of
//     MSM_THREADS sums its terms by a tree in shared memory, and a second
//     launch sums a row's block sums.  The XLA design (a table of digit
//     multiples, a gather of [R, 2N] points a window and a dense tree)
//     exists because XLA is dense; none of it is carried over, and no
//     gathered tensor is made.
//
// Data: a point is [3, 12] words (X, Y, Z), each coordinate the canonical
// Montgomery residue (R = 2^384) in 12 little-endian 32-bit words; Z == 0
// is infinity.  A scalar is 8 words.  Results are group elements: they
// equal the plain PyTorch versions and the JAX package as points (after
// normalising Z), not word for word, because the order of additions
// differs.
//
// What bounds it on this card: 32-bit integer multiplies.  An Fp product
// is 288 of them (144 for the product, 144 for its reduction), a doubling
// 7 products, an addition 16, a 255-bit scalar about 2,900 products,
// against 144 bytes a point and 32 a scalar.  For few terms (an
// opening's single rows) the bound is one thread's chain of 255
// dependent doublings, not throughput.  This is a simple form: a term a
// thread with fixed 4-bit windows.  Pippenger buckets across a row's
// terms, signed digits, the GLV endomorphism and mixed addition for
// Z = 1 bases are left for later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "g1_arith.cuh"

namespace {

using namespace g1;

constexpr int ADD_THREADS = 128;   // a block of g1_add_kernel
constexpr int MUL_THREADS = 64;    // a block of g1_scalar_mul_kernel
constexpr int MSM_THREADS = 64;    // terms of one block of g1_msm_kernel

__device__ __forceinline__ void load_pt(Pt* p, const u32* src) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    p->x[k] = src[k];
    p->y[k] = src[NP + k];
    p->z[k] = src[2 * NP + k];
  }
}

__device__ __forceinline__ void store_pt(u32* dst, const Pt* p) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    dst[k] = p->x[k];
    dst[NP + k] = p->y[k];
    dst[2 * NP + k] = p->z[k];
  }
}

// out[i] = p[i] + q[i], or 2 p[i] where q is null.
__global__ void g1_add_kernel(const u32* __restrict__ p,
                              const u32* __restrict__ q,
                              u32* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt a, b;
  load_pt(&a, p + i * PW);
  if (q) {
    load_pt(&b, q + i * PW);
    pt_add(&a, &a, &b);
  } else {
    pt_double(&a, &a);
  }
  store_pt(out + i * PW, &a);
}

// out[i] = k[i] p[i] over the low nbits bits of the plain scalar k[i]; a
// stride of 0 shares one point or one scalar among all threads.
__global__ void g1_scalar_mul_kernel(const u32* __restrict__ pts,
                                     long long pt_stride,
                                     const u32* __restrict__ ks,
                                     long long k_stride,
                                     u32* __restrict__ out, long long n,
                                     int nbits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, acc;
  u32 k[NR];
  load_pt(&p, pts + i * pt_stride);
#pragma unroll
  for (int j = 0; j < NR; ++j) k[j] = ks[i * k_stride + j];
  pt_scalar_mul(&acc, &p, k, nbits);
  store_pt(out + i * PW, &acc);
}

// The points of a block summed by a tree in shared memory; the sum ends
// in sh[0].  Every thread of the block calls it.
__device__ __forceinline__ void block_sum(Pt* sh) {
  __syncthreads();
  for (int s = MSM_THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      pt_add(&sh[threadIdx.x], &sh[threadIdx.x], &sh[threadIdx.x + s]);
    __syncthreads();
  }
}

// Block (r, b) sums the terms b * MSM_THREADS .. of row r: one term a
// thread.  ks: [R, N, 8] Montgomery scalars; pts: [N, 3, 12]; out:
// [R, blocks_per_row, 3, 12].
__global__ void g1_msm_kernel(const u32* __restrict__ pts,
                              const u32* __restrict__ ks,
                              u32* __restrict__ out, long long N,
                              int blocks_per_row) {
  __shared__ Pt sh[MSM_THREADS];
  const long long r = blockIdx.x / blocks_per_row;
  const int b = blockIdx.x % blocks_per_row;
  const long long i = (long long)b * MSM_THREADS + threadIdx.x;
  Pt acc;
  if (i < N) {
    Pt p;
    u32 k[NR];
    load_pt(&p, pts + i * PW);
#pragma unroll
    for (int j = 0; j < NR; ++j) k[j] = ks[(r * N + i) * NR + j];
    fr_from_mont(k);
    pt_scalar_mul(&acc, &p, k, 32 * NR);
  } else {
    pt_set_inf(&acc);
  }
  pt_copy(&sh[threadIdx.x], &acc);
  block_sum(sh);
  if (threadIdx.x == 0) store_pt(out + (size_t)blockIdx.x * PW, &sh[0]);
}

// Block r sums the `parts` points of row r: parts [R, parts, 3, 12] ->
// out [R, 3, 12].
__global__ void g1_sum_rows_kernel(const u32* __restrict__ parts,
                                   u32* __restrict__ out, int n_parts) {
  __shared__ Pt sh[MSM_THREADS];
  const u32* row = parts + (size_t)blockIdx.x * n_parts * PW;
  Pt acc, t;
  pt_set_inf(&acc);
  for (int j = threadIdx.x; j < n_parts; j += MSM_THREADS) {
    load_pt(&t, row + (size_t)j * PW);
    pt_add(&acc, &acc, &t);
  }
  pt_copy(&sh[threadIdx.x], &acc);
  block_sum(sh);
  if (threadIdx.x == 0) store_pt(out + (size_t)blockIdx.x * PW, &sh[0]);
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
// plain scalars.  pt_stride: 36 for [n, 3, 12] points, 0 for one shared
// point; k_stride: 8 for [n, 8] scalars, 0 for one shared scalar.
int zk_g1_scalar_mul(const void* pts, long long pt_stride, const void* ks,
                     long long k_stride, void* out, long long n, int nbits,
                     void* stream) {
  if (n <= 0) return 0;
  if (nbits < 1 || nbits > 32 * NR) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + MUL_THREADS - 1) / MUL_THREADS);
  g1_scalar_mul_kernel<<<blocks, MUL_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u32*>(pts), pt_stride, static_cast<const u32*>(ks),
      k_stride, static_cast<u32*>(out), n, nbits);
  return cudaGetLastError();
}

// The block sums a row of N terms is cut into; with 1 the sums of
// g1_msm_kernel are the result and `parts` is not needed.
long long zk_g1_msm_parts(long long N) {
  return (N + MSM_THREADS - 1) / MSM_THREADS;
}

// out[r] = sum_i ks[r, i] pts[i].  pts: [N, 3, 12]; ks: [R, N, 8]
// Montgomery scalars; out: [R, 3, 12]; parts: [R, zk_g1_msm_parts(N), 3,
// 12] scratch, or null where that count is 1.  *launches: the kernels
// launched.
int zk_g1_msm(const void* pts, const void* ks, void* out, void* parts,
              long long R, long long N, void* stream, int* launches) {
  *launches = 0;
  if (R <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_row = zk_g1_msm_parts(N);
  if (R * per_row > 0x7fffffffLL) return cudaErrorInvalidValue;
  u32* first = static_cast<u32*>(per_row == 1 ? out : parts);
  if (!first) return cudaErrorInvalidValue;
  g1_msm_kernel<<<(unsigned)(R * per_row), MSM_THREADS, 0, s>>>(
      static_cast<const u32*>(pts), static_cast<const u32*>(ks), first, N,
      (int)per_row);
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

}  // extern "C"
