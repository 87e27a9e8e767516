// Sumcheck round kernels for Hopper (sm_90a), plain C ABI for ctypes.
//
// What each kernel replaces (zkcnn_tpu, the JAX/Pallas reference):
//   * round_kernel<true>  (zk_round_step): one quadratic sumcheck round,
//     zkcnn_tpu/field/pallas_round2.py::_round2_kernel (entry
//     round_step2, XLA epilogue _finish_dots2) and its canonical-limb
//     twin zkcnn_tpu/field/pallas_round.py::_round_kernel (entry
//     round_step).  Outputs the four pair dots
//       D_xy = sum_i mont(A[2i+x], V[2i+y])   (x, y in {0, 1})
//     and both folds X'_i = X[2i] + r (X[2i+1] - X[2i]).
//   * round_kernel<false> (zk_fold): the same kernel with the dots
//     compiled out -- the fold alone, for every other fold on the CUDA
//     path (MLE evaluation, the beta table of the cubic phase).
//   * cubic_kernel (zk_cubic_round_step): one DOT_PROD phase-1 round,
//     zkcnn_tpu/field/pallas_round.py::_cubic_kernel (entry
//     cubic_round_step, epilogue _blocks_to_mont).  Per pair i, with
//     a/da from V1, b/db from V0 and m0/dm from m-pair (i mod M/2):
//       e0 = a b, e1 = da b + a db, e2 = da db,
//       c0 += m0 e0, c1 += dm e0 + m0 e1, c2 += dm e1 + m0 e2,
//       c3 += dm e2,
//     and the folds of V0 and V1.
//
// Data: a field element is 8 little-endian 32-bit words of its
// canonical Montgomery residue (R = 2^256), one 32-byte row.  Every
// output is canonical, so it equals the JAX package bit for bit.
//
// What bounds it on this card: 32-bit integer multiplies, not bytes.
// One CIOS Montgomery product is 128 32x32->64-bit multiplies (8x8 for
// a*b, 8x8 for the reduction) plus their carry adds.  A quadratic pair
// reads 128 bytes, writes 64 and runs 6 products; a cubic pair reads
// 128 (the m pair mostly hits L2), writes 64 and runs 12; a fold pair
// reads 64, writes 32 and runs 1.  Measured on an NVIDIA H100 80GB HBM3
// at a 700 W power limit, 2^24 rows: round_step 2.07 ms = 2.4e10
// products/s and 779 GB/s (23% of the 3.35 TB/s HBM peak); cubic 4.27
// ms, 2.4e10 products/s, 378 GB/s; the fold alone 0.32 ms at 2527 GB/s
// (75% of peak).  So the two round kernels are bound by integer
// arithmetic and the fold alone by bytes.
// The design keeps the multiplies as few as the math allows: one pass
// that shares the loads and the differences between dots and folds,
// per-thread modular accumulators (no reduction until the end), and a
// two-launch reduction (warp shuffles, shared memory, then one block
// over the per-block partials) that touches only 128 bytes per block.
// Lazy reduction and tensor-core products are later work.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

constexpr int NW = 8;          // words per field element
constexpr int THREADS = 256;   // threads per block (8 warps)
constexpr int NVAL = 4;        // dot / coefficient outputs per round

// BLS12-381 Fr modulus, little-endian 32-bit words, and -p^-1 mod 2^32.
__constant__ u32 P[NW] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                          0x53bda402u, 0x09a1d805u, 0x3339d808u,
                          0x299d7d48u, 0x73eda753u};
constexpr u32 PINV = 0xffffffffu;

struct Fe {
  u32 w[NW];
};

__device__ __forceinline__ void load(u32 x[NW], const u32* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = s[0], b = s[1];
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

// acc += x (mod p)
__device__ __forceinline__ void acc_add(u32 acc[NW], const u32 x[NW]) {
  add_mod(acc, acc, x);
}

// Sum NVAL field elements over the block; thread 0 writes them to out.
__device__ void block_reduce(u32 acc[NVAL][NW], u32* out) {
  __shared__ u32 sm[THREADS / 32][NVAL][NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int v = 0; v < NVAL; ++v) {
      u32 o[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k)
        o[k] = __shfl_xor_sync(0xffffffffu, acc[v][k], off);
      acc_add(acc[v], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < NVAL; ++v)
#pragma unroll
      for (int k = 0; k < NW; ++k) sm[warp][v][k] = acc[v][k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int v = 0; v < NVAL; ++v) {
      if (lane < THREADS / 32) {
#pragma unroll
        for (int k = 0; k < NW; ++k) acc[v][k] = sm[lane][v][k];
      } else {
        set_zero(acc[v]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int v = 0; v < NVAL; ++v) {
        u32 o[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k)
          o[k] = __shfl_xor_sync(0xffffffffu, acc[v][k], off);
        acc_add(acc[v], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int v = 0; v < NVAL; ++v) store(out + v * NW, acc[v]);
    }
  }
}

// Quadratic round (DOTS) or fold only (!DOTS): grid-stride over pairs.
// The fold-only variant folds A alone (V, V2 and partials are unused).
template <bool DOTS>
__global__ void __launch_bounds__(THREADS)
round_kernel(const u32* __restrict__ A, const u32* __restrict__ V,
             u32* __restrict__ A2, u32* __restrict__ V2,
             u32* __restrict__ partials, long long npairs, Fe r) {
  u32 acc[NVAL][NW];
  if (DOTS) {
#pragma unroll
    for (int v = 0; v < NVAL; ++v) set_zero(acc[v]);
  }
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < npairs; i += (long long)gridDim.x * THREADS) {
    u32 a0[NW], a1[NW], d[NW], t[NW];
    load(a0, A + (2 * i) * NW);
    load(a1, A + (2 * i + 1) * NW);
    sub_mod(d, a1, a0);
    mont_mul(t, d, r.w);
    add_mod(t, t, a0);
    store(A2 + i * NW, t);
    if (DOTS) {
      u32 v0[NW], v1[NW];
      load(v0, V + (2 * i) * NW);
      load(v1, V + (2 * i + 1) * NW);
      mont_mul(t, a0, v0); acc_add(acc[0], t);
      mont_mul(t, a0, v1); acc_add(acc[1], t);
      mont_mul(t, a1, v0); acc_add(acc[2], t);
      mont_mul(t, a1, v1); acc_add(acc[3], t);
      sub_mod(d, v1, v0);
      mont_mul(t, d, r.w);
      add_mod(t, t, v0);
      store(V2 + i * NW, t);
    }
  }
  if (DOTS) block_reduce(acc, partials + blockIdx.x * (NVAL * NW));
}

// DOT_PROD phase-1 round: coefficient partials and the folds of V0, V1.
__global__ void __launch_bounds__(THREADS)
cubic_kernel(const u32* __restrict__ M, const u32* __restrict__ V0,
             const u32* __restrict__ V1, u32* __restrict__ V0o,
             u32* __restrict__ V1o, u32* __restrict__ partials,
             long long npairs, long long half_m, Fe r) {
  u32 acc[NVAL][NW];
#pragma unroll
  for (int v = 0; v < NVAL; ++v) set_zero(acc[v]);
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < npairs; i += (long long)gridDim.x * THREADS) {
    const long long j = i % half_m;
    u32 a[NW], da[NW], b[NW], db[NW], m0[NW], dm[NW], x[NW], y[NW];
    load(a, V1 + (2 * i) * NW);
    load(x, V1 + (2 * i + 1) * NW);
    sub_mod(da, x, a);
    load(b, V0 + (2 * i) * NW);
    load(x, V0 + (2 * i + 1) * NW);
    sub_mod(db, x, b);
    load(m0, M + (2 * j) * NW);
    load(x, M + (2 * j + 1) * NW);
    sub_mod(dm, x, m0);
    // folds: V1' = a + r da, V0' = b + r db
    mont_mul(x, da, r.w); add_mod(x, x, a); store(V1o + i * NW, x);
    mont_mul(x, db, r.w); add_mod(x, x, b); store(V0o + i * NW, x);
    u32 e[NW];
    mont_mul(e, a, b);                       // e0
    mont_mul(x, m0, e); acc_add(acc[0], x);
    mont_mul(x, dm, e); acc_add(acc[1], x);
    mont_mul(e, da, b);
    mont_mul(y, a, db);
    add_mod(e, e, y);                        // e1
    mont_mul(x, m0, e); acc_add(acc[1], x);
    mont_mul(x, dm, e); acc_add(acc[2], x);
    mont_mul(e, da, db);                     // e2
    mont_mul(x, m0, e); acc_add(acc[2], x);
    mont_mul(x, dm, e); acc_add(acc[3], x);
  }
  block_reduce(acc, partials + blockIdx.x * (NVAL * NW));
}

// Second launch: one block sums the per-block partials [nblocks, 4, 8].
__global__ void __launch_bounds__(THREADS)
reduce_partials(const u32* __restrict__ partials, u32* __restrict__ out,
                int nblocks) {
  u32 acc[NVAL][NW];
#pragma unroll
  for (int v = 0; v < NVAL; ++v) set_zero(acc[v]);
  for (int b = threadIdx.x; b < nblocks; b += THREADS) {
#pragma unroll
    for (int v = 0; v < NVAL; ++v) {
      u32 x[NW];
      load(x, partials + (b * NVAL + v) * NW);
      acc_add(acc[v], x);
    }
  }
  block_reduce(acc, out);
}

Fe to_fe(const u32* r8) {
  Fe r;
  for (int k = 0; k < NW; ++k) r.w[k] = r8[k];
  return r;
}

}  // namespace

extern "C" {

int zk_threads() { return THREADS; }

const char* zk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A, V: [2*npairs, 8]; A2, V2: [npairs, 8]; partials: [nblocks, 4, 8];
// dots: [4, 8].  r8: the Montgomery challenge, 8 words on the host.
int zk_round_step(const void* A, const void* V, void* A2, void* V2,
                  void* partials, void* dots, long long npairs, int nblocks,
                  const u32* r8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  round_kernel<true><<<nblocks, THREADS, 0, s>>>(
      static_cast<const u32*>(A), static_cast<const u32*>(V),
      static_cast<u32*>(A2), static_cast<u32*>(V2),
      static_cast<u32*>(partials), npairs, to_fe(r8));
  int err = cudaGetLastError();
  if (err) return err;
  reduce_partials<<<1, THREADS, 0, s>>>(static_cast<const u32*>(partials),
                                        static_cast<u32*>(dots), nblocks);
  return cudaGetLastError();
}

// X: [2*npairs, 8] -> X2: [npairs, 8].
int zk_fold(const void* X, void* X2, long long npairs, int nblocks,
            const u32* r8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  round_kernel<false><<<nblocks, THREADS, 0, s>>>(
      static_cast<const u32*>(X), nullptr, static_cast<u32*>(X2), nullptr,
      nullptr, npairs, to_fe(r8));
  return cudaGetLastError();
}

// m: [2*half_m, 8]; V0, V1: [2*npairs, 8]; V0o, V1o: [npairs, 8];
// partials: [nblocks, 4, 8]; coeffs: [4, 8].
int zk_cubic_round_step(const void* m, const void* V0, const void* V1,
                        void* V0o, void* V1o, void* partials, void* coeffs,
                        long long npairs, long long half_m, int nblocks,
                        const u32* r8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cubic_kernel<<<nblocks, THREADS, 0, s>>>(
      static_cast<const u32*>(m), static_cast<const u32*>(V0),
      static_cast<const u32*>(V1), static_cast<u32*>(V0o),
      static_cast<u32*>(V1o), static_cast<u32*>(partials), npairs, half_m,
      to_fe(r8));
  int err = cudaGetLastError();
  if (err) return err;
  reduce_partials<<<1, THREADS, 0, s>>>(static_cast<const u32*>(partials),
                                        static_cast<u32*>(coeffs), nblocks);
  return cudaGetLastError();
}

}  // extern "C"
