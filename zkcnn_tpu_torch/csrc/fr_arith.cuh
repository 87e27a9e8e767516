// BLS12-381 Fr on 8 little-endian 32-bit words (Montgomery, R = 2^256):
// the one Fr product of the port's CUDA sources and the sums around it.
//
// round_kernels.cu (the sumcheck rounds and the Fiat-Shamir tape of
// fs_tape.cuh) and g1_arith.cuh (the inner-product opening's scalars)
// include this file.  Plain C++ on integer arrays behind the same macros
// as g1_arith.cuh (ZK_DEV, ZK_DEV_NOINLINE, ZK_CONST, ZK_INLINE), so a
// host compiler builds the same arithmetic: define the first two empty and
// ZK_CONST as `static const` before including it (ZK_INLINE defaults to
// `inline` off nvcc).  Every output is a canonical residue.

#ifndef ZKCNN_FR_ARITH_CUH
#define ZKCNN_FR_ARITH_CUH

#include <cstdint>

#ifndef ZK_DEV
#define ZK_DEV __device__
#define ZK_DEV_NOINLINE __device__ __noinline__
#define ZK_CONST __constant__
#endif
#ifndef ZK_INLINE
#ifdef __CUDACC__
#define ZK_INLINE __device__ __forceinline__
#else
#define ZK_INLINE inline
#endif
#endif

namespace fr {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NW = 8;              // words per field element

// The Fr modulus p; R^2, R^3 and R mod p (R mod p is one in Montgomery
// form); -p^-1 mod 2^32.
ZK_CONST u32 P[NW] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                      0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
ZK_CONST u32 R2[NW] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                       0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
ZK_CONST u32 R3[NW] = {0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u,
                       0xc7b5f418u, 0x73d13c71u, 0xc8db33e9u, 0x6e2a5bb9u};
ZK_CONST u32 ONE[NW] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                        0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
constexpr u32 PINV = 0xffffffffu;

ZK_INLINE void set_zero(u32* x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) x[k] = 0;
}

ZK_INLINE void copy(u32* r, const u32* x) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r[k] = x[k];
}

// r = t - p if t >= p else t, for t < 2p (t has a 9th word t8).
ZK_INLINE void cond_sub(u32* r, const u32* t, u32 t8) {
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

ZK_INLINE void add_mod(u32* r, const u32* a, const u32* b) {
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

ZK_INLINE void sub_mod(u32* r, const u32* a, const u32* b) {
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

// CIOS Montgomery product r = a b R^-1 mod p, canonical, for a < 2^256
// and b < p; r may alias a or b.
ZK_INLINE void fr_mul(u32* r, const u32* a, const u32* b) {
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

// k R^-1 mod p, in place: a Montgomery word string out of Montgomery form.
ZK_INLINE void fr_from_mont(u32* k) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const u32 m = k[0] * PINV;
    u64 c = ((u64)m * P[0] + k[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      u64 s = (u64)m * P[j] + k[j] + c;
      k[j - 1] = (u32)s;
      c = s >> 32;
    }
    k[NW - 1] = (u32)c;
  }
  cond_sub(k, k, 0);           // the value is at most p: make it canonical
}

// x + r (y - x): the fold of the pair (x, y) at r.
ZK_INLINE void fold_at(u32* out, const u32* x, const u32* y, const u32* r) {
  u32 d[NW];
  sub_mod(d, y, x);
  fr_mul(d, d, r);
  add_mod(out, d, x);
}

}  // namespace fr

#endif  // ZKCNN_FR_ARITH_CUH
