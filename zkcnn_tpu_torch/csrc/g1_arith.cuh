// BLS12-381 G1 arithmetic for one thread: Fp on 12 little-endian 32-bit
// words (Montgomery, R = 2^384), Jacobian points, windowed scalar
// multiplication.
//
// Device functions only, no kernel: g1_kernels.cu includes this file.
// Every function is plain C++ on integer arrays behind the ZK_DEV,
// ZK_DEV_NOINLINE and ZK_CONST macros, so a host compiler can build the
// same arithmetic (define the first two empty and ZK_CONST as
// `static const`) and hold it against Python integers where there is no
// nvcc; tests/test_torch_pcs_field.py does.
//
// The point formulas are those of zkcnn_tpu/pcs/curve.py (pdouble, padd
// with its four edge cases), on canonical residues, so an addition or a
// doubling gives the JAX package's coordinates word for word; the scalar
// loop takes windows where the JAX package goes bit by bit, so its
// results are equal as points.
//
// The Fp product and the two point formulas are NOT inlined: a fully
// unrolled 12-word CIOS product is about 300 wide multiply-adds, a
// point addition runs 16 of them and the scalar loop calls the doubling
// 255 times and the addition about 80 times.  As calls they compile in seconds and
// keep the register count low; the operands of a call live in local
// memory (L1), which costs 36 word accesses beside 288 multiplies.

#ifndef ZKCNN_G1_ARITH_CUH
#define ZKCNN_G1_ARITH_CUH

#include <cstdint>

#ifndef ZK_DEV
#define ZK_DEV __device__
#define ZK_DEV_NOINLINE __device__ __noinline__
#define ZK_CONST __constant__
#endif

namespace g1 {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int NP = 12;   // words of an Fp element
constexpr int NR = 8;    // words of an Fr scalar
constexpr int PW = 3 * NP;  // words of a point (X, Y, Z)

// The Fp modulus and -p^-1 mod 2^32; the Fr modulus and its inverse
// likewise (for taking a scalar out of Montgomery form, R = 2^256).
ZK_CONST u32 FP_MOD[NP] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
constexpr u32 FP_INV = 0xfffcfffdu;
ZK_CONST u32 FR_MOD[NR] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                           0x53bda402u, 0x09a1d805u, 0x3339d808u,
                           0x299d7d48u, 0x73eda753u};
constexpr u32 FR_INV = 0xffffffffu;

struct Pt {
  u32 x[NP], y[NP], z[NP];   // Z == 0: the point at infinity
};

ZK_DEV inline void fp_copy(u32* r, const u32* a) {
#pragma unroll
  for (int k = 0; k < NP; ++k) r[k] = a[k];
}

ZK_DEV inline bool fp_is_zero(const u32* a) {
  u32 v = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) v |= a[k];
  return v == 0;
}

// r = t - p if t >= p else t, for t < 2p < 2^384.
ZK_DEV inline void fp_cond_sub(u32* r, const u32* t) {
  u32 d[NP];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)t[k] - FP_MOD[k] - borrow;
    d[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) r[k] = borrow ? t[k] : d[k];
}

// r may be a or b in every function below.
ZK_DEV inline void fp_add(u32* r, const u32* a, const u32* b) {
  u32 t[NP];
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)a[k] + b[k] + c;
    t[k] = (u32)s;
    c = s >> 32;
  }
  fp_cond_sub(r, t);   // a + b < 2p < 2^384: no carry out
}

ZK_DEV inline void fp_sub(u32* r, const u32* a, const u32* b) {
  u32 t[NP];
  u64 borrow = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)a[k] - b[k] - borrow;
    t[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  const u32 mask = borrow ? 0xffffffffu : 0u;   // a < b: add p back
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)t[k] + (FP_MOD[k] & mask) + c;
    r[k] = (u32)s;
    c = s >> 32;
  }
}

// CIOS Montgomery product r = a b R^-1 mod p, canonical.
ZK_DEV_NOINLINE void fp_mul(u32* r, const u32* a, const u32* b) {
  u32 t[NP + 2];
#pragma unroll
  for (int k = 0; k < NP + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const u32 bi = b[i];
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      u64 s = (u64)a[j] * bi + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 s = (u64)t[NP] + c;
    t[NP] = (u32)s;
    t[NP + 1] = (u32)(s >> 32);
    const u32 m = t[0] * FP_INV;
    s = (u64)m * FP_MOD[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NP; ++j) {
      s = (u64)m * FP_MOD[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = (u64)t[NP] + c;
    t[NP - 1] = (u32)s;
    t[NP] = t[NP + 1] + (u32)(s >> 32);
  }
  fp_cond_sub(r, t);   // t < 2p, so t[NP] is 0
}

ZK_DEV inline void pt_copy(Pt* r, const Pt* p) {
  fp_copy(r->x, p->x);
  fp_copy(r->y, p->y);
  fp_copy(r->z, p->z);
}

ZK_DEV inline void pt_set_inf(Pt* r) {
#pragma unroll
  for (int k = 0; k < NP; ++k) r->x[k] = r->y[k] = r->z[k] = 0;
}

// Jacobian doubling on y^2 = x^3 + 4 (a = 0); 2 inf = inf because
// Z3 = 2 Y Z.  r may be p.
ZK_DEV_NOINLINE void pt_double(Pt* r, const Pt* p) {
  u32 A[NP], B[NP], C[NP], D[NP], E[NP], F[NP], t[NP], Z3[NP];
  fp_mul(Z3, p->y, p->z);
  fp_add(Z3, Z3, Z3);
  fp_mul(A, p->x, p->x);
  fp_mul(B, p->y, p->y);
  fp_mul(C, B, B);
  fp_add(t, p->x, B);
  fp_mul(D, t, t);
  fp_sub(D, D, A);
  fp_sub(D, D, C);
  fp_add(D, D, D);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_mul(F, E, E);
  fp_add(t, D, D);
  fp_sub(r->x, F, t);          // X3 = F - 2D
  fp_add(C, C, C);
  fp_add(C, C, C);
  fp_add(C, C, C);             // 8C
  fp_sub(t, D, r->x);
  fp_mul(t, E, t);
  fp_sub(r->y, t, C);          // Y3 = E (D - X3) - 8C
  fp_copy(r->z, Z3);
}

// Jacobian addition, complete: p + inf, inf + q, p == q (doubling) and
// p == -q (canonical zeros).  r may be p or q.
ZK_DEV_NOINLINE void pt_add(Pt* r, const Pt* p, const Pt* q) {
  if (fp_is_zero(p->z)) {
    pt_copy(r, q);
    return;
  }
  if (fp_is_zero(q->z)) {
    pt_copy(r, p);
    return;
  }
  u32 Z1Z1[NP], Z2Z2[NP], U1[NP], U2[NP], S1[NP], S2[NP], H[NP], rr[NP];
  fp_mul(Z1Z1, p->z, p->z);
  fp_mul(Z2Z2, q->z, q->z);
  fp_mul(U1, p->x, Z2Z2);
  fp_mul(U2, q->x, Z1Z1);
  fp_mul(S1, p->y, q->z);
  fp_mul(S1, S1, Z2Z2);
  fp_mul(S2, q->y, p->z);
  fp_mul(S2, S2, Z1Z1);
  fp_sub(H, U2, U1);
  fp_sub(rr, S2, S1);
  if (fp_is_zero(H)) {
    if (fp_is_zero(rr))
      pt_double(r, p);
    else
      pt_set_inf(r);
    return;
  }
  u32* HH = Z1Z1;              // Z1Z1, Z2Z2, U2, S2 are dead from here
  u32* HHH = Z2Z2;
  u32* V = U2;
  u32* t = S2;
  fp_mul(HH, H, H);
  fp_mul(HHH, H, HH);
  fp_mul(V, U1, HH);
  fp_mul(t, p->z, q->z);
  fp_mul(r->z, t, H);          // Z3 = Z1 Z2 H (p->z, q->z not read again)
  fp_mul(t, rr, rr);
  fp_sub(t, t, HHH);
  fp_sub(t, t, V);
  fp_sub(r->x, t, V);          // X3 = r^2 - HHH - 2V
  fp_sub(t, V, r->x);
  fp_mul(t, rr, t);
  fp_mul(S1, S1, HHH);
  fp_sub(r->y, t, S1);         // Y3 = r (V - X3) - S1 HHH
}

// k R^-1 mod the Fr modulus, in place: a scalar out of Montgomery form.
ZK_DEV inline void fr_from_mont(u32* k) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const u32 m = k[0] * FR_INV;
    u64 c = ((u64)m * FR_MOD[0] + k[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NR; ++j) {
      u64 s = (u64)m * FR_MOD[j] + k[j] + c;
      k[j - 1] = (u32)s;
      c = s >> 32;
    }
    k[NR - 1] = (u32)c;
  }
  u32 d[NR];                   // the value is at most p: make it canonical
  u64 borrow = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    u64 s = (u64)k[j] - FR_MOD[j] - borrow;
    d[j] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  if (!borrow)
#pragma unroll
    for (int j = 0; j < NR; ++j) k[j] = d[j];
}

// acc = k p for the low nbits (1..256) bits of the plain scalar k, by
// fixed windows of WBITS bits, most significant first: a table of
// 1 p .. 15 p, then WBITS doublings and at most one addition a window
// (about 2,900 Fp products for 255 bits, where bit-serial double-and-add
// is about 5,900 once a warp runs both branches of every step).  The
// table and the accumulator stay with the thread over all steps.  acc
// must not be p.
constexpr int WBITS = 4;
constexpr int WTAB = (1 << WBITS) - 1;

ZK_DEV inline void pt_scalar_mul(Pt* acc, const Pt* p, const u32* k,
                                 int nbits) {
  pt_set_inf(acc);
  int top = nbits - 1;
  while (top >= 0 && !((k[top >> 5] >> (top & 31)) & 1)) --top;
  if (top < 0) return;                       // k = 0
  Pt tab[WTAB];                              // tab[d - 1] = d p
  pt_copy(&tab[0], p);
  for (int d = 2; d <= WTAB; ++d) {
    if (d & 1)
      pt_add(&tab[d - 1], &tab[d - 2], p);
    else
      pt_double(&tab[d - 1], &tab[d / 2 - 1]);
  }
  // 32 is a multiple of WBITS: a window lies within one word
  for (int lo = top / WBITS * WBITS; lo >= 0; lo -= WBITS) {
    for (int j = 0; j < WBITS; ++j) pt_double(acc, acc);
    u32 d = (k[lo >> 5] >> (lo & 31)) & WTAB;
    if (lo + WBITS > nbits) d &= (1u << (nbits - lo)) - 1;
    if (d) pt_add(acc, acc, &tab[d - 1]);
  }
}

}  // namespace g1

#endif  // ZKCNN_G1_ARITH_CUH
