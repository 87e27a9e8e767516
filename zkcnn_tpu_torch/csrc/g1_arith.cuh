// BLS12-381 G1 arithmetic for one thread: Fp on 12 little-endian 32-bit
// words (Montgomery, R = 2^384), Jacobian points, windowed scalar
// multiplication, and the fixed-base window table that an MSM sums from;
// and, at the end, the same table's doublings on groups of lanes of a
// warp (lane_mul, table_chain_lanes).
//
// Device functions only, no kernel: g1_kernels.cu includes this file.
// Every function is plain C++ on integer arrays behind the ZK_DEV,
// ZK_DEV_NOINLINE, ZK_INLINE and ZK_CONST macros, so a host compiler can
// build the same arithmetic (define the first two empty and ZK_CONST as
// `static const`; ZK_INLINE defaults to `inline` off nvcc) and hold it
// against Python integers where there is no nvcc;
// tests/test_torch_pcs_field.py, tests/test_torch_pcs_table.py and
// tests/test_torch_pcs_lanes.py do.
//
// The point formulas are those of zkcnn_tpu/pcs/curve.py (pdouble, padd
// with its four edge cases), on canonical residues, so an addition or a
// doubling gives the JAX package's coordinates word for word; the scalar
// loop takes windows where the JAX package goes bit by bit, so its
// results are equal as points.
//
// The Fp product is a CIOS Montgomery product on operands in registers.
// On the card (__CUDA_ARCH__) its carry chains are PTX mad.lo.cc /
// madc.hi.cc / addc.cc, which run on the multiply-add units' carry flag,
// and it is inlined (ZK_INLINE) into the point formulas; the host build
// keeps the portable loop on 64-bit intermediates, so g++ checks the same
// algorithm.  One product is 288 multiplies for the 12 x 12 words and
// their reduction; a thread's dependent products are bound by the latency
// of the carry chains (48 chains of 12-13 instructions that share the one
// carry flag, so nothing overlaps them), which chip_smoke.py measures.
// The point formulas stay calls (ZK_DEV_NOINLINE): inlined, a doubling is
// 7 products and an addition 16, and every caller would carry their code;
// as calls the kernels build in seconds and their operands (Pt) sit in
// local memory, 36 word accesses beside 288 multiplies a product.  The
// product and the formulas take the product's unrolling as a template
// parameter (default MUL_UNROLL), so a bench can time the header's own
// code in each form.
//
// The table (table_chain, table_step, table_build) holds, for a base P,
// T[j][d - 1] = d 2^(4j) P for windows j < nwin and digits d = 1..15, so
// that sum_i k_i P_i is the sum of T_i[j][digit_j(k_i)] over terms and
// windows (table_sum) with no doubling at all.  It costs 4 nwin - 1
// doublings a base (the chain, whose doublings are the entries d = 1, 2,
// 4, 8) and 11 additions a window (the other digits).
//
// The Fr product and sum (fr_mul, add_mod: fr_arith.cuh's, which the
// round kernels use too) serve kernel ipa_round, a round of the
// inner-product opening in one block: the fold of b and x and this
// thread's share of the two Q-column dots (ipa_fold_dots), a tree of
// modular sums over the block's threads (ipa_dot_step), then the round's
// weights and rows (ipa_rows, a term each: ipa_term).  Each takes the
// thread's index and the block's size, so a host compiler runs a block by
// looping over its threads between the steps.

#ifndef ZKCNN_G1_ARITH_CUH
#define ZKCNN_G1_ARITH_CUH

#include <cstdint>
#include <type_traits>

#include "fr_arith.cuh"     // the macros, and the Fr product

namespace g1 {

typedef uint32_t u32;
typedef uint64_t u64;

#ifdef __CUDA_ARCH__
// One PTX instruction each.  The carry flag passes from one asm statement
// to the next; `volatile` keeps their order, and nothing else the compiler
// emits between them touches the flag.
namespace ptx {
#define ZK_PTX2(name, op)                                                  \
  __device__ __forceinline__ u32 name(u32 a, u32 b) {                      \
    u32 r;                                                                 \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                              \
  }
#define ZK_PTX3(name, op)                                                  \
  __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {               \
    u32 r;                                                                 \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
ZK_PTX2(add_cc, "add.cc.u32")
ZK_PTX2(addc_cc, "addc.cc.u32")
ZK_PTX2(addc, "addc.u32")
ZK_PTX2(sub_cc, "sub.cc.u32")
ZK_PTX2(subc_cc, "subc.cc.u32")
ZK_PTX2(subc, "subc.u32")
ZK_PTX3(mad_lo_cc, "mad.lo.cc.u32")
ZK_PTX3(madc_lo_cc, "madc.lo.cc.u32")
ZK_PTX3(mad_hi_cc, "mad.hi.cc.u32")
ZK_PTX3(madc_hi_cc, "madc.hi.cc.u32")
ZK_PTX3(madc_hi, "madc.hi.u32")
#undef ZK_PTX2
#undef ZK_PTX3
}  // namespace ptx
#endif

constexpr int NP = 12;   // words of an Fp element
constexpr int NR = 8;    // words of an Fr scalar
constexpr int PW = 3 * NP;  // words of a point (X, Y, Z)

// The Fp modulus and -p^-1 mod 2^32.
ZK_CONST u32 FP_MOD[NP] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
    0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
    0x397fe69au, 0x1a0111eau};
constexpr u32 FP_INV = 0xfffcfffdu;

// Fr (R = 2^256): a scalar out of Montgomery form, and the product of the
// inner-product opening's scalars; both are fr_arith.cuh's, the round
// kernels' own.
using fr::add_mod;
using fr::fr_from_mont;
using fr::fr_mul;

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
ZK_INLINE void fp_cond_sub(u32* r, const u32* t) {
  u32 d[NP];
#ifdef __CUDA_ARCH__
  d[0] = ptx::sub_cc(t[0], FP_MOD[0]);
#pragma unroll
  for (int k = 1; k < NP; ++k) d[k] = ptx::subc_cc(t[k], FP_MOD[k]);
  const bool borrow = ptx::subc(0, 0) != 0;
#else
  u64 borrow = 0;
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)t[k] - FP_MOD[k] - borrow;
    d[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
#endif
#pragma unroll
  for (int k = 0; k < NP; ++k) r[k] = borrow ? t[k] : d[k];
}

// r may be a or b in every function below.
ZK_INLINE void fp_add(u32* r, const u32* a, const u32* b) {
  u32 t[NP];
#ifdef __CUDA_ARCH__
  t[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < NP; ++k) t[k] = ptx::addc_cc(a[k], b[k]);
#else
  u64 c = 0;
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)a[k] + b[k] + c;
    t[k] = (u32)s;
    c = s >> 32;
  }
#endif
  fp_cond_sub(r, t);   // a + b < 2p < 2^384: no carry out
}

ZK_INLINE void fp_sub(u32* r, const u32* a, const u32* b) {
  u32 t[NP];
#ifdef __CUDA_ARCH__
  t[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < NP; ++k) t[k] = ptx::subc_cc(a[k], b[k]);
  const u32 mask = ptx::subc(0, 0);            // a < b: add p back
  r[0] = ptx::add_cc(t[0], FP_MOD[0] & mask);
#pragma unroll
  for (int k = 1; k < NP; ++k) r[k] = ptx::addc_cc(t[k], FP_MOD[k] & mask);
#else
  u64 borrow = 0;
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)a[k] - b[k] - borrow;
    t[k] = (u32)s;
    borrow = (s >> 32) & 1;
  }
  const u32 mask = borrow ? 0xffffffffu : 0u;   // a < b: add p back
  u64 c = 0;
  for (int k = 0; k < NP; ++k) {
    u64 s = (u64)t[k] + (FP_MOD[k] & mask) + c;
    r[k] = (u32)s;
    c = s >> 32;
  }
#endif
}

// CIOS Montgomery product r = a b R^-1 mod p, canonical.  Word i of b
// adds a b_i into t (the low halves of the 12 word products in one carry
// chain, the high halves one word up in a second), then m p with
// m = t_0 (-p^-1) mod 2^32 (two more chains), and shifts t down a word.
// t < 2p before a step and < 2^415 within it, so 13 words hold it and no
// chain carries out of its last word.  On the card the steps run
// MUL_UNROLL at a time in a loop that is not unrolled, the words of b
// shifted down through registers: fully unrolled, a product is about 650
// instructions, and the point formulas that inline 7 and 16 of them
// outgrow the instruction cache.  U (a divisor of 12) is the steps a pass
// of that loop; the kernels take MUL_UNROLL, and
// tools/h100_fp_mul_bench.cu times the product and the formulas at each U.
constexpr int MUL_UNROLL = 2;

template <int U = MUL_UNROLL>
ZK_INLINE void fp_mul(u32* r, const u32* a, const u32* b) {
  static_assert(U >= 1 && NP % U == 0, "U must divide NP");
#ifdef __CUDA_ARCH__
  u32 t[NP + 1], bw[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    t[k] = 0;
    bw[k] = b[k];
  }
  t[NP] = 0;
#pragma unroll 1
  for (int i = 0; i < NP; i += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const u32 bi = bw[u];
      t[0] = ptx::mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < NP; ++j) t[j] = ptx::madc_lo_cc(a[j], bi, t[j]);
      t[NP] = ptx::addc(t[NP], 0);
      t[1] = ptx::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < NP - 1; ++j)
        t[j + 1] = ptx::madc_hi_cc(a[j], bi, t[j + 1]);
      t[NP] = ptx::madc_hi(a[NP - 1], bi, t[NP]);
      const u32 m = t[0] * FP_INV;
      t[0] = ptx::mad_lo_cc(m, FP_MOD[0], t[0]);   // 0, and a carry
#pragma unroll
      for (int j = 1; j < NP; ++j)
        t[j] = ptx::madc_lo_cc(m, FP_MOD[j], t[j]);
      t[NP] = ptx::addc(t[NP], 0);
      t[1] = ptx::mad_hi_cc(m, FP_MOD[0], t[1]);
#pragma unroll
      for (int j = 1; j < NP - 1; ++j)
        t[j + 1] = ptx::madc_hi_cc(m, FP_MOD[j], t[j + 1]);
      t[NP] = ptx::madc_hi(m, FP_MOD[NP - 1], t[NP]);
#pragma unroll
      for (int k = 0; k < NP; ++k) t[k] = t[k + 1];
      t[NP] = 0;
    }
#pragma unroll
    for (int k = 0; k < NP - U; ++k) bw[k] = bw[k + U];
  }
  fp_cond_sub(r, t);
#else
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
#endif
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

// A point in memory is 36 words: X, Y, Z.
ZK_DEV inline void pt_load(Pt* p, const u32* src) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    p->x[k] = src[k];
    p->y[k] = src[NP + k];
    p->z[k] = src[2 * NP + k];
  }
}

ZK_DEV inline void pt_store(u32* dst, const Pt* p) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    dst[k] = p->x[k];
    dst[NP + k] = p->y[k];
    dst[2 * NP + k] = p->z[k];
  }
}

// Jacobian doubling on y^2 = x^3 + 4 (a = 0); 2 inf = inf because
// Z3 = 2 Y Z.  r may be p.  U: the product's form (fp_mul).
template <int U = MUL_UNROLL>
ZK_DEV_NOINLINE void pt_double(Pt* r, const Pt* p) {
  u32 A[NP], B[NP], C[NP], D[NP], E[NP], F[NP], t[NP], Z3[NP];
  fp_mul<U>(Z3, p->y, p->z);
  fp_add(Z3, Z3, Z3);
  fp_mul<U>(A, p->x, p->x);
  fp_mul<U>(B, p->y, p->y);
  fp_mul<U>(C, B, B);
  fp_add(t, p->x, B);
  fp_mul<U>(D, t, t);
  fp_sub(D, D, A);
  fp_sub(D, D, C);
  fp_add(D, D, D);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_mul<U>(F, E, E);
  fp_add(t, D, D);
  fp_sub(r->x, F, t);          // X3 = F - 2D
  fp_add(C, C, C);
  fp_add(C, C, C);
  fp_add(C, C, C);             // 8C
  fp_sub(t, D, r->x);
  fp_mul<U>(t, E, t);
  fp_sub(r->y, t, C);          // Y3 = E (D - X3) - 8C
  fp_copy(r->z, Z3);
}

// Jacobian addition, complete: p + inf, inf + q, p == q (doubling) and
// p == -q (canonical zeros).  r may be p or q.
template <int U = MUL_UNROLL>
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
  fp_mul<U>(Z1Z1, p->z, p->z);
  fp_mul<U>(Z2Z2, q->z, q->z);
  fp_mul<U>(U1, p->x, Z2Z2);
  fp_mul<U>(U2, q->x, Z1Z1);
  fp_mul<U>(S1, p->y, q->z);
  fp_mul<U>(S1, S1, Z2Z2);
  fp_mul<U>(S2, q->y, p->z);
  fp_mul<U>(S2, S2, Z1Z1);
  fp_sub(H, U2, U1);
  fp_sub(rr, S2, S1);
  if (fp_is_zero(H)) {
    if (fp_is_zero(rr))
      pt_double<U>(r, p);
    else
      pt_set_inf(r);
    return;
  }
  u32* HH = Z1Z1;              // Z1Z1, Z2Z2, U2, S2 are dead from here
  u32* HHH = Z2Z2;
  u32* V = U2;
  u32* t = S2;
  fp_mul<U>(HH, H, H);
  fp_mul<U>(HHH, H, HH);
  fp_mul<U>(V, U1, HH);
  fp_mul<U>(t, p->z, q->z);
  fp_mul<U>(r->z, t, H);       // Z3 = Z1 Z2 H (p->z, q->z not read again)
  fp_mul<U>(t, rr, rr);
  fp_sub(t, t, HHH);
  fp_sub(t, t, V);
  fp_sub(r->x, t, V);          // X3 = r^2 - HHH - 2V
  fp_sub(t, V, r->x);
  fp_mul<U>(t, rr, t);
  fp_mul<U>(S1, S1, HHH);
  fp_sub(r->y, t, S1);         // Y3 = r (V - X3) - S1 HHH
}

// Round k of the inner-product opening on the original generators
// (zkcnn_tpu_torch/pcs/ipa.py), in one block of T threads; n = n_k (a
// power of two, 2 <= n <= L) terms are left after the round's fold.
//
// Thread t of T, first step: where c (the previous round's challenge
// c[0..7], its inverse c[8..15]) is given, b and x hold 2n words and fold
// to b'_j = c b_j + c^-1 b_(n+j) and x'_j = c^-1 x_j + c x_(n+j) (the
// roles swap for x), which the thread writes to b_out, x_out (n words
// each) at the indices j and j + n/2 of its pairs j = t, t + T, ... < n/2;
// in round 0 (c null) b' = b and x' = x, and nothing is written.  It sums
// over its pairs cl = <b'_lo, x'_hi> and cr = <b'_hi, x'_lo> (sums of
// Montgomery products, FR.dot_mont's value) into cl, cr [8].  All words
// are canonical Montgomery residues.
ZK_DEV inline void ipa_fold_dots(const u32* b, const u32* x, const u32* c,
                                 u32* b_out, u32* x_out, long long n, int t,
                                 int T, u32* cl, u32* cr) {
  const long long h = n >> 1;
  fr::set_zero(cl);
  fr::set_zero(cr);
  for (long long j = t; j < h; j += T) {
    u32 bb[2][NR], xx[2][NR], u[NR], v[NR];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long i = j + e * h;
      if (c) {
        fr_mul(u, b + i * NR, c);
        fr_mul(v, b + (n + i) * NR, c + NR);
        add_mod(bb[e], u, v);
        fr_mul(u, x + i * NR, c + NR);
        fr_mul(v, x + (n + i) * NR, c);
        add_mod(xx[e], u, v);
        fr::copy(b_out + i * NR, bb[e]);
        fr::copy(x_out + i * NR, xx[e]);
      } else {
        fr::copy(bb[e], b + i * NR);
        fr::copy(xx[e], x + i * NR);
      }
    }
    fr_mul(u, bb[0], xx[1]);
    add_mod(cl, cl, u);
    fr_mul(u, bb[1], xx[0]);
    add_mod(cr, cr, u);
  }
}

// One level of the block's tree of the two dots: thread t < step adds the
// sums of thread t + step to its own.  sums: [2, T, 8], cl's partial sums
// then cr's; after the levels step = T/2, ..., 1 (T a power of two) the
// dots are sums[0] and sums[T].
ZK_DEV inline void ipa_dot_step(u32* sums, int T, int t, int step) {
  if (t >= step) return;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    u32* a = sums + ((long long)d * T + t) * NR;
    add_mod(a, a, a + (long long)step * NR);
  }
}

// Term i < L of round k: its weight s_i takes the previous round's
// challenge, c[0..7] where the bit n of i is set, else its inverse
// c[8..15] (c null in round 0: s_i as given), and goes to s_out unless
// s_out is null; then b' at the partner index (i mod n) XOR n/2, times
// s_i, goes to row 0 where the bit n/2 of i is set, else to row 1, and a
// zero to the other row.  b: b' [n, 8]; s_in, s_out: [L, 8]; rows:
// [2, L + 1, 8]; all Montgomery words.
ZK_DEV inline void ipa_term(const u32* b, const u32* s_in, u32* s_out,
                            const u32* c, u32* rows, long long i,
                            long long L, long long n) {
  u32 s[NR], x[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) s[j] = s_in[i * NR + j];
  if (c) fr_mul(s, s, c + ((i & n) ? 0 : NR));
  const long long h = n >> 1;
  const long long p = (i & (n - 1)) ^ h;
  if (s_out) fr::copy(s_out + i * NR, s);
#pragma unroll
  for (int j = 0; j < NR; ++j) x[j] = b[p * NR + j];
  fr_mul(x, x, s);
  const bool hi = (i & h) != 0;
  u32* on = rows + ((hi ? 0 : L + 1) + i) * NR;
  u32* off = rows + ((hi ? L + 1 : 0) + i) * NR;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    on[j] = x[j];
    off[j] = 0;
  }
}

// Thread t of T, last step, once b' is written and the dots summed: the
// terms i = t, t + T, ... < L (ipa_term; b is b', which is b itself in
// round 0, and s_out null there), and thread 0 puts the dots (sums[0],
// sums[T]) in the Q column of the rows.
ZK_DEV inline void ipa_rows(const u32* b, const u32* s_in, u32* s_out,
                            const u32* c, const u32* sums, u32* rows,
                            long long L, long long n, int t, int T) {
  for (long long i = t; i < L; i += T)
    ipa_term(b, s_in, s_out, c, rows, i, L, n);
  if (t == 0) {
    fr::copy(rows + L * NR, sums);
    fr::copy(rows + (2 * L + 1) * NR, sums + (long long)T * NR);
  }
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

// The fixed-base window table of one base P: tab holds nwin windows of
// WTAB points, entry (j, d - 1) = d 2^(WBITS j) P, in [nwin, WTAB, 3, 12]
// words.  NWIN windows cover a 256-bit scalar.
constexpr int NWIN = 64;

// Entries (j, d - 1) for d = 1, 2, 4, 8, that is 2^(4j + s) P for s < 4,
// of every window j: one chain of 4 nwin - 1 doublings, each stored.
ZK_DEV inline void table_chain(u32* tab, const Pt* p, int nwin) {
  Pt q;
  pt_copy(&q, p);
  for (int j = 0; j < nwin; ++j)
    for (int s = 0; s < WBITS; ++s) {
      if (j || s) pt_double(&q, &q);
      pt_store(tab + ((long long)j * WTAB + (1 << s) - 1) * PW, &q);
    }
}

// One entry of a round of the digit multiples of a window (win: its WTAB
// points): entry m + e = entry m + entry e, for 1 <= e < m and
// m + e <= WTAB.  Rounds m = 2, 4, 8 make the 11 digits that are not
// powers of two by one addition each; the entries a round reads come
// from the chain or from earlier rounds.
ZK_DEV inline void table_step(u32* win, int m, int e) {
  Pt a, b;
  pt_load(&a, win + (m - 1) * PW);
  pt_load(&b, win + (e - 1) * PW);
  pt_add(&a, &a, &b);
  pt_store(win + (m + e - 1) * PW, &a);
}

// The whole table of one base in one thread (the kernels spread the same
// steps over threads).
ZK_DEV inline void table_build(u32* tab, const Pt* p, int nwin) {
  table_chain(tab, p, nwin);
  for (int j = 0; j < nwin; ++j)
    for (int m = 2; m < WTAB; m *= 2)
      for (int e = 1; e < m && m + e <= WTAB; ++e)
        table_step(tab + (long long)j * WTAB * PW, m, e);
}

// Digit j (bits 4j .. 4j + 3) of the plain scalar k, cut to its low nbits
// bits.
ZK_DEV inline u32 window_digit(const u32* k, int j, int nbits) {
  const int lo = j * WBITS;        // 32 is a multiple of WBITS
  if (lo >= nbits) return 0;
  u32 d = (k[lo >> 5] >> (lo & 31)) & WTAB;
  if (lo + WBITS > nbits) d &= (1u << (nbits - lo)) - 1;
  return d;
}

// acc += the sum over windows j0 <= j < j1 of entry (j, digit_j(k) - 1)
// of one base's table: one complete addition a nonzero digit, no
// doubling.  Zero digits add nothing, so a zero scalar leaves acc as it
// is.
ZK_DEV inline void table_sum(Pt* acc, const u32* tab, const u32* k, int j0,
                             int j1, int nbits) {
  Pt e;
  for (int j = j0; j < j1; ++j) {
    const u32 d = window_digit(k, j, nbits);
    if (d) {
      pt_load(&e, tab + ((long long)j * WTAB + d - 1) * PW);
      pt_add(acc, acc, &e);
    }
  }
}

// ---------------------------------------------------------------------
// Lane groups: the table's doublings spread over the lanes of a warp.
//
// One thread's chain of doublings is bound by latency: 7 dependent Fp
// products a doubling, each a serial run of carry chains.  Here a group of
// G = S K lanes runs the chain of one base.  Every lane of the group holds
// the whole point and every other value of the doubling, so the modular
// additions are one thread's code, run by all lanes alike; a product is
// split over S lanes by words (lane j of the product's sub-group owns words
// j W .. j W + W - 1, W = 12 / S), and K = 3 sub-groups run the three
// products of a dependency level of the doubling at once (the check entry
// of the product alone takes K = 1).  The lanes exchange values by
// __shfl_sync on the card; on the host (g++) a lane value is an array over
// the 32 lanes of a warp and each operation a loop over them, so the same
// lane code runs there in lock step and the tests hold it against the
// one-thread functions above.
//
// The lane code branches on nothing that differs between lanes: a whole
// warp runs every shuffle, also its lanes that hold no base.

constexpr int WARP = 32;

#ifdef __CUDACC__
typedef u32 LW;          // a lane's word
typedef u64 LD;          // a lane's double word
typedef int LI;          // a lane's index
typedef long long LL;    // a lane's offset
typedef bool LB;         // a lane's flag

ZK_INLINE LW lshfl(LW v, LI src) { return __shfl_sync(0xffffffffu, v, src); }
template <class T>
ZK_INLINE T lsel(LB c, T a, T b) { return c ? a : b; }
ZK_INLINE LB land(LB a, LB b) { return a && b; }
ZK_INLINE LD lwide(LW x) { return x; }
ZK_INLINE LL lwide_ll(LI x) { return x; }
ZK_INLINE LW llo(LD x) { return (u32)x; }
ZK_INLINE LD lhi(LD x) { return x >> 32; }
ZK_INLINE LD lmad(LW a, LW b, LD c) { return (u64)a * b + c; }
ZK_INLINE LW lload(const u32* p, LL i) { return p[i]; }
ZK_INLINE void lstore(u32* p, LL i, LW v, LB on) {
  if (on) p[i] = v;
}
ZK_INLINE void lfp_add(LW* r, const LW* a, const LW* b) { fp_add(r, a, b); }
ZK_INLINE void lfp_sub(LW* r, const LW* a, const LW* b) { fp_sub(r, a, b); }
ZK_INLINE void lfp_cond_sub(LW* r, const LW* t) { fp_cond_sub(r, t); }
#else
template <class T>
struct Lanes {
  T v[WARP];
  Lanes() = default;
  Lanes(T x) {                       // every lane the same value
    for (auto& e : v) e = x;
  }
};

template <class T>
struct lane_scalar : std::is_arithmetic<T> {};

#define ZK_LANE_OP(op)                                                     \
  template <class A, class B>                                              \
  auto operator op(const Lanes<A>& a, const Lanes<B>& b) {                 \
    Lanes<decltype(a.v[0] op b.v[0])> r;                                   \
    for (int l = 0; l < WARP; ++l) r.v[l] = a.v[l] op b.v[l];              \
    return r;                                                              \
  }                                                                        \
  template <class A, class B,                                              \
            class = typename std::enable_if<lane_scalar<B>::value>::type>  \
  auto operator op(const Lanes<A>& a, B b) {                               \
    return a op Lanes<B>(b);                                               \
  }                                                                        \
  template <class A, class B,                                              \
            class = typename std::enable_if<lane_scalar<A>::value>::type>  \
  auto operator op(A a, const Lanes<B>& b) {                               \
    return Lanes<A>(a) op b;                                               \
  }
ZK_LANE_OP(+)
ZK_LANE_OP(-)
ZK_LANE_OP(*)
ZK_LANE_OP(/)
ZK_LANE_OP(%)
ZK_LANE_OP(==)
ZK_LANE_OP(<)
#undef ZK_LANE_OP

typedef Lanes<u32> LW;
typedef Lanes<u64> LD;
typedef Lanes<int> LI;
typedef Lanes<long long> LL;
typedef Lanes<bool> LB;

// __shfl_sync with its source lane taken modulo the warp
inline LW lshfl(const LW& v, const LI& src) {
  LW r;
  for (int l = 0; l < WARP; ++l) r.v[l] = v.v[src.v[l] & (WARP - 1)];
  return r;
}
template <class T>
inline Lanes<T> lsel(const LB& c, const Lanes<T>& a, const Lanes<T>& b) {
  Lanes<T> r;
  for (int l = 0; l < WARP; ++l) r.v[l] = c.v[l] ? a.v[l] : b.v[l];
  return r;
}
inline LB land(const LB& a, const LB& b) {
  LB r;
  for (int l = 0; l < WARP; ++l) r.v[l] = a.v[l] && b.v[l];
  return r;
}
inline LD lwide(const LW& x) { return x + (u64)0; }
inline LL lwide_ll(const LI& x) { return x + (long long)0; }
inline LW llo(const LD& x) {
  LW r;
  for (int l = 0; l < WARP; ++l) r.v[l] = (u32)x.v[l];
  return r;
}
inline LD lhi(const LD& x) {
  LD r;
  for (int l = 0; l < WARP; ++l) r.v[l] = x.v[l] >> 32;
  return r;
}
inline LD lmad(const LW& a, const LW& b, const LD& c) {
  LD r;
  for (int l = 0; l < WARP; ++l) r.v[l] = (u64)a.v[l] * b.v[l] + c.v[l];
  return r;
}
inline LW lload(const u32* p, const LL& i) {
  LW r;
  for (int l = 0; l < WARP; ++l) r.v[l] = p[i.v[l]];
  return r;
}
inline void lstore(u32* p, const LL& i, const LW& v, const LB& on) {
  for (int l = 0; l < WARP; ++l)
    if (on.v[l]) p[i.v[l]] = v.v[l];
}
// one thread's modular operations, lane by lane
#define ZK_LANE_FP(name, call, ...)                                        \
  inline void name(__VA_ARGS__) {                                          \
    for (int l = 0; l < WARP; ++l) {                                       \
      u32 x[NP], y[NP], z[NP];                                             \
      for (int k = 0; k < NP; ++k) {                                       \
        x[k] = a[k].v[l];                                                  \
        y[k] = b[k].v[l];                                                  \
      }                                                                    \
      call;                                                                \
      for (int k = 0; k < NP; ++k) r[k].v[l] = z[k];                       \
    }                                                                      \
  }
ZK_LANE_FP(lfp_add, fp_add(z, x, y), LW* r, const LW* a, const LW* b)
ZK_LANE_FP(lfp_sub, fp_sub(z, x, y), LW* r, const LW* a, const LW* b)
#undef ZK_LANE_FP
inline void lfp_cond_sub(LW* r, const LW* t) {
  for (int l = 0; l < WARP; ++l) {
    u32 x[NP];
    for (int k = 0; k < NP; ++k) x[k] = t[k].v[l];
    fp_cond_sub(x, x);
    for (int k = 0; k < NP; ++k) r[k].v[l] = x[k];
  }
}
#endif

// A lane's place in its group: `first` the group's lane 0, g its
// sub-group, j its place there, `sub` the sub-group's lane 0 and `up` the
// lane of j + 1 (its own for the last).
template <int S, int K>
struct LaneGroup {
  static_assert(NP % S == 0 && (K == 1 || K == 3) && S * K <= WARP,
                "a product splits 12 words evenly; 1 or 3 sub-groups a warp");
  LI first, g, j, sub, up;
  ZK_DEV explicit LaneGroup(const LI& lane) {
    const LI q = lane % (S * K);
    first = lane - q;
    g = q / S;
    j = q % S;
    sub = first + g * S;
    up = lsel(j == S - 1, lane, lane + 1);
  }
};

// This lane's share of the Montgomery product a b R^-1 of its sub-group,
// for the whole operands a, b (the same on every lane of the sub-group):
// its W words nw and a carry cy (at most 4) that belongs one word above
// them.  A CIOS product by words of b: lane j adds a_k b_i + m p_k into
// its words k (two carry chains of W steps on 64-bit sums), m = t_0
// (-p^-1) taken from lane 0 of the sub-group; the carry out of its top
// word stays in a spare (sp, below 2^34) that the shift leaves on the same
// word, and the shift brings the bottom word of lane j + 1 in at the top.
// The spare is folded into the top word once a step; lane_gather resolves
// the carries that remain.
template <int S, int K>
ZK_INLINE void lane_mul_part(LW* nw, LW& cy, const LW* a, const LW* b,
                             const LaneGroup<S, K>& grp) {
  constexpr int W = NP / S;
  static_assert(W > 1, "the spare needs a top word above word 0");
  LW aw[W], pw[W], t[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    aw[k] = a[k];
    pw[k] = LW(FP_MOD[k]);
#pragma unroll
    for (int q = 1; q < S; ++q) {
      aw[k] = lsel(grp.j == q, a[q * W + k], aw[k]);
      pw[k] = lsel(grp.j == q, LW(FP_MOD[q * W + k]), pw[k]);
    }
    t[k] = LW(0u);
  }
  LD sp = LD(0ull);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const LW bi = b[i];
    LD s1 = lmad(aw[0], bi, lwide(t[0]));
    LW x0 = llo(s1);
    const LW m = lshfl(x0 * FP_INV, grp.sub);
    LD s2 = lmad(m, pw[0], lwide(llo(s1)));
    LD c1 = lhi(s1), c2 = lhi(s2);
    nw[0] = llo(s2);
#pragma unroll
    for (int k = 1; k < W; ++k) {
      s1 = lmad(aw[k], bi, lwide(t[k]) + c1);
      c1 = lhi(s1);
      s2 = lmad(m, pw[k], lwide(llo(s1)) + c2);
      c2 = lhi(s2);
      nw[k] = llo(s2);
    }
    const LD s3 = lwide(nw[W - 1]) + sp;
    nw[W - 1] = llo(s3);
    sp = c1 + c2 + lhi(s3);
    const LW in = lshfl(nw[0], grp.up);
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) t[k] = nw[k + 1];
    t[W - 1] = lsel(grp.j == S - 1, LW(0u), in);
  }
  const LD s3 = lwide(t[W - 1]) + sp;
#pragma unroll
  for (int k = 0; k + 1 < W; ++k) nw[k] = t[k];
  nw[W - 1] = llo(s3);
  cy = llo(lhi(s3));
}

// The product whose shares the sub-group at lane `from` holds, whole and
// canonical on every lane: its 12 words and S carries by shuffle, the
// carries added (the value is below 2p), then one conditional subtraction.
template <int S>
ZK_INLINE void lane_gather(LW* r, const LW* nw, const LW& cy,
                           const LI& from) {
  constexpr int W = NP / S;
  LW u[NP], v[NP];
#pragma unroll
  for (int w = 0; w < NP; ++w) {
    u[w] = lshfl(nw[w % W], from + w / W);
    v[w] = LW(0u);
  }
  // the last lane's carry lies above word 11, so it is 0
#pragma unroll
  for (int q = 0; q + 1 < S; ++q) v[(q + 1) * W] = lshfl(cy, from + q);
  LD c = LD(0ull);
#pragma unroll
  for (int w = 0; w < NP; ++w) {
    const LD s = lwide(u[w]) + v[w] + c;
    u[w] = llo(s);
    c = lhi(s);
  }
  lfp_cond_sub(r, u);
}

// r_n = x_n y_n for n < 3, on every lane: sub-group n takes product n.
// No r_n may be an operand of a later product.
template <int S, int K>
ZK_INLINE void lane_mul3(LW* r0, LW* r1, LW* r2, const LW* x0, const LW* y0,
                         const LW* x1, const LW* y1, const LW* x2,
                         const LW* y2, const LaneGroup<S, K>& grp) {
  static_assert(K == 3, "three sub-groups");
  LW nw[NP / S], cy, a[NP], b[NP];
  const LB g0 = grp.g == 0, g1 = grp.g == 1;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    a[k] = lsel(g0, x0[k], lsel(g1, x1[k], x2[k]));
    b[k] = lsel(g0, y0[k], lsel(g1, y1[k], y2[k]));
  }
  lane_mul_part(nw, cy, a, b, grp);
  lane_gather<S>(r0, nw, cy, grp.first);
  lane_gather<S>(r1, nw, cy, grp.first + S);
  lane_gather<S>(r2, nw, cy, grp.first + 2 * S);
}

// r = x y on every lane (every sub-group computes it); r may be x or y.
template <int S, int K>
ZK_INLINE void lane_mul(LW* r, const LW* x, const LW* y,
                        const LaneGroup<S, K>& grp) {
  LW nw[NP / S], cy;
  lane_mul_part(nw, cy, x, y, grp);
  lane_gather<S>(r, nw, cy, grp.first);
}

// pt_double's formula on the lanes of a group, in place, its seven
// products in three levels: {Y Z, X^2, Y^2}, {B^2, (X + B)^2, E^2},
// {E (D - X3)}.  The results are pt_double's words.
template <int S, int K>
ZK_INLINE void lane_double(LW* X, LW* Y, LW* Z, const LaneGroup<S, K>& grp) {
  LW YZ[NP], A[NP], B[NP], C[NP], D[NP], E[NP], F[NP], T[NP];
  lane_mul3(YZ, A, B, Y, Z, X, X, Y, Y, grp);
  lfp_add(Z, YZ, YZ);                    // Z3 = 2 Y Z
  lfp_add(E, A, A);
  lfp_add(E, E, A);                      // E = 3A
  lfp_add(T, X, B);
  lane_mul3(C, D, F, B, B, T, T, E, E, grp);
  lfp_sub(D, D, A);
  lfp_sub(D, D, C);
  lfp_add(D, D, D);
  lfp_add(T, D, D);
  lfp_sub(X, F, T);                      // X3 = F - 2D
  lfp_add(C, C, C);
  lfp_add(C, C, C);
  lfp_add(C, C, C);                      // 8C
  lfp_sub(T, D, X);
  lane_mul(T, E, T, grp);
  lfp_sub(Y, T, C);                      // Y3 = E (D - X3) - 8C
}

// table_chain on lane groups: warp `warp` (lanes `lane`) takes bases
// warp * (32 / G) ... of the N in pts; each group runs its base's chain of
// 4 nwin - 1 doublings and stores entries d = 1, 2, 4, 8 of every window,
// lane q of the group the words q, q + G, ... of each.  Lanes past the last
// whole group, and groups past base N - 1, run a base of their neighbours'
// and store nothing.
template <int S, int K>
ZK_INLINE void table_chain_lanes(u32* tab, const u32* pts, long long N,
                                 int nwin, long long warp, const LI& lane) {
  constexpr int G = S * K, PER = WARP / G;
  const LaneGroup<S, K> grp(lane);
  const LI slot = lane / G, q = lane % G;
  const LL i = lwide_ll(slot) + warp * PER;
  const LB live = land(slot < PER, i < N);
  const LL src = lsel(i < N, i, LL(N - 1));
  LW X[NP], Y[NP], Z[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    X[k] = lload(pts, src * PW + k);
    Y[k] = lload(pts, src * PW + NP + k);
    Z[k] = lload(pts, src * PW + 2 * NP + k);
  }
  for (int j = 0; j < nwin; ++j)
    for (int s = 0; s < WBITS; ++s) {
      if (j || s) lane_double(X, Y, Z, grp);
      const LL at = ((i * nwin + j) * WTAB + (1 << s) - 1) * PW;
#pragma unroll
      for (int w = 0; w < PW; ++w)
        lstore(tab, at + w,
               w < NP ? X[w] : w < 2 * NP ? Y[w - NP] : Z[w - 2 * NP],
               land(live, q == w % G));
    }
}

// out[i] = a[i] b[i] R^-1 for the n operand pairs, a pair a sub-group of S
// lanes (warp `warp` takes pairs warp * (32 / S) ...); or, where chain > 0
// (n = 1), x <- x b[0] chain times from x = a[0], each product waiting for
// the last.
template <int S>
ZK_INLINE void fp_mul_lanes(u32* out, const u32* a, const u32* b,
                            long long n, long long chain, long long warp,
                            const LI& lane) {
  constexpr int PER = WARP / S;
  const LaneGroup<S, 1> grp(lane);
  const LI slot = lane / S, q = lane % S;
  const LL i = lwide_ll(slot) + warp * PER;
  const LB live = land(slot < PER, i < n);
  const LL src = lsel(i < n, i, LL(n - 1));
  LW x[NP], y[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    x[k] = lload(a, src * NP + k);
    y[k] = lload(b, src * NP + k);
  }
  const long long reps = chain > 0 ? chain : 1;
  for (long long r = 0; r < reps; ++r) lane_mul(x, x, y, grp);
#pragma unroll
  for (int w = 0; w < NP; ++w)
    lstore(out, src * NP + w, x[w], land(live, q == w % S));
}

}  // namespace g1

#endif  // ZKCNN_G1_ARITH_CUH
