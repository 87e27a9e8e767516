// The Fiat-Shamir tape on the card: SHA-512, the tape's absorb and draw,
// and the finish of a sumcheck round that forms the message, absorbs it
// and draws the next challenge, so that a phase runs as one launch
// sequence with no host in between (round_kernels.cu: zk_fold_round_phase,
// zk_fold_cubic_round_phase).
//
// The tape is zkcnn_tpu_torch/gkr/tape.py's FiatShamirTape (the JAX
// package's zkcnn_tpu/gkr/tape.py:58-86), bit for bit:
//   * absorb(v_1..v_k): state' = SHA-512(state || v_1 || ... || v_k), each
//     v_i its canonical residue as 32 little-endian bytes;
//   * draw: SHA-512(state || counter as 8 little-endian bytes), the 64
//     digest bytes read as a little-endian integer mod p; counter += 1.
// SHA-512's words are big-endian; the state, the values, the counter and
// the digest-as-integer are byte strings here, kept as little-endian
// 32-bit words (byte i in bits 8 (i mod 4) of word i / 4).
//
// One thread runs it: an absorb of three or four values is two
// compressions (160 or 192 bytes), a draw one (72 bytes).  Plain C++
// behind fr_arith.cuh's macros, so that g++ builds it for the tests
// (tests/test_torch_fs_device_tape.py).
//
// The phase buffer, rows of 8 words: rows 0-1 the tape's state, row 2 its
// counter (words 0, 1), row 3 the quadratic phase's add_term (Montgomery);
// rows HEAD_ROWS + j the challenges r_j (Montgomery); then the messages, k
// rows a round (k = 3 quadratic, 4 cubic; Montgomery).  The host fetches
// it once a phase.

#ifndef ZKCNN_FS_TAPE_CUH
#define ZKCNN_FS_TAPE_CUH

#include "fr_arith.cuh"

namespace fs {

using fr::u32;
using fr::u64;
using fr::NW;

constexpr int STATE_WORDS = 16;    // the tape's 64-byte state
constexpr int HEAD_ROWS = 4;       // state (2 rows), counter, add_term
constexpr int HEAD_WORDS = HEAD_ROWS * NW;

ZK_CONST u64 SHA512_K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull};
ZK_CONST u64 SHA512_IV[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};

ZK_INLINE u64 rotr(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

// One SHA-512 compression of the block w (16 big-endian words) into h.
ZK_DEV_NOINLINE void sha512_compress(u64* h, const u64* block) {
  u64 w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = block[i];
  u64 a = h[0], b = h[1], c = h[2], d = h[3];
  u64 e = h[4], f = h[5], g = h[6], k = h[7];
#pragma unroll
  for (int i = 0; i < 80; ++i) {
    if (i >= 16) {
      const u64 x = w[(i - 15) & 15], y = w[(i - 2) & 15];
      w[i & 15] += (rotr(x, 1) ^ rotr(x, 8) ^ (x >> 7)) + w[(i - 7) & 15] +
                   (rotr(y, 19) ^ rotr(y, 61) ^ (y >> 6));
    }
    const u64 t1 = k + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) +
                   ((e & f) ^ (~e & g)) + SHA512_K[i] + w[i & 15];
    const u64 t2 = (rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)) +
                   ((a & b) ^ (a & c) ^ (b & c));
    k = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

ZK_INLINE u32 bswap32(u32 y) {
  return (y >> 24) | ((y >> 8) & 0xff00u) | ((y << 8) & 0xff0000u) |
         (y << 24);
}

// SHA-512 over a stream of bytes that come eight at a time (every input of
// the tape is a whole number of 8-byte words: the state, 32-byte values,
// the counter), each 8 as a big-endian message word.
struct Sha512 {
  u64 h[8];
  u64 w[16];      // the block being filled
  int fill;       // its words
  u64 total;      // bytes in all

  ZK_DEV void init() {
    for (int i = 0; i < 8; ++i) h[i] = SHA512_IV[i];
    fill = 0;
    total = 0;
  }
  ZK_DEV void put(u64 word) {
    w[fill] = word;
    total += 8;
    if (++fill == 16) {
      sha512_compress(h, w);
      fill = 0;
    }
  }
  // n bytes (a multiple of 8), kept as little-endian 32-bit words (byte i
  // in bits 8 (i mod 4) of x[i / 4])
  ZK_DEV void update_words(const u32* x, int n) {
    for (int i = 0; i < n / 4; i += 2)
      put((u64)bswap32(x[i]) << 32 | bswap32(x[i + 1]));
  }
  // the 64 digest bytes as 16 little-endian 32-bit words
  ZK_DEV void final(u32* out) {
    const u64 bits = total * 8;
    put(0x80ull << 56);
    while (fill != 14) put(0);
    put(0);                      // the length's high 64 bits
    put(bits);
    for (int i = 0; i < 16; ++i)
      out[i] = bswap32((u32)(h[i >> 1] >> ((i & 1) ? 0 : 32)));
  }
};

// The tape's absorb: state <- SHA-512(state || v_1 || ... || v_k), where
// vals holds k Montgomery elements, each hashed as its canonical residue.
ZK_DEV inline void fs_absorb(u32* state, const u32* vals, int k) {
  Sha512 s;
  s.init();
  s.update_words(state, 64);
  for (int i = 0; i < k; ++i) {
    u32 v[NW];
    fr::copy(v, vals + i * NW);
    fr::fr_from_mont(v);
    s.update_words(v, 32);
  }
  s.final(state);
}

// A 64-byte digest d (16 little-endian words) read as a little-endian
// integer x = lo + hi 2^256, mod p, in Montgomery form:
// r = x R = mont(lo, R^2) + mont(hi, R^3).  fr_mul takes a first operand
// below 2^256 (lo and hi are below 2^256 < 3p, unreduced) and gives a
// canonical residue.
ZK_DEV inline void digest_to_fr(u32* r, const u32* d) {
  u32 hi[NW];
  fr::fr_mul(r, d, fr::R2);
  fr::fr_mul(hi, d + NW, fr::R3);
  fr::add_mod(r, r, hi);
}

// The tape's draw: r (Montgomery) = the digest of state || counter as an
// integer mod p; counter (two words, low first) += 1.
ZK_DEV inline void fs_draw(u32* r, const u32* state, u32* counter) {
  Sha512 s;
  s.init();
  s.update_words(state, 64);
  s.update_words(counter, 8);
  u32 d[STATE_WORDS];
  s.final(d);
  digest_to_fr(r, d);
  if (++counter[0] == 0) ++counter[1];
}

// Rows of the phase buffer.
ZK_DEV inline u32* phase_r(u32* buf, int j) {
  return buf + (HEAD_ROWS + j) * NW;
}
ZK_DEV inline u32* phase_msg(u32* buf, int n, int k, int j) {
  return buf + (HEAD_ROWS + n + k * j) * NW;
}

// The head of a phase as the host hands it over: the tape's state and
// counter and add_term (HEAD_WORDS words); add, when not null, is
// add_term in device memory instead.
struct Head {
  u32 w[HEAD_WORDS];
  const u32* add;
};

ZK_DEV inline void phase_init(u32* buf, const Head& head) {
  for (int i = 0; i < HEAD_WORDS; ++i) buf[i] = head.w[i];
  if (head.add) fr::copy(buf + 3 * NW, head.add);
}

// Round j's message, absorbed, and the draw of r_j, which goes to row
// HEAD_ROWS + j.
ZK_DEV inline void absorb_and_draw(u32* buf, int n, int k, int j) {
  fs_absorb(buf, phase_msg(buf, n, k, j), k);
  fs_draw(phase_r(buf, j), buf, buf + 2 * NW);
}

// A side that exhausts in round j (zkcnn_tpu_torch/gkr/engine.py,
// PhaseEngine._join): its two stored rows of A and of V folded at r (or,
// with r null, its one row) go to fin [2, 8] (A, V), and their product to
// prod.
ZK_DEV inline void join_side(u32* prod, u32* fin, const u32* A,
                             const u32* V, const u32* r) {
  u32 a[NW], v[NW];
  if (r) {
    fr::fold_at(a, A, A + NW, r);
    fr::fold_at(v, V, V + NW, r);
  } else {
    fr::copy(a, A);
    fr::copy(v, V);
  }
  fr::copy(fin, a);
  fr::copy(fin + NW, v);
  fr::fr_mul(prod, a, v);
}

// Round j of a quadratic phase as PhaseEngine.round forms it: add_term
// (row 3) decays by (1 - r_(j-1)) when j > 0 and include, the nj products
// of the sides that exhaust in round j join it, and the message is
// sum over the nd active sides of (D00, D01 + D10 - 2 D00,
// D11 - D01 - D10 + D00) from their pair dots (dots [nd, 4, 8]), plus
// add_term (1 - x) when include (quad_from_dots and _add_x); then it is
// absorbed and r_j drawn.
ZK_DEV inline void quad_finish(u32* buf, int n, int j, const u32* dots,
                               int nd, const u32* joins, int nj,
                               bool include) {
  u32* add = buf + 3 * NW;
  u32 t[NW];
  if (j > 0 && include) {
    fr::sub_mod(t, fr::ONE, phase_r(buf, j - 1));
    fr::fr_mul(add, add, t);
  }
  for (int i = 0; i < nj; ++i) fr::add_mod(add, add, joins + i * NW);
  u32* c = phase_msg(buf, n, 3, j);
  u32 c0[NW], c1[NW], c2[NW];
  fr::set_zero(c0);
  fr::set_zero(c1);
  fr::set_zero(c2);
  for (int s = 0; s < nd; ++s) {
    const u32* d = dots + s * 4 * NW;      // D00, D01, D10, D11
    fr::add_mod(c0, c0, d);
    fr::add_mod(c1, c1, d + NW);
    fr::add_mod(c1, c1, d + 2 * NW);
    fr::sub_mod(c1, c1, d);
    fr::sub_mod(c1, c1, d);
    fr::add_mod(c2, c2, d + 3 * NW);
    fr::sub_mod(c2, c2, d + NW);
    fr::sub_mod(c2, c2, d + 2 * NW);
    fr::add_mod(c2, c2, d);
  }
  if (include) {
    fr::add_mod(c0, c0, add);
    fr::sub_mod(c1, c1, add);
  }
  fr::copy(c, c0);
  fr::copy(c + NW, c1);
  fr::copy(c + 2 * NW, c2);
  absorb_and_draw(buf, n, 3, j);
}

// The end of a quadratic phase (PhaseEngine.receive at r_(n-1)): add_term
// decays once more when include.
ZK_DEV inline void quad_receive(u32* buf, int n, bool include) {
  if (!include) return;
  u32* add = buf + 3 * NW;
  u32 t[NW];
  fr::sub_mod(t, fr::ONE, phase_r(buf, n - 1));
  fr::fr_mul(add, add, t);
}

// Round j of a DOT_PROD phase 1: the message c0..c3 (coeffs [4, 8]; c3 = 0
// once m has one row), absorbed whole, c3 included, and r_j drawn.
ZK_DEV inline void cubic_finish(u32* buf, int n, int j, const u32* coeffs) {
  u32* c = phase_msg(buf, n, 4, j);
  for (int i = 0; i < 4 * NW; ++i) c[i] = coeffs[i];
  absorb_and_draw(buf, n, 4, j);
}

}  // namespace fs

#endif  // ZKCNN_FS_TAPE_CUH
