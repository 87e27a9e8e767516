"""zkcnn_tpu_torch's Fp arithmetic and G1 point formulas against
zkcnn_tpu's (JAX, on the CPU) and against Python integers.

Tolerance 0: field results are compared word for word, points as affine
integers.  Inputs come from np.random.default_rng(seed).  The last test
builds the CUDA source's one-thread arithmetic (csrc/g1_arith.cuh) for
the host with g++ and holds it against Python integers; it skips where
there is no g++.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkcnn_tpu.field.limbs import FP as JFP
from zkcnn_tpu.pcs import curve as jcurve
from zkcnn_tpu_torch.field import FP, FR, FP_P, FR_P
from zkcnn_tpu_torch.interop import limbs16_to_words, points_from_jax, \
    points_to_jax
from zkcnn_tpu_torch.pcs import curve, ipa

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)


def _rand_fp(rng, n):
    return [int.from_bytes(rng.bytes(48), "little") % FP_P for _ in range(n)]


def test_fp_ops_match_jax_fp():
    """The same Fp residues (R = 2^384 in both packages) through both:
    bit-identical words."""
    rng = np.random.default_rng(11)
    xs = _rand_fp(rng, 29) + [0, FP_P - 1, 1]
    ys = _rand_fp(rng, 29) + [FP_P - 1, FP_P - 1, 0]
    JA = np.stack([JFP.to_mont_host(x) for x in xs])
    JB = np.stack([JFP.to_mont_host(y) for y in ys])
    A = torch.from_numpy(limbs16_to_words(JA))
    B = torch.from_numpy(limbs16_to_words(JB))
    assert A.shape == (32, 12) and FP.n == 12 and FP.R == 1 << 384
    np.testing.assert_array_equal(A.numpy(), FP.pack_mont_host(xs))
    for name in ("mul", "add", "sub"):
        want = np.asarray(getattr(JFP, name)(jnp.asarray(JA),
                                             jnp.asarray(JB)))
        got = getattr(FP, name)(A, B)
        np.testing.assert_array_equal(limbs16_to_words(want), got.numpy())
    assert FP.unpack_mont_host(FP.mul(A, B).numpy()) == \
        [x * y % FP_P for x, y in zip(xs, ys)]


def _edge_batch():
    """8 pairs: both infinity, either infinity, P + P, P + (-P), and
    three generic pairs with Z != 1."""
    rng = np.random.default_rng(12)
    P1, P2, P3 = (curve.py_mul(G, int(k)) for k in (5, 77, 123456789))
    neg = lambda P: (P[0], (-P[1]) % FP_P)
    ps = [None, None, P1, P1, P1, P1, P2, P3]
    qs = [None, P1, None, P1, neg(P1), P2, P3, neg(P2)]

    def jac(P):
        if P is None:
            return curve.point_pack((0, 0, 0))
        z = int.from_bytes(rng.bytes(40), "little") % FP_P or 1
        return curve.point_pack((P[0] * z * z % FP_P,
                                 P[1] * z ** 3 % FP_P, z))
    return ps, qs, np.stack([jac(P) for P in ps]), \
        np.stack([jac(Q) for Q in qs])


def test_padd_pdouble_match_jax_and_python_ints():
    ps, qs, a, b = _edge_batch()
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    got = curve.padd(A, B)
    want = [curve.py_add(P, Q) for P, Q in zip(ps, qs)]
    assert curve.to_affine_host(got) == want
    assert curve.to_affine_host(curve.pdouble(A)) == \
        [curve.py_add(P, P) for P in ps]
    # the opposite pair gives canonical zeros, not only Z = 0
    assert not got[4].any()
    jgot = jcurve.padd(jnp.asarray(points_to_jax(A)),
                       jnp.asarray(points_to_jax(B)))
    assert curve.to_affine_host(points_from_jax(jgot)) == want
    jdbl = jcurve.pdouble(jnp.asarray(points_to_jax(A)))
    # the same formulas on canonical residues: the same coordinates
    np.testing.assert_array_equal(points_from_jax(jdbl).numpy(),
                                  curve.pdouble(A).numpy())
    np.testing.assert_array_equal(points_from_jax(jgot).numpy(),
                                  got.numpy())


_HARNESS = r"""
#define ZK_DEV
#define ZK_DEV_NOINLINE
#define ZK_CONST static const
#include "g1_arith.cuh"
using namespace g1;
static void ld(Pt* p, const u32* s) {
  for (int k = 0; k < NP; ++k) {
    p->x[k] = s[k]; p->y[k] = s[NP + k]; p->z[k] = s[2 * NP + k];
  }
}
static void st(u32* d, const Pt* p) {
  for (int k = 0; k < NP; ++k) {
    d[k] = p->x[k]; d[NP + k] = p->y[k]; d[2 * NP + k] = p->z[k];
  }
}
extern "C" {
void h_fp_mul(u32* r, const u32* a, const u32* b) { fp_mul(r, a, b); }
void h_fp_add(u32* r, const u32* a, const u32* b) { fp_add(r, a, b); }
void h_fp_sub(u32* r, const u32* a, const u32* b) { fp_sub(r, a, b); }
void h_pt_add(u32* r, const u32* p, const u32* q, int alias) {
  Pt a, b, c;
  ld(&a, p); ld(&b, q);
  if (alias == 1) { pt_add(&a, &a, &b); st(r, &a); }
  else if (alias == 2) { pt_add(&b, &a, &b); st(r, &b); }
  else { pt_add(&c, &a, &b); st(r, &c); }
}
void h_scalar_mul(u32* r, const u32* p, const u32* k, int nbits, int mont) {
  Pt a, acc; u32 kk[NR];
  ld(&a, p);
  for (int j = 0; j < NR; ++j) kk[j] = k[j];
  if (mont) fr_from_mont(kk);
  pt_scalar_mul(&acc, &a, kk, nbits);
  st(r, &acc);
}
void h_fr_mul(u32* r, const u32* a, const u32* b) { fr_mul(r, a, b); }
void h_ipa_terms(const u32* b, const u32* s_in, u32* s_out, const u32* c,
                 u32* rows, long long L, long long n) {
  for (long long i = 0; i < L; ++i) ipa_term(b, s_in, s_out, c, rows, i, L, n);
}
}
"""


def test_cuda_arithmetic_built_for_the_host_matches_python_ints(tmp_path):
    """csrc/g1_arith.cuh is plain C++ behind its macros: Fp add/sub/mul,
    the complete point addition (every alias of the result) and the
    double-and-add loop, as the kernels run them, against Python ints;
    the Fr product likewise, and the inner-product opening's round terms
    (ipa_term) against the rows and weights of ipa_round_plain, word for
    word."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA arithmetic for the host")
    csrc = pathlib.Path(curve.__file__).resolve().parents[1] / "csrc"
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib_path = tmp_path / "libg1host.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rng = np.random.default_rng(13)

    vals = [0, 1, FP_P - 1] + _rand_fp(rng, 40)
    for x in vals:
        for y in vals[:5]:
            a, b = FP.to_mont_host(x), FP.to_mont_host(y)
            for name, want in (("h_fp_mul", x * y), ("h_fp_add", x + y),
                               ("h_fp_sub", x - y)):
                r = np.zeros(12, np.int32)
                getattr(lib, name)(ptr(r), ptr(a), ptr(b))
                assert FP.int_host(r) < FP_P
                assert FP.from_mont_host(r) == want % FP_P

    ps, qs, a, b = _edge_batch()
    for i, (P, Q) in enumerate(zip(ps, qs)):
        for alias in (0, 1, 2):
            r = np.zeros((3, 12), np.int32)
            lib.h_pt_add(ptr(r), ptr(np.ascontiguousarray(a[i])),
                         ptr(np.ascontiguousarray(b[i])), alias)
            assert curve.to_affine_host(r) == [curve.py_add(P, Q)]

    P = np.ascontiguousarray(a[7])
    big = int.from_bytes(rng.bytes(32), "little")
    for k, nbits in ((0, 255), (1, 255), (3, 255), (FR_P - 1, 255),
                     ((1 << 254) | 5, 255), (0x1FFFF, 16), (16, 255),
                     (0xF0, 255), (int.from_bytes(rng.bytes(31), "little"),
                                   255)) + tuple(
                         (big, n) for n in (1, 2, 5, 13, 31, 32, 33, 256)):
        for mont in (0, 1) if k < FR_P else (0,):
            kk = FR.to_mont_host(k) if mont else FR.words_host(k)
            r = np.zeros((3, 12), np.int32)
            lib.h_scalar_mul(ptr(r), ptr(P), ptr(kk), nbits, mont)
            assert curve.to_affine_host(r) == \
                [curve.py_mul(ps[7], k & ((1 << nbits) - 1))]

    # the Fr product, and the inner-product opening's round terms on the
    # folded b against the plain round (the Q column aside)
    frs = [0, 1, 2, FR_P - 1, FR_P - 2] + \
        [int.from_bytes(rng.bytes(32), "little") % FR_P for _ in range(30)]
    for x in frs:
        for y in frs[:7]:
            r = np.zeros(8, np.int32)
            lib.h_fr_mul(ptr(r), ptr(FR.to_mont_host(x)),
                         ptr(FR.to_mont_host(y)))
            assert FR.int_host(r) < FR_P
            assert FR.from_mont_host(r) == x * y % FR_P
    for L, n, prev in ((2, 2, None), (8, 8, None), (8, 4, (frs[5], frs[6])),
                       (16, 2, (FR_P - 1, FR_P - 1))):
        b_in = torch.from_numpy(FR.pack_mont_host(frs[:2 * n if prev else n]))
        s_in = torch.from_numpy(FR.pack_mont_host(frs[-L:]))
        want_rows, want_s, b, _ = ipa.ipa_round_plain(b_in, b_in.flip(0),
                                                      s_in, prev)
        rows = np.zeros((2, L + 1, 8), np.int32)
        rows[:, L] = want_rows[:, L].numpy()
        s_out = np.zeros((L, 8), np.int32)
        chal = None if prev is None else ptr(FR.pack_mont_host(prev))
        lib.h_ipa_terms(ptr(b.numpy()), ptr(s_in.numpy()), ptr(s_out), chal,
                        ptr(rows), ctypes.c_longlong(L), ctypes.c_longlong(n))
        np.testing.assert_array_equal(rows, want_rows.numpy())
        np.testing.assert_array_equal(s_out, want_s.numpy())
