"""A round of zkcnn_tpu_torch's inner-product opening in one step
(`ipa.ipa_round`, kernel ipa_round of csrc/g1_kernels.cu): the plain
version over whole openings against the JAX package's field ops and
Python integers; the kernel's device functions (csrc/g1_arith.cuh:
ipa_fold_dots, ipa_dot_step, ipa_rows) built for the host with g++ and
run over the threads of a block, against the plain version; and the
wrapper's checks and its place in `ipa_prove`.

Tolerance 0: words are compared word for word, values as integers.
Inputs come from np.random.default_rng(seed).  The g++ test skips where
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

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.pcs.ipa import _fold_scalars as j_fold_scalars
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import Tape
from zkcnn_tpu_torch.interop import limbs16_to_words, words_to_limbs16
from zkcnn_tpu_torch.pcs import curve, ipa
from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM

G = (curve.G1_X, curve.G1_Y)

_HARNESS = r"""
#include <vector>
#define ZK_DEV
#define ZK_DEV_NOINLINE
#define ZK_CONST static const
#include "g1_arith.cuh"
using namespace g1;
extern "C" {
// Kernel ipa_round's block of T threads (a power of two): each step over
// every thread before the next, as the block's barriers order them; in
// round 0 (c null) the rows take b and s_in as they are.
void h_ipa_round(const u32* b, const u32* x, const u32* s_in, u32* s_out,
                 const u32* c, u32* b_out, u32* x_out, u32* rows,
                 long long L, long long n, int T) {
  std::vector<u32> sums(2 * T * NR);
  for (int t = 0; t < T; ++t)
    ipa_fold_dots(b, x, c, b_out, x_out, n, t, T, &sums[t * NR],
                  &sums[(T + t) * NR]);
  for (int step = T / 2; step > 0; step >>= 1)
    for (int t = 0; t < T; ++t) ipa_dot_step(sums.data(), T, t, step);
  for (int t = 0; t < T; ++t)
    ipa_rows(c ? b_out : b, s_in, c ? s_out : nullptr, c, sums.data(), rows,
             L, n, t, T);
}
}
"""


def _draw(rng):
    return int.from_bytes(rng.bytes(32), "little") % FR_P


def _mont(vals):
    return torch.from_numpy(FR.pack_mont_host(vals))


def _ints(t):
    return FR.unpack_mont_host(t.numpy())


def _j(t):
    """Port words -> the JAX package's Montgomery limbs."""
    return jnp.asarray(words_to_limbs16(t))


def _vectors(rng, L, fill):
    """b, x, the starting weights (ones) as Python ints: random, or p - 1
    throughout (fill == "p-1")."""
    if fill == "p-1":
        return [FR_P - 1] * L, [FR_P - 1] * L
    return [_draw(rng) for _ in range(L)], [_draw(rng) for _ in range(L)]


def test_plain_round_matches_jax_field_ops_and_python_ints():
    """Whole openings at L = 8 and 16 on ipa_round_plain, random rows and
    rows of p - 1 (the challenges p - 1 too): at every round the folded b
    and x equal the JAX package's _fold_scalars, the Q column its
    FR.dot_mont of the folded halves, and the folds, dots, weights and
    rows equal Python integers."""
    rng = np.random.default_rng(60)
    for L in (8, 16):
        for fill in ("random", "p-1"):
            bi, xi = _vectors(rng, L, fill)
            si = [1] * L
            b, x, s, prev = _mont(bi), _mont(xi), _mont(si), None
            jb, jx = _j(b), _j(x)
            for _ in range(L.bit_length() - 1):
                rows, s, b, x = ipa.ipa_round_plain(b, x, s, prev)
                n = len(bi) // 2 if prev else len(bi)
                if prev:
                    c, ci = prev
                    jb = j_fold_scalars(jb, c, ci)
                    jx = j_fold_scalars(jx, ci, c)
                    bi = [(c * lo + ci * hi) % FR_P
                          for lo, hi in zip(bi[:n], bi[n:])]
                    xi = [(ci * lo + c * hi) % FR_P
                          for lo, hi in zip(xi[:n], xi[n:])]
                    si = [w * (c if m & n else ci) % FR_P
                          for m, w in enumerate(si)]
                h = n // 2
                np.testing.assert_array_equal(
                    limbs16_to_words(np.asarray(jb)), b.numpy())
                np.testing.assert_array_equal(
                    limbs16_to_words(np.asarray(jx)), x.numpy())
                for q, (u, v) in ((0, (jb[:h], jx[h:])),
                                  (1, (jb[h:], jx[:h]))):
                    np.testing.assert_array_equal(
                        limbs16_to_words(np.asarray(JFR.dot_mont(u, v))),
                        rows[q, L].numpy())
                assert (_ints(b), _ints(x), _ints(s)) == (bi, xi, si)
                assert _ints(rows[:, L]) == [
                    sum(u * v for u, v in zip(bi[:h], xi[h:])) % FR_P,
                    sum(u * v for u, v in zip(bi[h:], xi[:h])) % FR_P]
                want = [[0] * L, [0] * L]
                for m in range(L):
                    w = bi[(m % n) ^ h] * si[m] % FR_P
                    want[0 if m & h else 1][m] = w
                assert [_ints(rows[q, :L]) for q in (0, 1)] == want
                c = FR_P - 1 if fill == "p-1" else _draw(rng)
                prev = (c, pow(c, -1, FR_P))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA arithmetic for the host")
    csrc = pathlib.Path(curve.__file__).resolve().parents[1] / "csrc"
    tmp = tmp_path_factory.mktemp("iparound")
    src = tmp / "harness.cpp"
    src.write_text(_HARNESS)
    path = tmp / "libiparound.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o", str(path),
                    str(src)], check=True)
    return ctypes.CDLL(str(path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_device_round_matches_the_plain_round(lib):
    """The kernel's steps under g++ on blocks of 1, 4 and 256 threads (a
    thread of several pairs; most threads idle), over whole openings at
    L = 2 to 64, random rows and rows of p - 1 (the challenges 1 and
    p - 1 among them): rows, weights and the folded b and x equal
    ipa_round_plain's word for word, and every word is canonical; round 0
    writes the rows alone, and b, x and the weights stay as given."""
    rng = np.random.default_rng(61)
    for L in (2, 4, 8, 16, 32, 64):
        for T in (1, 4, 256):
            for fill in ("random", "p-1"):
                bi, xi = _vectors(rng, L, fill)
                b, x, s, prev = _mont(bi), _mont(xi), _mont([1] * L), None
                for k in range(L.bit_length() - 1):
                    want = ipa.ipa_round_plain(b, x, s, prev)
                    n = want[2].shape[0]
                    got = [np.zeros((2, L + 1, 8), np.int32),
                           np.zeros((L, 8), np.int32),
                           np.zeros((n, 8), np.int32),
                           np.zeros((n, 8), np.int32)]
                    chal = None if prev is None else \
                        _ptr(FR.pack_mont_host(prev))
                    lib.h_ipa_round(
                        _ptr(b.numpy()), _ptr(x.numpy()), _ptr(s.numpy()),
                        _ptr(got[1]), chal, _ptr(got[2]), _ptr(got[3]),
                        _ptr(got[0]), ctypes.c_longlong(L),
                        ctypes.c_longlong(n), T)
                    if prev is None:
                        assert not any(g.any() for g in got[1:])
                        got[1:] = s.numpy(), b.numpy(), x.numpy()
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w.numpy())
                    assert max(FR.int_host(w) for w in
                               got[0].reshape(-1, 8)) < FR_P
                    rows, s, b, x = (torch.from_numpy(g) for g in got)
                    c = (1 if k == 0 else FR_P - 1) if fill == "p-1" \
                        else _draw(rng)
                    prev = (c, pow(c, -1, FR_P))


def test_wrapper_checks_and_the_opening_makes_no_other_fr_op(monkeypatch):
    """On CPU tensors ipa_round is its plain version (one PLAIN_CALLS
    count a call) and raises on operands the kernel does not take (types,
    shapes, no fold from 2 words), but not above the kernel's 2^16
    generators, a limit of its one block alone; ipa_prove
    at L = 16 calls it once a round and makes no FR.dot_mont,
    FR.lincomb2_scalar or FR.mul call outside it."""
    rng = np.random.default_rng(62)
    L = 16
    b, x = _mont([_draw(rng) for _ in range(L)]), \
        _mont([_draw(rng) for _ in range(L)])
    s = FR.const(1, "cpu").expand(L, FR.n).contiguous()
    curve.reset_launches()
    prev = (5, pow(5, -1, FR_P))
    for got, want in zip(ipa.ipa_round(b, x, s, prev),
                         ipa.ipa_round_plain(b, x, s, prev)):
        assert torch.equal(got, want)
    assert curve.PLAIN_CALLS["ipa_round"] == 2
    bad = [(b.long(), x, s, None), (b, x[:8], s, None),
           (b[:3], x[:3], s, None), (b[:2], x[:2], s, prev),
           (b, x, s[:8], None)]
    for args in bad:
        with pytest.raises(ValueError):
            ipa.ipa_round(*args)
    wide = FR.const(1, "cpu").expand(1 << 17, FR.n)
    rows = ipa.ipa_round(b[:4], x[:4], wide, None)[0]
    assert rows.shape == (2, (1 << 17) + 1, FR.n)
    assert torch.equal(rows[:, 4:8], rows[:, :4])

    gens = torch.from_numpy(curve.affine_pack(
        [curve.py_mul(G, _draw(rng)) for _ in range(L)]))
    Q = torch.from_numpy(curve.affine_pack([curve.py_mul(G, 7)])[0])
    counts, inside = {"round": 0, "outside": 0}, [False]
    real_round = ipa.ipa_round

    def counted_round(*args):
        counts["round"] += 1
        inside[0] = True
        try:
            return real_round(*args)
        finally:
            inside[0] = False

    def outside(name):
        real = getattr(FR, name)

        def run(*args, **kw):
            counts["outside"] += not inside[0]
            return real(*args, **kw)
        return run

    monkeypatch.setattr(ipa, "ipa_round", counted_round)
    for name in ("dot_mont", "lincomb2_scalar", "mul"):
        monkeypatch.setattr(FR, name, outside(name))
    proof = ipa.ipa_prove(b, x, FixedBaseMSM(gens), Q, 0, Tape(b"once"))
    assert counts == {"round": 4, "outside": 0} and len(proof.Ls) == 4
