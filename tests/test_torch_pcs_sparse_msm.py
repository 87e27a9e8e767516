"""The MSM on Z = 1 table entries against Python integers: the CUDA
source's mixed addition (`pt_madd`), the table's normalisation
(`affine_runs` .. `affine_back`: a block's batch inversion) and one warp's
share of a row (`msm_item`: the
term's sign, the compaction of nonzero digits into the warp's queue, a
batch of 32 additions at a time, then the sum of the lanes) built for
the host with g++ (csrc/g1_arith.cuh, where one host thread runs a warp's
32 lanes in lock step), and the plain normalisation (`table_affine_plain`)
on the CPU.

Tolerance 0: points are compared as affine integers, the normalised
tables word for word.  Inputs come from np.random.default_rng(seed).  The
g++ tests skip where there is no g++.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FP, FP_P, FR, FR_P
from zkcnn_tpu_torch.pcs import curve
from zkcnn_tpu_torch.pcs.msm import msm_host, table_affine_plain

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)
ONE = FP.to_mont_host(1)

_HARNESS = r"""
#define ZK_DEV
#define ZK_DEV_NOINLINE
#define ZK_CONST static const
#include "g1_arith.cuh"
using namespace g1;
extern "C" {
void h_table(u32* tab, const u32* p, int nwin) {
  Pt a;
  pt_load(&a, p);
  table_build(tab, &a, nwin);
}
// out = p + q by pt_madd, q a Z = 1 entry [3, 12] (zeros: infinity); and
// by pt_add on the same words.
void h_madd(u32* out, u32* out_add, const u32* p, const u32* q) {
  Pt a, b, r;
  Aff e;
  pt_load(&a, p);
  pt_load(&b, q);
  aff_load(&e, q, false);
  pt_madd(&r, &a, &e);
  pt_store(out, &r);
  pt_add(&r, &a, &b);
  pt_store(out_add, &r);
}
// E entries of tab to Z = 1 as the kernel's blocks of T threads take
// them, a run of `run` entries a thread, the threads of a block looped
// over between its barriers.
void h_table_affine(u32* tab, long long E, int run, int T) {
  static u32 pre[1024][AFF_RUN][NP], node[2048][NP];
  for (long long b0 = 0; b0 < E; b0 += (long long)T * run) {
    int n[1024];
    for (int t = 0; t < T; ++t) {
      const long long e0 = b0 + (long long)t * run;
      n[t] = e0 >= E ? 0 : (int)(E - e0 < run ? E - e0 : run);
      affine_runs(tab, e0, n[t], pre[t], node[T + t]);
    }
    for (int w = T / 2; w >= 1; w /= 2)
      for (int t = 0; t < w; ++t) affine_up(node, w + t);
    fp_inv(node[1], node[1]);
    for (int w = 1; w < T; w *= 2)
      for (int t = 0; t < w; ++t) affine_down(node, w + t);
    for (int t = 0; t < T; ++t)
      affine_back(tab, b0 + (long long)t * run, n[t], pre[t], node[T + t]);
  }
}
// out[r] = sum_i k[r, i] P_i on the Z = 1 table, cut as the kernel cuts
// it: warp items of `tile` terms and `per_win` windows, each summed over
// its lanes by the kernel's shuffle tree, then the items added in order.
void h_msm(u32* out, const u32* tab, const u32* ks, long long R, long long N,
           int nwin, int nbits, int mont, int tile, int per_win) {
  u32 q[QCAP];
  for (long long r = 0; r < R; ++r) {
    Pt row;
    pt_set_inf(&row);
    for (int j0 = 0; j0 < nwin; j0 += per_win)
      for (long long i0 = 0; i0 < N; i0 += tile) {
        Pt acc[WARP];
        const long long i1 = i0 + tile < N ? i0 + tile : N;
        const int j1 = j0 + per_win < nwin ? j0 + per_win : nwin;
        msm_item(acc, q, tab, ks, r, N, i0, i1, j0, j1, nwin, nbits, mont,
                 0);
        for (int off = WARP / 2; off > 0; off >>= 1)
          for (int l = 0; l + off < WARP; ++l)
            pt_add(&acc[l], &acc[l], &acc[l + off]);
        pt_add(&row, &row, &acc[0]);
      }
    pt_store(out + r * PW, &row);
  }
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA arithmetic for the host")
    csrc = pathlib.Path(curve.__file__).resolve().parents[1] / "csrc"
    tmp = tmp_path_factory.mktemp("g1sparse")
    src = tmp / "harness.cpp"
    src.write_text(_HARNESS)
    lib_path = tmp / "libg1sparse.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o",
                    str(lib_path), str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _neg(P):
    return None if P is None else (P[0], (-P[1]) % FP_P)


def _jacobian(rng, P):
    """P with a random Z (zeros for infinity)."""
    if P is None:
        return np.zeros((3, 12), np.int32)
    z = int.from_bytes(rng.bytes(40), "little") % FP_P or 1
    return curve.point_pack((P[0] * z * z % FP_P, P[1] * z ** 3 % FP_P, z))


def _entry(P):
    """P as a Z = 1 table entry (zeros for infinity)."""
    return curve.affine_pack([P])[0]


def _tables(host_lib, pts, nwin):
    """The Jacobian tables of pts [N, 3, 12] over nwin windows."""
    tabs = np.zeros((len(pts), nwin, curve.WTAB, 3, 12), np.int32)
    for i, p in enumerate(pts):
        host_lib.h_table(_ptr(tabs[i]), _ptr(np.ascontiguousarray(p)), nwin)
    return tabs


def test_mixed_addition_on_its_exceptional_cases(host_lib):
    """pt_madd against py_add and word for word against pt_add on (x, y,
    one): equal points (a doubling), negated points (infinity), an
    infinite accumulator (the entry), an infinite entry (the
    accumulator), both infinite, and distinct points; the accumulator
    Jacobian with Z != 1."""
    rng = np.random.default_rng(41)
    P = curve.py_mul(G, int(rng.integers(1, 1 << 62)))
    Q = curve.py_mul(G, int(rng.integers(1, 1 << 62)))
    cases = [(P, P), (P, _neg(P)), (None, Q), (P, None), (None, None),
             (P, Q), (Q, _neg(P)), (G, G)]
    for a, b in cases:
        out = np.zeros((3, 12), np.int32)
        out_add = np.zeros((3, 12), np.int32)
        host_lib.h_madd(_ptr(out), _ptr(out_add), _ptr(_jacobian(rng, a)),
                        _ptr(_entry(b)))
        assert curve.to_affine_host(out) == [curve.py_add(a, b)], (a, b)
        assert np.array_equal(out, out_add), (a, b)


def test_table_normalised_with_an_infinite_and_a_repeated_base(host_lib):
    """The normalisation over the tables of four bases (one repeated, one
    infinite) at 13 windows, as blocks of 1, 4 and 256 threads take them
    in runs of 1, 7 and 32 entries (the last block and run ragged): every
    entry the same group element as before with Z = one, the infinite
    base's entries all zeros, word for word equal at every run length;
    the plain normalisation on the CPU equal to it word for word at 3
    windows."""
    rng = np.random.default_rng(42)
    P = curve.py_mul(G, int(rng.integers(1, 1 << 62)))
    aff = [P, None, P, G]
    jac = _tables(host_lib, np.stack([_jacobian(rng, X) for X in aff]), 13)
    want = curve.to_affine_host(jac)
    E = jac.size // 36
    outs = []
    for run, T in ((1, 4), (7, 1), (32, 4), (1, 256), (7, 256)):
        tab = jac.copy()
        host_lib.h_table_affine(_ptr(tab), E, run, T)
        assert curve.to_affine_host(tab) == want, run
        z = tab[..., 2, :]
        assert (z[1] == 0).all() and (tab[1] == 0).all()
        assert (z[[0, 2, 3]] == ONE).all()
        outs.append(tab)
    assert all(np.array_equal(outs[0], t) for t in outs[1:])
    before = dict(curve.PLAIN_CALLS)
    plain = table_affine_plain(torch.from_numpy(jac[:, :3].copy()))
    assert np.array_equal(plain.numpy(), outs[0][:, :3])
    assert curve.PLAIN_CALLS["g1_table_affine"] == \
        before["g1_table_affine"] + 1
    assert not any(curve.LAUNCHES.values())


def test_sparse_msm_matches_msm_host(host_lib):
    """msm_item over a Z = 1 table at (R, N) = (3, 5) and (4, 17), each
    cut into warp items as the kernel cuts it (tiles of 32 terms, all 64
    windows or ranges of 4 and 8), against msm_host: Montgomery scalars
    0, 1, (r - 1)/2, (r + 1)/2, r - 1, small negative values (r - v) and
    random 255-bit ones, a repeated base and an infinite base; and plain
    scalars cut to 16, 35 and 256 bits (bits 255 and 256 set: no sign
    taken above r) against py_mul."""
    rng = np.random.default_rng(43)
    half = (FR_P - 1) // 2
    edge = [0, 1, half, half + 1, FR_P - 1, FR_P - 5, FR_P - (1 << 20) - 3,
            7 << 40]
    for R, N in ((3, 5), (4, 17)):
        logs = [int(rng.integers(1, 1 << 62)) for _ in range(N)]
        aff = [curve.py_mul(G, s) for s in logs]
        aff[1], aff[3] = aff[0], None                 # repeated, infinite
        tab = _tables(host_lib, np.stack([_jacobian(rng, X) for X in aff]),
                      curve.NWIN)
        host_lib.h_table_affine(_ptr(tab), tab.size // 36, 32, 4)
        ks = [int.from_bytes(rng.bytes(32), "little") % FR_P
              for _ in range(R * N)]
        ks[:len(edge)] = edge
        ks[-len(edge):] = edge[::-1]
        mont = FR.pack_mont_host(ks).reshape(R, N, 8)
        want = curve.to_affine_host(msm_host(
            torch.from_numpy(curve.affine_pack(aff)), torch.from_numpy(mont)))
        for per_win in (64, 8, 4):
            out = np.zeros((R, 3, 12), np.int32)
            host_lib.h_msm(_ptr(out), _ptr(tab), _ptr(mont), R, N,
                           curve.NWIN, 256, 1, 32, per_win)
            assert curve.to_affine_host(out) == want, (R, N, per_win)
        plain = np.stack([FR.words_host(k) for k in ks]).reshape(R, N, 8)
        plain[0, 1] = FR.words_host((3 << 254) | 5)    # above r: no sign
        plain[1, 2] = FR.words_host(FR_P + 9)
        ints = [FR.int_host(w) for w in plain.reshape(-1, 8)]
        for nbits in (16, 35, 256):
            out = np.zeros((R, 3, 12), np.int32)
            host_lib.h_msm(_ptr(out), _ptr(tab), _ptr(plain), R, N,
                           curve.NWIN, nbits, 0, 32, 16)
            rows = []
            for r in range(R):
                acc = None
                for P, k in zip(aff, ints[r * N:(r + 1) * N]):
                    acc = curve.py_add(acc, curve.py_mul(
                        P, k & ((1 << nbits) - 1)))
                rows.append(acc)
            assert curve.to_affine_host(out) == rows, (R, N, nbits)
