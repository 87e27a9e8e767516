"""The fixed-base window table of zkcnn_tpu_torch's MSM against Python
integers: the CUDA source's one-thread table construction and table sum
(csrc/g1_arith.cuh) built for the host with g++, and the plain PyTorch
table (`msm_table_plain`) on the CPU.

Tolerance 0: points are compared as affine integers.  Inputs come from
np.random.default_rng(seed).  The g++ tests skip where there is no g++.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FP_P, FR, FR_P
from zkcnn_tpu_torch.pcs import curve
from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM, msm_host, msm_table_plain

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)

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
// out[r] = sum_i k[r, i] P_i from the tables [N, nwin, 15, 3, 12], each
// term's windows in `split` parts summed apart and then added, as the
// kernel's threads take them.
void h_table_msm(u32* out, const u32* tabs, const u32* ks, int R, int N,
                 int nwin, int nbits, int mont, int split) {
  const int per = (nwin + split - 1) / split;
  for (int r = 0; r < R; ++r) {
    Pt acc, part;
    pt_set_inf(&acc);
    for (int i = 0; i < N; ++i) {
      u32 k[NR];
      for (int j = 0; j < NR; ++j) k[j] = ks[(r * N + i) * NR + j];
      if (mont) fr_from_mont(k);
      for (int q = 0; q < split; ++q) {
        pt_set_inf(&part);
        const int j1 = (q + 1) * per < nwin ? (q + 1) * per : nwin;
        table_sum(&part, tabs + (long long)i * nwin * WTAB * PW, k, q * per,
                  j1, nbits);
        pt_add(&acc, &acc, &part);
      }
    }
    pt_store(out + r * PW, &acc);
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
    tmp = tmp_path_factory.mktemp("g1table")
    src = tmp / "harness.cpp"
    src.write_text(_HARNESS)
    lib_path = tmp / "libg1table.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o",
                    str(lib_path), str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_table(tab_affine, P, nwin):
    """[nwin * 15] affine entries: entry (0, 1) = P, entry (j + 1, 1) =
    16 entry (j, 1), entry (j, d) = d entry (j, 1)."""
    col = P
    for j in range(nwin):
        row = tab_affine[j * curve.WTAB:(j + 1) * curve.WTAB]
        acc = None
        for d in range(curve.WTAB):
            acc = curve.py_add(acc, col)
            assert row[d] == acc, (j, d + 1)
        for _ in range(curve.WBITS):
            col = curve.py_add(col, col)


def _jacobian(rng, P):
    """P with a random Z (zeros for infinity)."""
    if P is None:
        return np.zeros((3, 12), np.int32)
    z = int.from_bytes(rng.bytes(40), "little") % FP_P or 1
    return curve.point_pack((P[0] * z * z % FP_P, P[1] * z ** 3 % FP_P, z))


def test_table_built_for_the_host_matches_python_ints(host_lib):
    """table_build (the chain 2^t P, stored as the digits 1, 2, 4, 8, and
    the other digit multiples in rounds m = 2, 4, 8) for three bases, one
    of them infinity, at 64 and at 5 windows."""
    rng = np.random.default_rng(31)
    bases = [curve.py_mul(G, int(rng.integers(1, 1 << 62))), G, None]
    for P in bases:
        pt = _jacobian(rng, P)
        for nwin in (curve.NWIN, 5):
            tab = np.zeros((nwin, curve.WTAB, 3, 12), np.int32)
            host_lib.h_table(_ptr(tab), _ptr(pt), nwin)
            aff = curve.to_affine_host(tab)
            if P is None:
                assert aff == [None] * len(aff)
            else:
                _check_table(aff, P, nwin)


def test_table_msm_built_for_the_host_matches_msm_host(host_lib):
    """The table sum at (R, N) = (3, 5) on 255-bit Montgomery scalars with
    a zero scalar, a repeated base and an infinite base, a term's windows
    in 1, 4 and 64 parts, against msm_host; and on plain scalars cut to
    16, 33, 35, 255 and 256 bits (the shared-point scalar multiplication)
    against py_mul."""
    rng = np.random.default_rng(32)
    R, N, nwin = 3, 5, curve.NWIN
    aff = [curve.py_mul(G, int(rng.integers(1, 1 << 62))) for _ in range(3)]
    aff = [aff[0], aff[0], aff[1], None, aff[2]]       # repeated, infinite
    pts = np.stack([_jacobian(rng, P) for P in aff])
    tabs = np.zeros((N, nwin, curve.WTAB, 3, 12), np.int32)
    for i in range(N):
        host_lib.h_table(_ptr(tabs[i]), _ptr(np.ascontiguousarray(pts[i])),
                         nwin)
    ks = [int.from_bytes(rng.bytes(32), "little") % FR_P
          for _ in range(R * N)]
    ks[0] = 0
    ks[6] = FR_P - 1
    ks[7] = (1 << 254) | 7
    mont = FR.pack_mont_host(ks).reshape(R, N, 8)
    want = curve.to_affine_host(msm_host(torch.from_numpy(pts),
                                         torch.from_numpy(mont)))
    for split in (1, 4, 64):
        out = np.zeros((R, 3, 12), np.int32)
        host_lib.h_table_msm(_ptr(out), _ptr(tabs), _ptr(mont), R, N, nwin,
                             256, 1, split)
        assert curve.to_affine_host(out) == want
    plain = np.stack([FR.words_host(k) for k in ks]).reshape(R, N, 8)
    big = int.from_bytes(rng.bytes(32), "little")    # bits 255, 256 set
    plain[2, 4] = FR.words_host(big | (3 << 254))
    ints = [FR.int_host(w) for w in plain.reshape(-1, 8)]
    for nbits in (16, 33, 35, 255, 256):
        out = np.zeros((R, 3, 12), np.int32)
        host_lib.h_table_msm(_ptr(out), _ptr(tabs), _ptr(plain), R, N, nwin,
                             nbits, 0, 4)
        rows = []
        for r in range(R):
            acc = None
            for P, k in zip(aff, ints[r * N:(r + 1) * N]):
                if P is not None:
                    acc = curve.py_add(acc, curve.py_mul(
                        P, k & ((1 << nbits) - 1)))
            rows.append(acc)
        assert curve.to_affine_host(out) == rows, nbits


def test_msm_table_plain_matches_python_ints():
    """The plain table on the CPU, two bases (one with Z != 1) at 16
    windows (the g++ tests cover 64); CPU tensors build no table in
    FixedBaseMSM and launch nothing."""
    rng = np.random.default_rng(33)
    aff = [curve.py_mul(G, int(rng.integers(1, 1 << 62))), G]
    pts = torch.from_numpy(np.stack([_jacobian(rng, P) for P in aff]))
    before = dict(curve.PLAIN_CALLS)
    tab = msm_table_plain(pts, 16)
    assert tab.shape == (2, 16, curve.WTAB, 3, 12)
    for i, P in enumerate(aff):
        _check_table(curve.to_affine_host(tab[i]), P, 16)
    assert curve.PLAIN_CALLS["g1_msm_table"] == \
        before["g1_msm_table"] + 1
    fixed = FixedBaseMSM(pts)
    assert fixed.table is None
    ks = torch.from_numpy(FR.pack_mont_host([3, FR_P - 2]).reshape(1, 2, 8))
    assert curve.to_affine_host(fixed.compute(ks)) == [curve.py_add(
        curve.py_mul(aff[0], 3), curve.py_mul(aff[1], FR_P - 2))]
    assert not any(curve.LAUNCHES.values())
