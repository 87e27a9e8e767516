"""The lane-group arithmetic of zkcnn_tpu_torch's fixed-base table
(csrc/g1_arith.cuh: lane_mul, table_chain_lanes) built for the host with
g++, where a lane value is an array over the 32 lanes of a warp and a
shuffle a gather from it, so the kernels' own code runs in lock step: the
lane product word for word against the one-thread product `fp_mul` (its
portable loop) and Python integers, and the lane chain, then the
one-thread digits (`table_step`), word for word against the one-thread
`table_build`, at the lane split the kernels take.  And `curve.base_mul`
on the CPU.

Tolerance 0.  Inputs come from np.random.default_rng(seed).  The g++
tests skip where there is no g++.
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

G = (curve.G1_X, curve.G1_Y)
# lanes a product and products at once of the chain kernel
# (csrc/g1_kernels.cu: TABLE_LANES, TABLE_GROUPS)
S, K = 6, 3

_HARNESS = r"""
#define ZK_DEV
#define ZK_DEV_NOINLINE
#define ZK_CONST static const
#include "g1_arith.cuh"
using namespace g1;

static LI lanes() {
  LI l;
  for (int k = 0; k < WARP; ++k) l.v[k] = k;
  return l;
}

extern "C" {
void h_fp_mul(u32* out, const u32* a, const u32* b, long long n) {
  for (long long i = 0; i < n; ++i)
    fp_mul(out + i * NP, a + i * NP, b + i * NP);
}
void h_fp_mul_lanes(u32* out, const u32* a, const u32* b, long long n) {
  for (long long w = 0; w * (WARP / S) < n; ++w)
    fp_mul_lanes<S>(out, a, b, n, 0, w, lanes());
}
void h_table(u32* tab, const u32* p, int nwin) {
  Pt a;
  pt_load(&a, p);
  table_build(tab, &a, nwin);
}
void h_chain_lanes(u32* tab, const u32* pts, long long N, int nwin) {
  for (long long w = 0; w * (WARP / (S * K)) < N; ++w)
    table_chain_lanes<S, K>(tab, pts, N, nwin, w, lanes());
}
// the three rounds of the digits, a thread an addition
void h_digits(u32* tab, long long pairs) {
  for (int m = 2; m < WTAB; m *= 2)
    for (long long a = 0; a < pairs * (m - 1); ++a)
      table_step(tab + a / (m - 1) * WTAB * PW, m, (int)(a % (m - 1)) + 1);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA arithmetic for the host")
    csrc = pathlib.Path(curve.__file__).resolve().parents[1] / "csrc"
    tmp = tmp_path_factory.mktemp("g1lanes")
    src = tmp / "harness.cpp"
    src.write_text(f"constexpr int S = {S}, K = {K};\n" + _HARNESS)
    path = tmp / "libg1lanes.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-o", str(path),
                    str(src)], check=True)
    return ctypes.CDLL(str(path))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(vals):
    return np.stack([FP.words_host(v) for v in vals]).astype(np.uint32)


def _needs_final_subtraction(x, y):
    r = 1 << 384
    m = x * y * (-pow(FP_P, -1, r)) % r
    return (x * y + m * FP_P) >> 384 >= FP_P


def test_lane_product_matches_fp_mul_and_python_ints(lib):
    """At S lanes a product: every pair of 0, 1, 2, p - 1,
    p - 2, R mod p and words of 0xffffffff below p; 64 pairs whose sum
    ends at or above p (the final subtraction); 10^4 random pairs."""
    rng = np.random.default_rng(41)
    rand = lambda: int.from_bytes(rng.bytes(48), "little") % FP_P  # noqa
    top = FP_P >> 352
    edge = [0, 1, 2, FP_P - 1, FP_P - 2, (1 << 384) % FP_P,
            (top << 352) - 1, (1 << 352) - 1]
    xs = [a for a in edge for _ in edge]
    ys = edge * len(edge)
    sub = 0
    while sub < 64:
        x, y = rand(), rand()
        if _needs_final_subtraction(x, y):
            xs.append(x)
            ys.append(y)
            sub += 1
    xs += [rand() for _ in range(10000)]
    ys += [rand() for _ in range(10000)]
    a, b = _words(xs), _words(ys)
    n = len(xs)
    rinv = pow(1 << 384, -1, FP_P)
    want = _words([x * y * rinv % FP_P for x, y in zip(xs, ys)])
    one = np.zeros_like(a)
    lib.h_fp_mul(_ptr(one), _ptr(a), _ptr(b), ctypes.c_longlong(n))
    np.testing.assert_array_equal(one, want)
    out = np.zeros_like(a)
    lib.h_fp_mul_lanes(_ptr(out), _ptr(a), _ptr(b), ctypes.c_longlong(n))
    np.testing.assert_array_equal(out, want, err_msg=f"{S} lanes")


def _jacobian(rng, P):
    if P is None:
        return np.zeros((3, 12), np.int32)
    z = int.from_bytes(rng.bytes(40), "little") % FP_P or 1
    return curve.point_pack((P[0] * z * z % FP_P, P[1] * z ** 3 % FP_P, z))


def test_lane_chain_and_digits_match_table_build(lib):
    """One base, and three: a random multiple of G, infinity and (0, 2),
    a point of order 3 off the subgroup, whose digits meet p + p and
    p + (-p); at 1, 2 and 64 windows.  The lane chain (its entries alone,
    the others left 0), then the digits, word for word against
    table_build."""
    rng = np.random.default_rng(42)
    sets = [[curve.py_mul(G, int(rng.integers(1, 1 << 62)))],
            [curve.py_mul(G, int(rng.integers(1, 1 << 62))), None, (0, 2)]]
    for bases in sets:
        pts = np.stack([_jacobian(rng, P) for P in bases])
        N = len(bases)
        for nwin in (1, 2, curve.NWIN):
            want = np.zeros((N, nwin, curve.WTAB, 3, 12), np.int32)
            for i in range(N):
                lib.h_table(_ptr(want[i]), _ptr(np.ascontiguousarray(pts[i])),
                            nwin)
            got = np.zeros_like(want)
            lib.h_chain_lanes(_ptr(got), _ptr(pts), ctypes.c_longlong(N),
                              nwin)
            chain = [(1 << s) - 1 for s in range(curve.WBITS)]
            np.testing.assert_array_equal(
                got[:, :, chain], want[:, :, chain],
                err_msg=f"chain, N={N}, nwin={nwin}")
            others = [d for d in range(curve.WTAB) if d not in chain]
            assert not got[:, :, others].any()
            lib.h_digits(_ptr(got), ctypes.c_longlong(N * nwin))
            np.testing.assert_array_equal(
                got, want, err_msg=f"N={N}, nwin={nwin}")


def test_base_mul_on_the_cpu_matches_py_mul():
    """`base_mul` (the tape's generator draws) on CPU tensors: k G in
    Python integers, no table built and nothing launched."""
    curve.reset_launches()
    ks = [0, 1, 2, FR_P - 1, (1 << 254) | 5, 12345678901234567890]
    plain = torch.from_numpy(np.stack([FR.words_host(k) for k in ks]))
    got = curve.base_mul(plain.reshape(2, 3, FR.n))
    assert got.shape == (2, 3, 3, 12)
    assert curve.to_affine_host(got) == [curve.py_mul(G, k) for k in ks]
    assert curve.to_affine_host(curve.base_mul(plain[3:4], 16)) == [
        curve.py_mul(G, (FR_P - 1) & 0xFFFF)]
    assert not curve.BASE_TABLES and not any(curve.LAUNCHES.values())
