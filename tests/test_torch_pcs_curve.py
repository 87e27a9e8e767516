"""zkcnn_tpu_torch's scalar multiplication and MSM on the CPU against
Python integers (py_add / py_mul): the plain PyTorch versions that the
CUDA kernels are held against on the card, at small bit lengths, and
the host versions that CPU tensors take, at full size; and py_mul (in
Jacobian coordinates) against the affine double-and-add over py_add.

Tolerance 0: points are compared as affine integers.  Inputs come from
np.random.default_rng(seed).
"""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.pcs import curve
from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM, msm_plain

G = (curve.G1_X, curve.G1_Y)


def _words(ks):
    return torch.from_numpy(np.stack([FR.words_host(k) for k in ks]))


def _points(rng, n):
    ks = [int(rng.integers(1, 1 << 60)) for _ in range(n)]
    aff = [curve.py_mul(G, k) for k in ks]
    return ks, aff, torch.from_numpy(curve.affine_pack(aff))


def test_scalar_mul_plain_and_host_match_py_mul():
    rng = np.random.default_rng(21)
    _, aff, pts = _points(rng, 6)
    small = [0, 1, 3, 0xFFFF, 0x1ABCD, int(rng.integers(1 << 16))]
    before = dict(curve.PLAIN_CALLS)
    got = curve.scalar_mul_plain(pts, _words(small), 16)
    assert curve.to_affine_host(got) == \
        [curve.py_mul(P, k & 0xFFFF) for P, k in zip(aff, small)]
    # one shared point, as the generators are made
    got = curve.scalar_mul_plain(curve.base_point(), _words(small), 16)
    assert curve.to_affine_host(got) == \
        [curve.py_mul(G, k & 0xFFFF) for k in small]
    # CPU tensors through the public function: full-size scalars
    big = [0, 1, FR_P - 1, (1 << 254) | 3,
           int.from_bytes(rng.bytes(31), "little"), FR_P - 12345]
    got = curve.scalar_mul(pts, _words(big))
    assert curve.to_affine_host(got) == \
        [curve.py_mul(P, k) for P, k in zip(aff, big)]
    got = curve.scalar_mul(pts, _words(big[4:5])[0])     # one shared scalar
    assert curve.to_affine_host(got) == [curve.py_mul(P, big[4]) for P in aff]
    assert curve.to_affine_host(curve.scalar_mul(pts, _words(big), 16)) == \
        [curve.py_mul(P, k & 0xFFFF) for P, k in zip(aff, big)]
    assert curve.PLAIN_CALLS["g1_scalar_mul"] == \
        before["g1_scalar_mul"] + 5 and not any(curve.LAUNCHES.values())


def test_fixed_base_msm_matches_python_ints():
    """(R, N) = (2, 5), with a zero scalar, a repeated base and an
    infinite base: the plain version at 32-bit scalars, CPU tensors
    through `compute` at full size."""
    rng = np.random.default_rng(3)
    gen_ks, aff, pts = _points(rng, 5)
    gen_ks[3], aff[3] = gen_ks[1], aff[1]
    gen_ks[4], aff[4] = 0, None
    pts = torch.from_numpy(curve.affine_pack(aff))

    def want(coeffs):
        out = []
        for row in coeffs:
            acc = None
            for P, c in zip(aff, row):
                acc = curve.py_add(acc, curve.py_mul(P, c) if P else None)
            assert acc == curve.py_mul(
                G, sum(c * g for c, g in zip(row, gen_ks)) % FR_P)
            out.append(acc)
        return out

    small = [[int(rng.integers(1 << 32)) for _ in range(5)] for _ in range(2)]
    small[0][2] = 0
    sm = torch.from_numpy(np.stack([FR.pack_mont_host(r) for r in small]))
    assert curve.to_affine_host(msm_plain(pts, sm, 32)) == want(small)
    big = [[int.from_bytes(rng.bytes(31), "little") for _ in range(5)],
           [0, FR_P - 1, 1, FR_P - 2, 7]]
    bm = torch.from_numpy(np.stack([FR.pack_mont_host(r) for r in big]))
    got = FixedBaseMSM(pts).compute(bm)
    assert got.shape == (2, 3, 12)
    assert curve.to_affine_host(got) == want(big)


def _affine_mul(P, k):
    """k P by the affine double-and-add over py_add (an inversion a step)."""
    acc = None
    while k:
        if k & 1:
            acc = curve.py_add(acc, P)
        P = curve.py_add(P, P)
        k >>= 1
    return acc


def test_py_mul_matches_affine_double_and_add():
    """Points in the r-torsion and one outside it (a curve point before
    its cofactor is cleared, as hash_to_group_host meets it); scalars
    that give infinity, that add P to itself or to -P on the way, the
    cofactor, and random ones of 130 and 255 bits."""
    rng = np.random.default_rng(25)
    x = 5
    while pow(x ** 3 + 4, (curve.FP_P - 1) // 2, curve.FP_P) != 1:
        x += 1
    y = pow(x ** 3 + 4, (curve.FP_P + 1) // 4, curve.FP_P)
    pts = [G, curve.py_mul(G, 12345), (x, y)]
    # on G, FR_P's last step adds P to -P and FR_P + 2's adds P to P
    ks = list(range(17)) + [FR_P - 1, FR_P, FR_P + 1, FR_P + 2, 2 * FR_P,
                            curve.G1_COFACTOR] + \
        [int.from_bytes(rng.bytes(n), "little") for n in (17, 32) * 4]
    for P in pts:
        for k in ks:
            assert curve.py_mul(P, k) == _affine_mul(P, k), (P, k)
    assert curve.py_mul(None, 7) is None
    assert curve.py_mul((x, y), FR_P) is not None     # not in the r-torsion
