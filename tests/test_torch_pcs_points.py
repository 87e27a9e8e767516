"""zkcnn_tpu_torch's point helpers on the CPU against Python integers:
equality and negation of points under any Z, the tree of additions,
the canonical encodings, the JAX limb layout of points, and the
hash-to-curve generators.

Tolerance 0: points are compared as affine integers.  Inputs come from
np.random.default_rng(seed).
"""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR_P, FP_P
from zkcnn_tpu_torch.interop import points_from_jax, points_to_jax
from zkcnn_tpu_torch.pcs import curve
from zkcnn_tpu_torch.pcs.msm import points_equal

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)


def _points(rng, n):
    ks = [int(rng.integers(1, 1 << 60)) for _ in range(n)]
    aff = [curve.py_mul(G, k) for k in ks]
    return ks, aff, torch.from_numpy(curve.affine_pack(aff))


def _rescaled(rng, aff):
    """The same points under another Z."""
    z = int.from_bytes(rng.bytes(40), "little") % FP_P
    return torch.from_numpy(np.stack(
        [curve.point_pack((x * z * z % FP_P, y * z ** 3 % FP_P, z))
         for x, y in aff]))


def test_point_helpers():
    rng = np.random.default_rng(23)
    _, aff, pts = _points(rng, 5)
    # the same points under other Z, infinity, and a different point
    scaled = _rescaled(rng, aff)
    assert bool(points_equal(pts, scaled).all())
    assert not bool(points_equal(pts, pts.roll(1, 0)).any())
    inf = curve.infinity((5,))
    assert bool(points_equal(inf, inf).all())
    assert not bool(points_equal(inf, pts).any())
    neg = curve.pneg(pts)
    assert curve.to_affine_host(neg) == [(x, (-y) % FP_P) for x, y in aff]
    assert curve.to_affine_host(curve.padd(pts, neg)) == [None] * 5
    acc = None
    for P in aff:
        acc = curve.py_add(acc, P)
    assert curve.to_affine_host(curve.tree_sum(pts)) == [acc]
    assert curve.to_affine_host(curve.tree_sum(scaled[:1])) == aff[:1]


def test_encodings_interop_and_hash_to_group():
    rng = np.random.default_rng(24)
    _, aff, pts = _points(rng, 5)
    scaled = _rescaled(rng, aff)
    inf = curve.infinity((2,))
    # encodings do not depend on Z; infinity is one zero byte
    assert curve.encode_points_host(pts) == curve.encode_points_host(scaled)
    assert curve.encode_points_host(inf) == b"\x00\x00"
    # JAX limbs <-> port words
    limbs = points_to_jax(pts)
    assert limbs.shape == (5, 3, 24) and limbs.dtype == np.uint32
    assert int(limbs.max()) < 1 << 16
    np.testing.assert_array_equal(points_from_jax(limbs).numpy(),
                                  pts.numpy())
    x, y = curve.hash_to_group_host(b"zkcnn-hyrax-gen", 0)
    assert (y * y - x * x * x - 4) % FP_P == 0
    assert curve.py_mul((x, y), FR_P) is None       # in the r-torsion
