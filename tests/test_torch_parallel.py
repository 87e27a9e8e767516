"""zkcnn_tpu_torch.parallel's split functions on the CPU, under meshes of
["cpu"] repeated D = 1, 2, 4 and 8 times: each equals its unsplit
counterpart in the port word for word (the MSM also as a group element)
and Python integers (tolerance 0), as tests/test_parallel.py holds the
JAX package's sharded kernels to its replicated ones.
"""

import numpy as np
import torch

from zkcnn_tpu_torch.circuit.eval import _witness_ntt
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field.round_kernels import quad_dots_plain, fold
from zkcnn_tpu_torch.ntt import ntt, intt
from zkcnn_tpu_torch.parallel import (COUNTS, make_mesh, use_mesh,
                                      sharded_fold_coeffs, sharded_dot,
                                      sharded_segment_sum, sharded_ntt,
                                      stage_sharded_ntt, sharded_msm)
from zkcnn_tpu_torch.pcs import curve
from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM, points_equal

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

MESHES = (1, 2, 4, 8)


def _ints(rng, k):
    return [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(k)]


def _words(xs):
    return torch.from_numpy(FR.pack_mont_host(xs))


def _cpu_mesh(D):
    return make_mesh(D, devices=["cpu"] * D)


def test_sharded_fold_coeffs_and_dot_equal_the_unsplit_port():
    rng = np.random.default_rng(13)
    N = 1 << 8
    a, v = _ints(rng, N), _ints(rng, N)
    A, V = _words(a), _words(v)
    r = _ints(rng, 1)[0]
    want_dots = quad_dots_plain(A, V)
    pairs = [(x, y) for x in (0, 1) for y in (0, 1)]
    assert FR.unpack_mont_host(want_dots.numpy()) == [
        sum(a[2 * i + x] * v[2 * i + y] for i in range(N // 2)) % FR_P
        for x, y in pairs]
    for D in MESHES:
        dots, A2, V2 = sharded_fold_coeffs(_cpu_mesh(D), A, V, r)
        assert torch.equal(dots, want_dots), D
        assert torch.equal(A2, fold(A, r)) and torch.equal(V2, fold(V, r)), D
        assert FR.unpack_mont_host(A2.numpy()) == [
            ((1 - r) * a[2 * i] + r * a[2 * i + 1]) % FR_P
            for i in range(N // 2)], D
        d = sharded_dot(_cpu_mesh(D), A, V)
        assert torch.equal(d, FR.dot_mont(A, V)), D
        assert FR.from_mont_host(d.numpy()) == \
            sum(x * y for x, y in zip(a, v)) % FR_P, D


def test_sharded_ntts_routing_and_segment_sum():
    rng = np.random.default_rng(5)
    for D in MESHES:
        mesh, logD = _cpu_mesh(D), D.bit_length() - 1
        for logn in sorted({max(1, 2 * logD), 2 * logD + 2}):
            x = torch.stack([_words(_ints(rng, 1 << logn)) for _ in range(3)])
            assert torch.equal(stage_sharded_ntt(mesh, x, logn),
                               ntt(x, logn)), (D, logn)
            assert torch.equal(stage_sharded_ntt(mesh, x, logn, True),
                               intt(x, logn)), (D, logn)
        x = torch.stack([_words(_ints(rng, 16)) for _ in range(2 * D)])
        assert torch.equal(sharded_ntt(mesh, x, 4), ntt(x, 4)), D
        assert torch.equal(sharded_ntt(mesh, x, 4, True), intt(x, 4)), D
        # the witness's NTT: a small batch of large transforms takes the
        # stage-sharded NTT (two transposes), a batch of 2D the batched
        # one with its transforms split (one split and one gather)
        logn = max(4, 2 * logD)
        for batch, transposes, splits in ((D, 2, 0), (2 * D, 0, D > 1)):
            x = torch.stack([_words(_ints(rng, 1 << logn))
                             for _ in range(batch)])
            for inverse in (False, True):
                before = dict(COUNTS)
                with use_mesh(mesh):
                    got = _witness_ntt(x, logn, inverse)
                assert torch.equal(got, (intt if inverse else ntt)(x, logn))
                assert [COUNTS[k] - before[k] for k in
                        ("transposes", "splits", "gathers")] == \
                    [transposes, splits, splits], (D, batch, inverse)
        G, S = 1 << 7, 16
        vals, segs = _ints(rng, G), rng.integers(0, S, G)
        out = sharded_segment_sum(mesh, _words(vals), torch.from_numpy(segs),
                                  S)
        want = [0] * S
        for val, s in zip(vals, segs):
            want[s] = (want[s] + val) % FR_P
        assert FR.unpack_mont_host(out.numpy()) == want, D


def test_sharded_msm_equals_the_msm_word_for_word():
    rng = np.random.default_rng(21)
    G = (curve.G1_X, curve.G1_Y)
    # 16 rows split at every D; 3 rows split at none (D does not divide)
    for R, N in ((16, 4), (3, 8)):
        points = torch.from_numpy(curve.affine_pack(
            [curve.py_mul(G, int(s)) for s in rng.integers(1, 1 << 40, N)]))
        scalars = torch.stack([_words(_ints(rng, N)) for _ in range(R)])
        want = FixedBaseMSM(points).compute(scalars)
        for D in MESHES:
            before = COUNTS["splits"]
            got = sharded_msm(_cpu_mesh(D), points, scalars)
            assert COUNTS["splits"] - before == (D > 1 and R % D == 0)
            assert torch.equal(got, want), (R, N, D)
            assert bool(points_equal(got, want).all()), (R, N, D)
            assert curve.to_affine_host(got) == curve.to_affine_host(want)
