"""zkcnn_tpu_torch field arithmetic and conversions against Python-int
oracles.

Exact equality throughout: field values are integers and canonical
residues are unique.  Inputs come from np.random.default_rng(seed).
"""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field.ops import SIGNED_FR, bits_to_mont

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

P = FR_P


def _rand_ints(rng, n):
    out = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    out[:3] = [0, 1, P - 1][:n]
    return out


def _t(xs):
    return torch.from_numpy(FR.pack_mont_host(xs))


def _u(t):
    return FR.unpack_mont_host(t.numpy())


def test_arithmetic_matches_python():
    rng = np.random.default_rng(1)
    xs, ys = _rand_ints(rng, 40), _rand_ints(rng, 40)[::-1]
    X, Y = _t(xs), _t(ys)
    for f, ref in ((FR.add, lambda a, b: (a + b) % P),
                   (FR.sub, lambda a, b: (a - b) % P),
                   (FR.mul, lambda a, b: a * b % P)):
        assert _u(f(X, Y)) == [ref(a, b) for a, b in zip(xs, ys)], f
    rx, ry = 123456789 ** 5 % P, P - 7
    assert _u(FR.neg(X)) == [(-a) % P for a in xs]
    assert _u(FR.mul_scalar(X, FR.const(rx, "cpu"))) == \
        [a * rx % P for a in xs]
    assert _u(FR.lincomb2_scalar(X, Y, FR.const(rx, "cpu"),
                                 FR.const(ry, "cpu"))) == \
        [(a * rx + b * ry) % P for a, b in zip(xs, ys)]


def test_sum_and_dot_match_python():
    rng = np.random.default_rng(3)
    xs, ys = _rand_ints(rng, 100), _rand_ints(rng, 100)
    X, Y = _t(xs), _t(ys)
    assert _u(FR.sum(X)) == [sum(xs) % P]
    assert _u(FR.dot_mont(X, Y)) == [sum(a * b for a, b in zip(xs, ys)) % P]
    # other axis and a small chunk size exercise the chunked contraction
    X3, Y3 = X.reshape(10, 10, 8), Y.reshape(10, 10, 8)
    old = FR.DOT_CHUNK_ELEMS
    try:
        FR.DOT_CHUNK_ELEMS = 16
        got = _u(FR.dot_mont(X3, Y3, axis=0))
    finally:
        FR.DOT_CHUNK_ELEMS = old
    want = [sum(xs[i * 10 + j] * ys[i * 10 + j] for i in range(10)) % P
            for j in range(10)]
    assert got == want


def test_conversions_and_signed_view_match_python():
    v = np.array([0, 1, -1, 2 ** 62, -(2 ** 62), 123456789012345, -5],
                 np.int64)
    assert _u(FR.from_int64(v, "cpu")) == [int(x) % P for x in v]
    big = np.array([2 ** 300 + 5, -7, P + 3, 0], object)
    W = FR.from_bigint(big, "cpu")
    assert _u(W) == [int(x) % P for x in big]
    assert list(FR.to_int_host(W)) == [int(x) % P for x in big]
    assert list(FR.to_signed_host(FR.from_int64(v, "cpu"))) == [
        int(x) for x in v]

    s = np.array([0, 5, -5, 2 ** 40 + 3, -(2 ** 50)], np.int64)
    neg, hi, lo = SIGNED_FR.to_hilo(FR.from_int64(s, "cpu"))
    got = [(-1 if n else 1) * ((int(h) << 32) | int(l))
           for n, h, l in zip(neg.tolist(), hi.tolist(), lo.tolist())]
    assert got == [int(x) for x in s]
    assert _u(bits_to_mont(torch.tensor([0, 1, 1, 0]))) == [0, 1, 1, 0]
