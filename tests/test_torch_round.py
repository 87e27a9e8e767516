"""The one-round entries of the sumcheck round kernels (the per-round
path's "fold, then round") in their plain versions against the JAX
package's XLA reference (never the Pallas kernels in interpret mode),
and -- on a CUDA device only -- each CUDA kernel against its plain
version.

T1 (pallas_round2._round2_kernel) and T3 (pallas_round._round_kernel)
compute fold + coeffs_quadratic_dots; T2 (pallas_round._cubic_kernel)
computes fold + engine._cubic_terms.  Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.mle import fold as j_fold, coeffs_quadratic_dots as j_dots
from zkcnn_tpu.gkr.engine import _cubic_terms as j_cubic_terms
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field import round_kernels as rk
from zkcnn_tpu_torch.interop import limbs16_to_words, vals_from_jax


def _rand_mont(rng, m, fill="random"):
    """The same residues, random or all p - 1, as JAX limbs and as port
    words."""
    xs = [FR_P - 1] * m if fill == "p-1" else \
        [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(m)]
    J = jnp.asarray(JFR.pack_mont_host(xs))
    return J, vals_from_jax([J])[0]


def _w(j):
    return limbs16_to_words(np.asarray(j))


@pytest.mark.parametrize("fill", ["random", "p-1"])
def test_round_step_plain_matches_xla(fill):
    """The one-round step of the per-round path, fold_round: without a
    challenge (round 1) the pair dots of A and V as given, with one the
    JAX fold of both followed by the dots of the folded rows; 2 to 2^10
    rows in the round, on random rows and on rows of p - 1."""
    r = 98765432123456789 % FR_P
    rp = jnp.asarray(JFR.to_mont_host(r))
    for m, r_prev in ((2, None), (6, None), (1024, None), (4, r), (12, r),
                      (1024, r), (2048, r)):
        rng = np.random.default_rng(m)
        JA, A = _rand_mont(rng, m, fill)
        JV, V = _rand_mont(rng, m, fill)
        dots, A2, V2 = rk.fold_round_plain(A, V, r_prev)
        if r_prev is not None:
            JA, JV = j_fold(JA, rp), j_fold(JV, rp)
        np.testing.assert_array_equal(dots.numpy(), _w(j_dots(JA, JV)))
        np.testing.assert_array_equal(A2.numpy(), _w(JA))
        np.testing.assert_array_equal(V2.numpy(), _w(JV))


@pytest.mark.parametrize("fill", ["random", "p-1"])
def test_cubic_round_step_plain_matches_xla(fill):
    """fold_cubic_round: M < K (m indexed modulo M/2) and M = K, without
    and with a challenge; M = 2 folding to one row and M = 1, where c3 = 0
    and c0..c2 are m'[0] times the quadratic coefficients of (V1', V0')
    (zkcnn_tpu/gkr/engine.py DotProdPhase1.round_poly); a round on 2^10
    rows; random rows and rows of p - 1.  Each new (M, K) costs the JAX
    package a compile of `_cubic_terms`, so the wide round has one."""
    r = 1234567890987654321 % FR_P
    rp = jnp.asarray(JFR.to_mont_host(r))
    for K, M, r_prev in ((8, 4, None), (8, 8, None), (16, 8, r), (8, 2, r),
                         (8, 1, r), (4, 2, r), (1024, 32, None),
                         (2048, 64, r)):
        rng = np.random.default_rng(K * 100 + M)
        Jm, m = _rand_mont(rng, M, fill)
        JV0, V0 = _rand_mont(rng, K, fill)
        JV1, V1 = _rand_mont(rng, K, fill)
        c, mf, V0f, V1f = rk.fold_cubic_round_plain(m, V0, V1, r_prev)
        if r_prev is not None:
            if M > 1:
                Jm = j_fold(Jm, rp)
            JV0, JV1 = j_fold(JV0, rp), j_fold(JV1, rp)
        if Jm.shape[0] > 1:
            want = np.stack([_w(x) for x in j_cubic_terms(Jm, JV1, JV0)])
        else:
            m0 = FR.unpack_mont_host(_w(Jm))[0]
            d = FR.unpack_mont_host(_w(j_dots(JV1, JV0)))
            want = FR.pack_mont_host([m0 * q % FR_P for q in (
                d[0], d[1] + d[2] - 2 * d[0],
                d[3] - d[1] - d[2] + d[0])] + [0])
        np.testing.assert_array_equal(c.numpy(), want)
        np.testing.assert_array_equal(mf.numpy(), _w(Jm))
        np.testing.assert_array_equal(V0f.numpy(), _w(JV0))
        np.testing.assert_array_equal(V1f.numpy(), _w(JV1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_round_kernels_match_plain_on_cuda(cuda_device):
    """The fold and the one-round entries (fold_round, fold_cubic_round,
    with and without a challenge) against their plain versions on the
    same card tensors, at edge sizes: one pair, an odd pair count (also
    past a block), several blocks, the lazy dots from 2^18 rows, M = 2
    folding to one row and M = 1."""
    r = 98765432123456789 % FR_P

    def operands(m):
        rng = np.random.default_rng(m)
        A = torch.from_numpy(FR.pack_mont_host(
            [int.from_bytes(rng.bytes(31), "little") % FR_P
             for _ in range(3 * m)])).to(cuda_device)
        return A[:m], A[m:2 * m], A[2 * m:]

    for m in (2, 4, 6, 1024, 1554, 1 << 19):
        a, v, _ = operands(m)
        assert torch.equal(rk.fold(a, r), rk.fold_plain(a, r)), m
        for got, want in zip(rk.fold_round(a, v, None),
                             rk.fold_round_plain(a, v, None)):
            assert torch.equal(got, want), m
    # a fold, then a round, needs a row count that is a multiple of 4
    for m in (4, 12, 1024, 1 << 19):
        a, v, w = operands(m)
        for r_prev in (None, r):
            for got, want in zip(rk.fold_round(a, v, r_prev),
                                 rk.fold_round_plain(a, v, r_prev)):
                assert torch.equal(got, want), m
            for M in (1, 2, 4, m):
                args = (w[:M].contiguous(), v, w, r_prev)
                for got, want in zip(rk.fold_cubic_round(*args),
                                     rk.fold_cubic_round_plain(*args)):
                    assert torch.equal(got, want), (m, M)
