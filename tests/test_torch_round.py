"""The sumcheck round kernels' plain versions against the JAX package's
XLA reference (never the Pallas kernels in interpret mode), and -- on a
CUDA device only -- each CUDA kernel against its plain version.

T1 (pallas_round2._round2_kernel) and T3 (pallas_round._round_kernel)
compute coeffs_quadratic_dots + fold; T2 (pallas_round._cubic_kernel)
computes engine._cubic_terms + fold.  Exact equality throughout.
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


def _rand_mont(rng, m):
    """The same residues as JAX limbs and as port words."""
    xs = [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(m)]
    J = jnp.asarray(JFR.pack_mont_host(xs))
    return J, vals_from_jax([J])[0]


def _w(j):
    return limbs16_to_words(np.asarray(j))


def test_round_step_plain_matches_xla():
    r = 98765432123456789 % FR_P
    rp = jnp.asarray(JFR.to_mont_host(r))
    for m in (2, 4, 6, 1024):
        rng = np.random.default_rng(m)
        JA, A = _rand_mont(rng, m)
        JV, V = _rand_mont(rng, m)
        dots, A2, V2 = rk.round_step_plain(A, V, r)
        np.testing.assert_array_equal(dots.numpy(), _w(j_dots(JA, JV)))
        np.testing.assert_array_equal(A2.numpy(), _w(j_fold(JA, rp)))
        np.testing.assert_array_equal(V2.numpy(), _w(j_fold(JV, rp)))


def test_cubic_round_step_plain_matches_xla():
    """M < K (m indexed modulo M/2) and M = K."""
    r = 1234567890987654321 % FR_P
    rp = jnp.asarray(JFR.to_mont_host(r))
    for K, M in ((8, 4), (8, 8)):
        rng = np.random.default_rng(K * 100 + M)
        Jm, m = _rand_mont(rng, M)
        JV0, V0 = _rand_mont(rng, K)
        JV1, V1 = _rand_mont(rng, K)
        c, V0f, V1f = rk.cubic_round_step_plain(m, V0, V1, r)
        want = np.stack([_w(x) for x in j_cubic_terms(Jm, JV1, JV0)])
        np.testing.assert_array_equal(c.numpy(), want)
        np.testing.assert_array_equal(V0f.numpy(), _w(j_fold(JV0, rp)))
        np.testing.assert_array_equal(V1f.numpy(), _w(j_fold(JV1, rp)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_round_kernels_match_plain_on_cuda(cuda_device):
    """K1, its fold-only variant and K2 against their plain versions on
    the same card tensors (the analogue of test_pallas_round.py::
    test_round_step_matches_xla at m = 1024, plus edge sizes)."""
    r = 98765432123456789 % FR_P
    for m in (2, 4, 6, 1024, 1554):
        rng = np.random.default_rng(m)
        A = torch.from_numpy(FR.pack_mont_host(
            [int.from_bytes(rng.bytes(31), "little") % FR_P
             for _ in range(3 * m)])).to(cuda_device)
        a, v, w = A[:m], A[m:2 * m], A[2 * m:]
        for got, want in zip(rk.round_step(a, v, r),
                             rk.round_step_plain(a, v, r)):
            assert torch.equal(got, want), m
        assert torch.equal(rk.fold(a, r), rk.fold_plain(a, r)), m
        M = 2 if m % 4 else min(m, 4)
        for got, want in zip(rk.cubic_round_step(w[:M], v, w, r),
                             rk.cubic_round_step_plain(w[:M], v, w, r)):
            assert torch.equal(got, want), m
