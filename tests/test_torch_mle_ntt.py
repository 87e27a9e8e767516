"""zkcnn_tpu_torch beta / phi tables and the NTT against zkcnn_tpu,
bit for bit, at tiny sizes (inputs from np.random.default_rng)."""

import numpy as np
import torch

import jax.numpy as jnp

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.mle import beta_table as j_beta, \
    beta_table_2pt as j_beta_2pt, phi_table as j_phi
from zkcnn_tpu.ntt import ntt as j_ntt
from zkcnn_tpu_torch.field import FR, FR_P, root_of_unity
from zkcnn_tpu_torch.mle import beta_table, beta_table_2pt, phi_table
from zkcnn_tpu_torch.ntt import ntt, intt
from zkcnn_tpu_torch.interop import limbs16_to_words, vals_from_jax


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % FR_P for _ in range(n)]


def _w(j):
    return limbs16_to_words(np.asarray(j))


def test_beta_tables_match_jax_and_definition():
    rng = np.random.default_rng(11)
    r = _ints(rng, 4)
    init = 987654321
    got = beta_table(r, init, "cpu")
    np.testing.assert_array_equal(got.numpy(), _w(j_beta(r, init)))
    vals = FR.unpack_mont_host(got.numpy())
    for i, v in enumerate(vals):
        want = init
        for k, rk in enumerate(r):
            want = want * (rk if (i >> k) & 1 else 1 - rk) % FR_P
        assert v == want
    assert beta_table([], 5, "cpu").shape == (1, 8)
    assert FR.unpack_mont_host(beta_table(r, 0, "cpu").numpy()) == [0] * 16

    # the two-point table, with the second point absent (beta = 0)
    for beta in (0, 424242):
        rng = np.random.default_rng(12 + beta)
        r0, r1 = _ints(rng, 3), _ints(rng, 3)
        got = beta_table_2pt(r0, r1 if beta else None, 31337, beta,
                             "cpu")
        want = j_beta_2pt(r0, r1 if beta else None, 31337, beta)
        np.testing.assert_array_equal(got.numpy(), _w(want))


def test_phi_table_matches_jax():
    n_bits = 4
    for inverse in (False, True):
        rng = np.random.default_rng(13 + inverse)
        r = _ints(rng, n_bits)
        got = phi_table(r, 777, n_bits, inverse, "cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      _w(j_phi(r, 777, n_bits, inverse)))


def test_ntt_matches_jax_and_inverts():
    rng = np.random.default_rng(14)
    logn = 4
    xs = _ints(rng, 2 * (1 << logn))
    J = jnp.asarray(JFR.pack_mont_host(xs)).reshape(2, 1 << logn, 16)
    X = vals_from_jax([J])[0]
    Y = ntt(X, logn)
    np.testing.assert_array_equal(Y.numpy(), _w(j_ntt(J, logn)))
    assert torch.equal(intt(Y, logn), X)
    # definition: Y[k] = sum_j x[j] w^(jk)
    w = root_of_unity(logn)
    N = 1 << logn
    y0 = FR.unpack_mont_host(Y[0].numpy())
    assert y0 == [sum(xs[j] * pow(w, j * k, FR_P) for j in range(N)) % FR_P
                  for k in range(N)]
