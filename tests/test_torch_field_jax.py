"""zkcnn_tpu_torch field ops and segment sums against zkcnn_tpu's FR,
and the interop round trip between JAX limbs and port words.

Exact equality throughout.  Inputs come from np.random.default_rng(seed).
"""

import numpy as np
import torch

import jax.numpy as jnp

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.field.ops import segment_sum_field as j_segment_sum
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field.ops import segment_sum_field
from zkcnn_tpu_torch.interop import limbs16_to_words, words_to_limbs16, \
    vals_from_jax

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

P = FR_P


def _rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def test_field_ops_match_jax_fr():
    """The same residues through both packages: bit-identical words."""
    rng = np.random.default_rng(5)
    xs, ys = _rand_ints(rng, 32), _rand_ints(rng, 32)
    JA, JB = jnp.asarray(JFR.pack_mont_host(xs)), \
        jnp.asarray(JFR.pack_mont_host(ys))
    A, B = vals_from_jax([JA, JB])
    np.testing.assert_array_equal(
        limbs16_to_words(np.asarray(JFR.mul(JA, JB))), FR.mul(A, B).numpy())
    np.testing.assert_array_equal(
        limbs16_to_words(np.asarray(JFR.dot_mont(JA, JB))),
        FR.dot_mont(A, B).numpy())
    seg = rng.integers(0, 5, 32)
    np.testing.assert_array_equal(
        limbs16_to_words(np.asarray(j_segment_sum(JA, jnp.asarray(seg), 5))),
        segment_sum_field(A, torch.from_numpy(seg), 5).numpy())


def test_segment_sum_matches_python_and_drops_pads():
    rng = np.random.default_rng(4)
    xs = _rand_ints(rng, 64)
    seg = rng.integers(0, 9, 64)
    seg[::7] = 1 << 30                    # JAX-style pad sentinels
    got = FR.unpack_mont_host(segment_sum_field(
        torch.from_numpy(FR.pack_mont_host(xs)), torch.from_numpy(seg),
        9).numpy())
    want = [sum(x for x, s in zip(xs, seg) if s == k) % P for k in range(9)]
    assert got == want


def test_interop_round_trip():
    rng = np.random.default_rng(6)
    limbs = rng.integers(0, 1 << 16, (5, 3, 16)).astype(np.uint32)
    w = limbs16_to_words(limbs)
    assert w.dtype == np.int32 and w.shape == (5, 3, 8)
    np.testing.assert_array_equal(words_to_limbs16(w), limbs)
    np.testing.assert_array_equal(words_to_limbs16(torch.from_numpy(w)),
                                  limbs)
    xs = _rand_ints(rng, 6)
    got = vals_from_jax([JFR.pack_mont_host(xs)])[0]
    assert FR.unpack_mont_host(got.numpy()) == xs
