"""The port's `FiatShamirTape` on the CPU against the JAX package's,
tolerance 0 (tape states are bytes): the same draws and states for the
same absorbs, clones included.  The plain versions of the one-round
entries `fold_round` and `fold_cubic_round` are held against the JAX
package in tests/test_torch_round.py.
"""

import numpy as np

from zkcnn_tpu.gkr.tape import FiatShamirTape as JFiatShamirTape
from zkcnn_tpu_torch.field import FR_P
from zkcnn_tpu_torch.gkr import FiatShamirTape


def test_fiat_shamir_tape_matches_jax():
    """Absorbs of one and of several values (negative, >= p), draws
    between them, and clones that go on with other absorbs: the same
    draws, states and counters in both packages."""
    rng = np.random.default_rng(7)
    ours, theirs = FiatShamirTape(b"fs"), JFiatShamirTape(b"fs")
    assert ours.state == theirs.state
    pairs = [(ours, theirs)]
    for step in range(40):
        vals = [int.from_bytes(rng.bytes(40), "little") - (1 << 300)
                for _ in range(step % 4 + 1)] + [FR_P, FR_P + 5]
        for a, b in pairs:
            a.absorb(*vals[: step % 3 + 1])
            b.absorb(*vals[: step % 3 + 1])
            assert (a.field(), a.fields(2)) == (b.field(), b.fields(2))
            assert (a.state, a.counter) == (b.state, b.counter)
        if step % 10 == 5:
            ca, cb = ours.clone(), theirs.clone()
            assert isinstance(ca, FiatShamirTape)
            assert (ca.state, ca.counter) == (cb.state, cb.counter)
            ca.absorb(step)
            cb.absorb(step)
            pairs.append((ca, cb))
    assert ours.precomputable is False and ours.interleaved is True
    assert len({a.state for a, _ in pairs}) == len(pairs)
