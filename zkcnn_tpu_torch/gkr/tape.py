"""Injectable verifier randomness.

The reference draws live CSPRNG randomness at every verifier step
(setByCSPRNG, reference src/verifier.cpp:139,157-160,207,249-253,
275-279), which makes transcripts irreproducible.  We make the tape an
explicit, seeded object so that (a) proofs are replayable in tests,
(b) one-chip and N-chip runs can be diffed bit-for-bit, and (c) a
Fiat-Shamir transcript (`FiatShamirTape`) derives its draws from a
running hash of the absorbed prover messages instead of a counter.
"""

import hashlib

from ..field.params import FR_P


class Tape:
    # Draws are counter-based and independent of absorbed prover
    # messages, so a whole phase's challenges can be drawn before its
    # first round -- this enables the verifier's three-pass path, one
    # ladder a phase.  FiatShamirTape sets this False.
    precomputable = True
    # Whether the verifier must interleave absorb/draw per sumcheck
    # round (draw r_j only AFTER absorbing round poly j).  Required for
    # Fiat-Shamir soundness: challenges drawn before their round
    # message is committed let a malicious prover forge any claim.
    # False here: counter-based draws are absorb-independent, and the
    # reference's interactive draw order (verifier.cpp:156-160) is the
    # transcript-parity contract.
    interleaved = False

    def __init__(self, seed: bytes = b"zkcnn-tpu"):
        self.seed = seed
        self.counter = 0

    def field(self) -> int:
        """One Fr element: SHA-512(seed || ctr) mod p (64 bytes of
        entropy -> bias < 2^-250)."""
        h = hashlib.sha512(self.seed + self.counter.to_bytes(8, "little"))
        self.counter += 1
        return int.from_bytes(h.digest(), "little") % FR_P

    def fields(self, k: int):
        return [self.field() for _ in range(k)]

    def clone(self) -> "Tape":
        """Snapshot for replaying a sub-protocol's challenge sequence
        (prover and verifier must consume identical draws)."""
        t = Tape(self.seed)
        t.counter = self.counter
        return t

    def absorb(self, *values: int):
        """No-op for the plain seeded tape (interactive model, like the
        reference); the Fiat-Shamir tape overrides this."""



class FiatShamirTape(Tape):
    """Non-interactive challenge derivation: every draw depends on all
    prover messages absorbed so far, making the transcript a
    self-contained proof.  The state is a sha512 chain over the absorbed
    values, each as 32 little-endian bytes mod p; a draw hashes the state
    and the counter."""

    precomputable = False
    interleaved = True

    def __init__(self, seed: bytes = b"zkcnn-tpu-fs"):
        super().__init__(seed)
        self.state = hashlib.sha512(seed).digest()

    def absorb(self, *values: int):
        h = hashlib.sha512(self.state)
        for v in values:
            h.update((v % FR_P).to_bytes(32, "little"))
        self.state = h.digest()

    def field(self) -> int:
        h = hashlib.sha512(self.state + self.counter.to_bytes(8, "little"))
        self.counter += 1
        return int.from_bytes(h.digest(), "little") % FR_P

    def clone(self) -> "FiatShamirTape":
        t = FiatShamirTape(self.seed)
        t.counter = self.counter
        t.state = self.state
        return t
