"""Sumcheck phase engines (counterpart of `zkcnn_tpu/gkr/engine.py`):
the reference's lazy linear_poly halving arrays (src/prover.cpp:360-426
and the DOT_PROD cubic variant at src/prover.cpp:103-144).

A phase holds up to two (mult, V) operand sides padded to their
power-of-two hypercube.  The seeded tape makes every challenge known
before its round, so one round is ONE call of a round kernel
(field/round_kernels.py) that returns the round message's dots and the
folded operands together; the message's coefficients are formed on the
host from the fetched dots.

Exhaustion semantics mirror the reference exactly: a side with 2^k
entries contributes pair-product quadratics for rounds 1..k; at round
k+1 its folded scalar product moves into `add_term`, which from then on
contributes add_term*(1-x) and decays by (1-r) per round
(prover.cpp:375-378,400-404).
"""

from typing import List, Optional

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.round_kernels import round_step, cubic_round_step, fold
from ..mle.fold import coeffs_from_dots


def _host(x) -> int:
    return FR.from_mont_host(np.asarray(x.cpu()))


class Side:
    """One (mult, V) operand pair over a 2^nb hypercube."""

    def __init__(self, A, V, nb: int):
        m = 1 << nb
        assert A.shape[0] == V.shape[0]
        if A.shape[0] < m:
            pad = FR.zeros(m - A.shape[0], A.device)
            A, V = torch.cat([A, pad]), torch.cat([V, pad])
        self.A, self.V = A[:m].contiguous(), V[:m].contiguous()
        self.nb = nb
        self.folds = 0
        self.collapsed = False

    @property
    def active(self):
        return self.folds < self.nb

    def final_V(self) -> int:
        return _host(self.V[0])

    def final_A(self) -> int:
        return _host(self.A[0])

    def final_V_dev(self):
        return self.V[0]


class PhaseEngine:
    """Drives one sumcheck phase (phase 1, phase 2, or the Liu input
    consolidation when include_add_term=False)."""

    def __init__(self, sides: List[Optional[Side]], add_term=0,
                 include_add_term: bool = True):
        self.sides = sides
        # add_term arrives as a host int or as an [8] Montgomery tensor
        self.add_term = add_term % FR_P if isinstance(add_term, int) \
            else _host(add_term)
        self.include_add_term = include_add_term

    def step(self, r: int):
        """One round: the quadratic (c0, c1, c2) as host ints, then the
        fold of every active side at r (one round-kernel call each)."""
        c0 = c1 = c2 = 0
        for s in self.sides:
            if s is None:
                continue
            if s.nb == s.folds and not s.collapsed:
                # side exhausted: its scalar product joins add_term
                # (reference prover.cpp:400-404)
                self.add_term = (self.add_term
                                 + s.final_A() * s.final_V()) % FR_P
                s.collapsed = True
            if s.active:
                dots, s.A, s.V = round_step(s.A, s.V, r)
                s.folds += 1
                q0, q1, q2 = coeffs_from_dots(dots)
                c0 = (c0 + q0) % FR_P
                c1 = (c1 + q1) % FR_P
                c2 = (c2 + q2) % FR_P
        if self.include_add_term:
            # + add_term * (1 - x)   (reference prover.cpp:378)
            c0 = (c0 + self.add_term) % FR_P
            c1 = (c1 - self.add_term) % FR_P
            self.add_term = self.add_term * (1 - r) % FR_P
        return c0, c1, c2

    def run_all(self, rs):
        """All rounds at the known challenges rs; returns the round
        polys as a list of host-int 3-tuples."""
        return [self.step(r) for r in rs]

    def final_claim_dev(self, b: int, bit_length: int):
        """Finalize semantics (reference prover.cpp:459-485): the folded
        value of side b as an [8] tensor, 0 when the side is absent."""
        s = self.sides[b]
        if s is None or bit_length < 0:
            dev = next(x.A.device for x in self.sides if x is not None)
            return FR.zeros(1, dev)[0]
        return s.final_V_dev()


class DotProdPhase1:
    """Cubic phase-1 engine for DOT_PROD layers (reference
    sumcheckDotProdInitPhase1/Update1/Finalize1, prover.cpp:57-153).

    The fft-variable factor `m` (a beta table over the fft bits) folds
    alongside the two V operands for the first fft_bl rounds, then
    persists as a scalar multiplier."""

    def __init__(self, m, V0, V1, fft_bl: int, nb1: int):
        self.m = m.contiguous()
        self.V0, self.V1 = V0.contiguous(), V1.contiguous()
        self.fft_bl = fft_bl
        self.nb1 = nb1
        self.folds = 0

    def step(self, r: int):
        """One round: (c0, c1, c2, c3) host ints, then the folds at r."""
        if self.m.shape[0] > 1:
            c, self.V0, self.V1 = cubic_round_step(self.m, self.V0,
                                                   self.V1, r)
            self.m = fold(self.m, r)
            poly = tuple(FR.unpack_mont_host(np.asarray(c.cpu())))
        else:
            m0 = _host(self.m[0])
            dots, self.V1, self.V0 = round_step(self.V1, self.V0, r)
            q = coeffs_from_dots(dots)
            poly = tuple(m0 * qi % FR_P for qi in q) + (0,)
        self.folds += 1
        return poly

    def run_all(self, rs):
        return [self.step(r) for r in rs]

    def finalize_dev(self):
        """-> (claim_1 [8], V_u1 [8]) (reference prover.cpp:146-153)."""
        return self.V1[0], FR.mul(self.V1[0], self.m[0])
