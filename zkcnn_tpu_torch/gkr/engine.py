"""Sumcheck phase engines (counterpart of `zkcnn_tpu/gkr/engine.py`):
the reference's lazy linear_poly halving arrays (src/prover.cpp:360-426
and the DOT_PROD cubic variant at src/prover.cpp:103-144).

A phase holds up to two (mult, V) operand sides padded to their
power-of-two hypercube.  The seeded tape makes every challenge of a
phase known before its first round, so `run_all` runs each side as ONE
ladder of the round kernels (field/round_kernels.py) on the device,
fetches the dots of all rounds and sides in one transfer when the
ladders are queued, and forms the round messages on the host.  `step`
runs one round through the one-round kernels and fetches its message at
once, for a caller that learns the next challenge only from it; a loop
of `step` gives what `run_all` gives.

Exhaustion semantics mirror the reference exactly: a side with 2^k
entries contributes pair-product quadratics for rounds 1..k; at round
k+1 its folded scalar product moves into `add_term`, which from then on
contributes add_term*(1-x) and decays by (1-r) per round
(prover.cpp:375-378,400-404).

`FETCHES` counts the device-to-host transfers of the round loops.
"""

from itertools import islice
from typing import List, Optional

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.round_kernels import round_step, cubic_round_step, fold, \
    round_ladder, cubic_ladder
from ..mle.fold import quad_from_dots

FETCHES = {"rounds": 0}


def _host(x) -> int:
    return FR.from_mont_host(np.asarray(x.cpu()))


def _fetch_rows(parts) -> list:
    """Host ints of the rows of the [k, 8] tensors in parts: one
    transfer for all of them."""
    FETCHES["rounds"] += 1
    return FR.unpack_mont_host(np.asarray(torch.cat(parts).cpu()))


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

    def _join(self, s: Side, product: int):
        """Side s is exhausted: its scalar product joins add_term
        (reference prover.cpp:400-404)."""
        self.add_term = (self.add_term + product) % FR_P
        s.collapsed = True

    def _close_round(self, c, r: int):
        """Adds add_term * (1 - x) to the round's sums c (reference
        prover.cpp:378) and decays add_term by (1 - r)."""
        c0, c1, c2 = (x % FR_P for x in c)
        if self.include_add_term:
            c0 = (c0 + self.add_term) % FR_P
            c1 = (c1 - self.add_term) % FR_P
            self.add_term = self.add_term * (1 - r) % FR_P
        return c0, c1, c2

    def step(self, r: int):
        """One round: the quadratic (c0, c1, c2) as host ints, then the
        fold of every active side at r (one round-kernel call and one
        fetch each)."""
        c = [0, 0, 0]
        for s in self.sides:
            if s is None:
                continue
            if s.nb == s.folds and not s.collapsed:
                a, v = _fetch_rows([s.A[:1], s.V[:1]])
                self._join(s, a * v)
            if s.active:
                dots, s.A, s.V = round_step(s.A, s.V, r)
                s.folds += 1
                q = quad_from_dots(*_fetch_rows([dots]))
                c = [x + y for x, y in zip(c, q)]
        return self._close_round(c, r)

    def run_all(self, rs):
        """All rounds at the known challenges rs; returns the round
        polys as a list of host-int 3-tuples.  One ladder per side, one
        fetch for the phase."""
        R = len(rs)
        if R == 0:
            return []
        plan, parts = [], []
        for s in self.sides:
            if s is None or s.collapsed:
                continue
            k = min(s.nb - s.folds, R)
            if k:
                dots, s.A, s.V = round_ladder(s.A, s.V, rs[:k])
                s.folds += k
                parts.append(dots.reshape(4 * k, FR.n))
            if k < R:
                # exhausted within these rounds: its scalars come along
                parts += [s.A[:1], s.V[:1]]
            plan.append((s, k))
        rows = iter(_fetch_rows(parts)) if parts else iter(())
        ran = []
        for s, k in plan:
            quads = [quad_from_dots(*islice(rows, 4)) for _ in range(k)]
            ran.append((s, k, quads,
                        next(rows) * next(rows) if k < R else None))
        polys = []
        for t, r in enumerate(rs):
            c = [0, 0, 0]
            for s, k, quads, product in ran:
                if t == k:
                    self._join(s, product)
                elif t < k:
                    c = [x + y for x, y in zip(c, quads[t])]
            polys.append(self._close_round(c, r))
        return polys

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
            poly = tuple(_fetch_rows([c]))
        else:
            dots, self.V1, self.V0 = round_step(self.V1, self.V0, r)
            m0, *d = _fetch_rows([self.m[:1], dots])
            poly = tuple(m0 * qi % FR_P for qi in quad_from_dots(*d)) + (0,)
        self.folds += 1
        return poly

    def run_all(self, rs):
        """All rounds at the known challenges rs as host-int 4-tuples:
        a cubic ladder while m has more than one row, then a quadratic
        ladder on (V1, V0) scaled by the scalar m; one fetch."""
        R = len(rs)
        if R == 0:
            return []
        M = self.m.shape[0]
        assert M & (M - 1) == 0, M
        kc = min(M.bit_length() - 1, R)
        parts = []
        if kc:
            coeffs, self.m, self.V0, self.V1 = cubic_ladder(
                self.m, self.V0, self.V1, rs[:kc])
            parts.append(coeffs.reshape(4 * kc, FR.n))
        if kc < R:
            dots, self.V1, self.V0 = round_ladder(self.V1, self.V0, rs[kc:])
            parts += [self.m[:1], dots.reshape(4 * (R - kc), FR.n)]
        self.folds += R
        rows = iter(_fetch_rows(parts))
        polys = [tuple(islice(rows, 4)) for _ in range(kc)]
        if kc < R:
            m0 = next(rows)
            for _ in range(R - kc):
                q = quad_from_dots(*islice(rows, 4))
                polys.append(tuple(m0 * qi % FR_P for qi in q) + (0,))
        return polys

    def finalize_dev(self):
        """-> (claim_1 [8], V_u1 [8]) (reference prover.cpp:146-153)."""
        return self.V1[0], FR.mul(self.V1[0], self.m[0])
