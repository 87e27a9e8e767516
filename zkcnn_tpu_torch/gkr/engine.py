"""Sumcheck phase engines (counterpart of `zkcnn_tpu/gkr/engine.py`):
the reference's lazy linear_poly halving arrays (src/prover.cpp:360-426
and the DOT_PROD cubic variant at src/prover.cpp:103-144).

A phase holds up to two (mult, V) operand sides padded to their
power-of-two hypercube, and runs one of two ways:

  * `run_all(rs)`: the seeded tape makes every challenge of a phase
    known before its first round, so each side runs as ONE ladder of the
    round kernels (field/round_kernels.py) on the device; the dots of all
    rounds and sides come back in one transfer, and the round messages
    are formed on the host.
  * `round(prev_r)`, then `receive(r_last)`: under Fiat-Shamir the
    challenge r_j is drawn only after round j's message, so round j
    first folds at r_(j-1) (`prev_r`; None in round 1) and then forms
    its message, one `fold_round` / `fold_cubic_round` launch a side and
    one fetch a round; `receive` makes the last fold, at the last
    challenge, for the finalize.  A loop of `round` and `receive` gives
    what `run_all` gives.

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
from ..field.round_kernels import fold, fold_round, fold_cubic_round, \
    round_ladder, cubic_ladder
from ..mle.fold import quad_from_dots

FETCHES = {"rounds": 0}


def _host(x) -> int:
    return FR.from_mont_host(np.asarray(x.cpu()))


def _fetch_ints(tensors) -> list:
    """One device->host transfer of [8] Montgomery tensors -> ints."""
    if not tensors:
        return []
    big = torch.stack([t.reshape(FR.n) for t in tensors]).cpu().numpy()
    return FR.unpack_mont_host(big)


def _fetch_rows(parts) -> list:
    """Host ints of the rows of the [k, 8] tensors in parts: one
    transfer for all of them."""
    FETCHES["rounds"] += 1
    return FR.unpack_mont_host(np.asarray(torch.cat(parts).cpu()))


def _fold_all(r: int, *xs):
    """Each of xs (even row counts) folded at r: one `fold` launch over
    all of them."""
    out = fold(torch.cat(xs), r)
    at, res = 0, []
    for x in xs:
        n = x.shape[0] // 2
        res.append(out[at:at + n])
        at += n
    return res


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
        # add_term arrives as a host int or as an [8] Montgomery tensor,
        # which the first fetch of the phase brings to the host
        self._add_dev = None if isinstance(add_term, int) else add_term
        self.add_term = add_term % FR_P if self._add_dev is None else None
        self.include_add_term = include_add_term

    def _add_host(self) -> int:
        if self.add_term is None:
            self.add_term = _host(self._add_dev)
            self._add_dev = None
        return self.add_term

    def _join(self, s: Side, product: int):
        """Side s is exhausted: its scalar product joins add_term
        (reference prover.cpp:400-404)."""
        self.add_term = (self.add_term + product) % FR_P
        s.collapsed = True

    def _close_round(self, c, r: int):
        """Adds add_term * (1 - x) to the round's sums c (reference
        prover.cpp:378) and decays add_term by (1 - r)."""
        c0, c1, c2 = self._add_x(c)
        if self.include_add_term:
            self.add_term = self.add_term * (1 - r) % FR_P
        return c0, c1, c2

    def _add_x(self, c):
        c0, c1, c2 = (x % FR_P for x in c)
        if self.include_add_term:
            c0 = (c0 + self.add_term) % FR_P
            c1 = (c1 - self.add_term) % FR_P
        return c0, c1, c2

    def round(self, prev_r: Optional[int]):
        """Round j's quadratic (c0, c1, c2) as host ints: every active
        side folded at prev_r (the challenge of round j - 1; None in round
        1), then its pair dots, one `fold_round` launch a side (a side of
        two rows folds to its last row with `fold` and joins add_term);
        one fetch for the round."""
        parts, plan = [], []
        if self.add_term is None:
            parts.append(self._add_dev.reshape(1, FR.n))
        for s in self.sides:
            if s is None or s.collapsed:
                continue
            if prev_r is not None and s.active and s.A.shape[0] == 2:
                s.A, s.V = _fold_all(prev_r, s.A, s.V)
                s.folds += 1
            if s.active:
                dots, s.A, s.V = fold_round(s.A, s.V, prev_r)
                if prev_r is not None:
                    s.folds += 1
                parts.append(dots)
                plan.append((s, 4))
            else:                       # exhausted: its scalars come along
                parts += [s.A[:1], s.V[:1]]
                plan.append((s, 2))
        rows = iter(_fetch_rows(parts)) if parts else iter(())
        if self.add_term is None:
            self.add_term = next(rows)
            self._add_dev = None
        if prev_r is not None and self.include_add_term:
            self.add_term = self.add_term * (1 - prev_r) % FR_P
        c = [0, 0, 0]
        for s, n in plan:
            if n == 2:
                self._join(s, next(rows) * next(rows))
            else:
                q = quad_from_dots(*islice(rows, 4))
                c = [x + y for x, y in zip(c, q)]
        return self._add_x(c)

    def receive(self, r: int):
        """The last fold, at the last challenge r, of every side still
        active (one `fold` launch a side); decays add_term."""
        if self.include_add_term:
            self.add_term = self._add_host() * (1 - r) % FR_P
        for s in self.sides:
            if s is not None and s.active:
                s.A, s.V = _fold_all(r, s.A, s.V)
                s.folds += 1

    def run_all(self, rs):
        """All rounds at the known challenges rs; returns the round
        polys as a list of host-int 3-tuples.  One ladder per side, one
        fetch for the phase."""
        R = len(rs)
        if R == 0:
            return []
        self._add_host()
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

    def round(self, prev_r: Optional[int]):
        """Round j's (c0, c1, c2, c3) as host ints: m (while it has more
        than one row), V0 and V1 folded at prev_r (None in round 1), then
        the cubic coefficients, one `fold_cubic_round` launch and one
        fetch.  Once m has one row the kernel gives m[0] times the
        quadratic form on (V1, V0), with c3 = 0 (reference
        prover.cpp:103-144)."""
        c, self.m, self.V0, self.V1 = fold_cubic_round(
            self.m, self.V0, self.V1, prev_r)
        if prev_r is not None:
            self.folds += 1
        return tuple(_fetch_rows([c]))

    def receive(self, r: int):
        """The last fold, at the last challenge r: m (while it has more
        than one row), V0 and V1 in one `fold` launch."""
        xs = ([self.m] if self.m.shape[0] > 1 else []) + [self.V0, self.V1]
        out = _fold_all(r, *xs)
        if self.m.shape[0] > 1:
            self.m = out.pop(0)
        self.V0, self.V1 = out
        self.folds += 1

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
