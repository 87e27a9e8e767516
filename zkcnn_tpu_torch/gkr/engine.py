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
  * `run_fs(n, state, counter)`: under Fiat-Shamir the challenge r_j
    is drawn only after round j's message, so round j first folds at
    r_(j-1) and then forms its message.  The tape lives on the card for
    the phase (`fold_round_phase` / `fold_cubic_round_phase`): the host
    enqueues the phase's launches without waiting, each round's message
    is absorbed and r_j drawn on the card, the phase ends with the fold
    at the last challenge, and one fetch brings back the messages, the
    challenges and the tape's state and counter after the phase.
  * `round(prev_r)`, then `receive(r_last)`: the same rounds one at a
    time, the JAX package's per-round API: round j folds at `prev_r`
    (None in round 1) and forms its message, one `fold_round` /
    `fold_cubic_round` launch a side and one fetch a round; `receive`
    makes the last fold.  A loop of `round` and `receive` gives what
    `run_all` and `run_fs` give.

Exhaustion semantics mirror the reference exactly: a side with 2^k
entries contributes pair-product quadratics for rounds 1..k; at round
k+1 its folded scalar product moves into `add_term`, which from then on
contributes add_term*(1-x) and decays by (1-r) per round
(prover.cpp:375-378,400-404).

The operands are held as lists of row blocks (`shard_rows`): one block,
the whole operand, without a mesh; under an active mesh
(`parallel/context.py`) a side's A and V, and a DOT_PROD phase's V0 and
V1, are split into D contiguous row blocks, one a shard (too few rows
stay one block).  The pair fold of a round stays inside a block, so
every round kernel runs on each block at its rows and the round's dots
(or cubic coefficients) are summed over the blocks on the host, as
integers mod p, which is the sum the one-device kernel forms; every
shard of a DOT_PROD phase holds all of m, which runs over V's low index
bits.  When split blocks are down to one row (`run_all`) or two
(`round`), the D rows are gathered onto the operand's device and the
last rounds run there.  `run_all` keeps its one fetch a phase.  `run_fs`
needs the whole round sum on the card before each draw, so a phase with
a split operand runs its rounds with `round` and `receive` and the tape
on the host, a fetch a round; the messages, challenges and tape are the
same.  A phase whose operands all stayed whole makes its phase call as
without a mesh (`parallel.COUNTS`: "host_tape_phases",
"device_tape_phases").

`FETCHES` counts the device-to-host transfers of the round loops.
"""

from itertools import islice
from typing import List, Optional

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.round_kernels import fold, fold_round, fold_cubic_round, \
    cubic_ladder, fold_round_phase, fold_cubic_round_phase, \
    read_phase
from ..mle.fold import quad_from_dots
from ..parallel.context import COUNTS as MESH_COUNTS, active_mesh, \
    shard_rows, gather_rows, gather_parts, replicate, _moved
from ..parallel.sharding import ladder_shards
from .tape import FiatShamirTape

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


def _fetch_phase(buf, n: int, k: int):
    """One transfer of a phase buffer -> (state, counter, add_term, rs,
    messages) as host values."""
    FETCHES["rounds"] += 1
    return read_phase(buf.cpu().numpy(), n, k)


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


def _quad_rounds(As, Vs, rs, home):
    """len(rs) quadratic rounds of the row blocks (As, Vs) at the
    challenges rs: one round_ladder a block (`ladder_shards`) while the
    blocks have more than one row; split blocks of one row are gathered
    onto home first and the rest of the rounds run there.  -> (the dots
    as [rows, 8] tensors on home, their groups (blocks, rounds) in order,
    As', Vs')."""
    parts, groups, done = [], [], 0
    while True:
        if len(As) > 1 and As[0].shape[0] == 1:
            As, Vs = [gather_rows(As, home)], [gather_rows(Vs, home)]
        if done == len(rs):
            return parts, groups, As, Vs
        k = min(len(rs) - done, As[0].shape[0].bit_length() - 1)
        assert k, "no rows left to fold"
        dots, As, Vs = ladder_shards(As, Vs, rs[done:done + k])
        parts.append(gather_parts(dots, home))
        groups.append((len(dots), k))
        done += k


def _read_groups(rows, groups, width: int = 4) -> list:
    """The messages of `groups` [(shards, rounds)] from the fetched rows:
    a group is its shards' blocks one after the other, each `rounds`
    messages of `width` values; a round's message is the sum over the
    shards mod p."""
    out = []
    for shards, k in groups:
        acc = [[0] * width for _ in range(k)]
        for _ in range(shards):
            for t in range(k):
                for i, x in enumerate(islice(rows, width)):
                    acc[t][i] += x
        out += [tuple(x % FR_P for x in a) for a in acc]
    return out


def _host_tape_phase(engine, n: int, state: bytes, counter: int):
    """`run_fs` under a mesh: the phase's n rounds through engine.round
    and its last fold through engine.receive, the tape (state, counter)
    on the host absorbing each message and drawing the next challenge."""
    MESH_COUNTS["host_tape_phases"] += 1
    tape = FiatShamirTape()
    tape.state, tape.counter = state, counter
    polys, rs = [], []
    for _ in range(n):
        polys.append(engine.round(rs[-1] if rs else None))
        tape.absorb(*polys[-1])
        rs.append(tape.field())
    engine.receive(rs[-1])
    return polys, rs, tape.state, tape.counter


def _whole(blocks):
    assert len(blocks) == 1, "the operand is split over the mesh"
    return blocks[0]


def _blocks(X, m: int, min_block: int = 2):
    """An engine operand as row blocks: a list is taken as the blocks
    `shard_rows` would make of its m rows (the split inits' outputs, the
    witness's blocks); a tensor is zero-padded to m rows and split.  A
    split operand counts once in "splits", however it came; the engine
    gathers it once."""
    if isinstance(X, list):
        blocks = list(X)
    else:
        if X.shape[0] < m:
            X = torch.cat([X, FR.zeros(m - X.shape[0], X.device)])
        blocks = shard_rows(X[:m].contiguous(), min_block=min_block,
                            count=False)
    assert sum(b.shape[0] for b in blocks) == m, (m, len(blocks))
    if len(blocks) > 1:
        MESH_COUNTS["splits"] += 1
    return blocks


class Side:
    """One (mult, V) operand pair over a 2^nb hypercube, as row blocks
    `As` and `Vs` (one block each unless an active mesh splits them;
    module docstring); `A` and `V` are the whole operands once they are
    one block.  A and V are tensors, or lists of row blocks already split
    as `shard_rows` splits 2^nb rows (the split inits and the witness's
    blocks, `gkr/prover.py`)."""

    def __init__(self, A, V, nb: int):
        m = 1 << nb
        self.As, self.Vs = _blocks(A, m), _blocks(V, m)
        assert [a.shape[0] for a in self.As] == \
            [v.shape[0] for v in self.Vs]
        self.home = self.As[0].device
        self.nb = nb
        self.folds = 0
        self.collapsed = False

    @property
    def A(self):
        return _whole(self.As)

    @property
    def V(self):
        return _whole(self.Vs)

    @property
    def active(self):
        return self.folds < self.nb

    def gather(self):
        self.As = [gather_rows(self.As, self.home)]
        self.Vs = [gather_rows(self.Vs, self.home)]

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
        self.received = False           # the last fold is made
        self.mesh = active_mesh()

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
        1), then its pair dots, one `fold_round` launch a block (a side of
        two rows folds to its last row with `fold` and joins add_term;
        split blocks of two rows are gathered first); one fetch for the
        round."""
        parts, plan = [], []
        if self.add_term is None:
            parts.append(self._add_dev.reshape(1, FR.n))
        for s in self.sides:
            if s is None or s.collapsed:
                continue
            if prev_r is not None and s.As[0].shape[0] == 2:
                if len(s.As) > 1:
                    s.gather()
                elif s.active:
                    a, v = _fold_all(prev_r, s.A, s.V)
                    s.As, s.Vs = [a], [v]
                    s.folds += 1
            if s.active:
                outs = [fold_round(a, v, prev_r)
                        for a, v in zip(s.As, s.Vs)]
                s.As, s.Vs = [o[1] for o in outs], [o[2] for o in outs]
                if prev_r is not None:
                    s.folds += 1
                parts.append(gather_parts([o[0] for o in outs], s.home))
                plan.append((s, len(outs)))
            else:                       # exhausted: its scalars come along
                parts += [s.A[:1], s.V[:1]]
                plan.append((s, 0))
        rows = iter(_fetch_rows(parts)) if parts else iter(())
        if self.add_term is None:
            self.add_term = next(rows)
            self._add_dev = None
        if prev_r is not None and self.include_add_term:
            self.add_term = self.add_term * (1 - prev_r) % FR_P
        c = [0, 0, 0]
        for s, blocks in plan:
            if not blocks:
                self._join(s, next(rows) * next(rows))
            for _ in range(blocks):     # one quad a block
                q = quad_from_dots(*islice(rows, 4))
                c = [x + y for x, y in zip(c, q)]
        return self._add_x(c)

    def receive(self, r: int):
        """The last fold, at the last challenge r, of every side still
        active (one `fold` launch a side, gathered first); decays
        add_term."""
        self.received = True
        if self.include_add_term:
            self.add_term = self._add_host() * (1 - r) % FR_P
        for s in self.sides:
            if s is not None and s.active:
                s.gather()
                a, v = _fold_all(r, s.A, s.V)
                s.As, s.Vs = [a], [v]
                s.folds += 1

    def run_fs(self, n: int, state: bytes, counter: int):
        """All n rounds under the Fiat-Shamir tape (state, counter) and the
        last fold, one launch sequence and one fetch (`fold_round_phase`).
        -> (round polys as host-int 3-tuples, the challenges drawn, the
        tape's state and counter after them).  A phase with a split side
        runs its rounds through `round` and `receive` with the tape on the
        host (`_host_tape_phase`), a fetch a round, with the same
        result."""
        assert all(s is None or s.folds == 0 for s in self.sides), \
            "run_fs starts a phase"
        if any(s is not None and len(s.As) > 1 for s in self.sides):
            return _host_tape_phase(self, n, state, counter)
        if self.mesh is not None:
            MESH_COUNTS["device_tape_phases"] += 1
        sides = [None if s is None or s.collapsed else (s.A, s.V)
                 for s in self.sides]
        add = self._add_dev if self.add_term is None else self.add_term
        buf, fin, keep = fold_round_phase(sides, n, add,
                                          self.include_add_term, state,
                                          counter)
        state, counter, self.add_term, rs, polys = _fetch_phase(buf, n, 3)
        del keep                        # the launches are done
        self._add_dev = None
        for k, s in enumerate(self.sides):
            if sides[k] is not None:
                s.As, s.Vs = [fin[k, :1]], [fin[k, 1:]]
                s.folds, s.collapsed = s.nb, s.nb < n
        self.received = True
        return polys, rs, state, counter

    def run_all(self, rs):
        """All rounds at the known challenges rs; returns the round
        polys as a list of host-int 3-tuples.  One ladder per side (one a
        block while split, then the gathered tail), one fetch for the
        phase."""
        R = len(rs)
        if R == 0:
            return []
        self._add_host()
        plan, parts = [], []
        for s in self.sides:
            if s is None or s.collapsed:
                continue
            k = min(s.nb - s.folds, R)
            groups = []
            if k:
                dots, groups, s.As, s.Vs = _quad_rounds(s.As, s.Vs, rs[:k],
                                                        s.home)
                s.folds += k
                parts += dots
            if k < R:
                # exhausted within these rounds: its scalars come along
                parts += [s.A[:1], s.V[:1]]
            plan.append((s, k, groups))
        rows = iter(_fetch_rows(parts)) if parts else iter(())
        ran = []
        for s, k, groups in plan:
            quads = [quad_from_dots(*d) for d in _read_groups(rows, groups)]
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
            dev = next(x.home for x in self.sides if x is not None)
            return FR.zeros(1, dev)[0]
        return s.final_V_dev()


class DotProdPhase1:
    """Cubic phase-1 engine for DOT_PROD layers (reference
    sumcheckDotProdInitPhase1/Update1/Finalize1, prover.cpp:57-153).

    The fft-variable factor `m` (a beta table over the fft bits) folds
    alongside the two V operands for the first fft_bl rounds, then
    persists as a scalar multiplier.  m[i mod M/2] pairs with V's pair i,
    so under a mesh V0 and V1 are split on their high bits while a block
    holds at least M rows (else they stay one block), and each block's
    device holds a copy of all of m (`ms`, one a block), which folds there
    alongside the block; m comes back from the first copy when V is
    gathered.  `m`, `V0` and `V1` are the whole operands once they are one
    block.  V0 and V1 are tensors, or lists of row blocks already split as
    `shard_rows` splits them with blocks of at least M rows."""

    def __init__(self, m, V0, V1, fft_bl: int, nb1: int):
        m = m.contiguous()
        M = m.shape[0]

        def split(V):
            n = sum(b.shape[0] for b in V) if isinstance(V, list) \
                else V.shape[0]
            return _blocks(V, n, min_block=M)

        self.V0s, self.V1s = split(V0), split(V1)
        assert len(self.V0s) == len(self.V1s)
        self.home = self.V0s[0].device
        self.ms = replicate(m, self.V0s)
        self.fft_bl = fft_bl
        self.nb1 = nb1
        self.folds = 0
        self.received = False           # the last fold is made
        self.mesh = active_mesh()

    m = property(lambda self: _whole(self.ms))
    V0 = property(lambda self: _whole(self.V0s))
    V1 = property(lambda self: _whole(self.V1s))

    def _gather(self):
        """V0 and V1 gathered onto their device, m taken from the first
        copy."""
        self.V0s = [gather_rows(self.V0s, self.home)]
        self.V1s = [gather_rows(self.V1s, self.home)]
        if len(self.ms) > 1:
            self.ms = [_moved(self.ms[0], self.home)]

    def _cubic(self, step, *args):
        """step(m, V0, V1, *args) on each block -> the blocks' first
        outputs (m, V0 and V1 take the others)."""
        outs = [step(m, v0, v1, *args)
                for m, v0, v1 in zip(self.ms, self.V0s, self.V1s)]
        self.ms = [o[1] for o in outs]
        self.V0s = [o[2] for o in outs]
        self.V1s = [o[3] for o in outs]
        return [o[0] for o in outs]

    def round(self, prev_r: Optional[int]):
        """Round j's (c0, c1, c2, c3) as host ints: m (while it has more
        than one row), V0 and V1 folded at prev_r (None in round 1), then
        the cubic coefficients, one `fold_cubic_round` launch a block
        (split blocks of two rows gathered first) and one fetch.  Once m
        has one row the kernel gives m[0] times the quadratic form on (V1,
        V0), with c3 = 0 (reference prover.cpp:103-144)."""
        if prev_r is not None:
            if len(self.V0s) > 1 and self.V0s[0].shape[0] == 2:
                self._gather()
            self.folds += 1
        cs = self._cubic(fold_cubic_round, prev_r)
        rows = iter(_fetch_rows([gather_parts(cs, self.home)]))
        return _read_groups(rows, [(len(cs), 1)])[0]

    def receive(self, r: int):
        """The last fold, at the last challenge r: m (while it has more
        than one row), V0 and V1 in one `fold` launch."""
        self.received = True
        self._gather()
        m = self.m
        xs = ([m] if m.shape[0] > 1 else []) + [self.V0, self.V1]
        out = _fold_all(r, *xs)
        if m.shape[0] > 1:
            m = out.pop(0)
        self.ms, self.V0s, self.V1s = [m], out[:1], out[1:]
        self.folds += 1

    def run_fs(self, n: int, state: bytes, counter: int):
        """All n rounds under the Fiat-Shamir tape and the last fold, one
        launch sequence and one fetch (`fold_cubic_round_phase`); returns
        as PhaseEngine.run_fs, with 4-tuples.  With V split, the rounds
        through `round` and `receive` with the tape on the host."""
        assert self.folds == 0, "run_fs starts a phase"
        if len(self.V0s) > 1:
            return _host_tape_phase(self, n, state, counter)
        if self.mesh is not None:
            MESH_COUNTS["device_tape_phases"] += 1
        buf, fin, keep = fold_cubic_round_phase(self.m, self.V0, self.V1, n,
                                                state, counter)
        state, counter, _, rs, polys = _fetch_phase(buf, n, 4)
        del keep                        # the launches are done
        self.ms, self.V0s, self.V1s = [fin[:1]], [fin[1:2]], [fin[2:]]
        self.folds = n
        self.received = True
        return polys, rs, state, counter

    def run_all(self, rs):
        """All rounds at the known challenges rs as host-int 4-tuples:
        a cubic ladder (one a block) while m has more than one row, then
        quadratic ladders on (V1, V0) scaled by the scalar m
        (`_quad_rounds`); one fetch."""
        R = len(rs)
        if R == 0:
            return []
        M = self.ms[0].shape[0]
        assert M & (M - 1) == 0, M
        kc = min(M.bit_length() - 1, R)
        parts, cubic, groups = [], [], []
        if kc:
            cs = self._cubic(cubic_ladder, rs[:kc])
            parts.append(gather_parts([c.reshape(4 * kc, FR.n) for c in cs],
                                      self.home))
            cubic.append((len(cs), kc))
        if kc < R:
            parts.append(_moved(self.ms[0][:1], self.home))
            dots, groups, self.V1s, self.V0s = _quad_rounds(
                self.V1s, self.V0s, rs[kc:], self.home)
            parts += dots
        self._gather()
        self.folds += R
        rows = iter(_fetch_rows(parts))
        polys = _read_groups(rows, cubic)
        if kc < R:
            m0 = next(rows)
            for d in _read_groups(rows, groups):
                q = quad_from_dots(*d)
                polys.append(tuple(m0 * qi % FR_P for qi in q) + (0,))
        return polys

    def finalize_dev(self):
        """-> (claim_1 [8], V_u1 [8]) (reference prover.cpp:146-153)."""
        return self.V1[0], FR.mul(self.V1[0], self.m[0])
