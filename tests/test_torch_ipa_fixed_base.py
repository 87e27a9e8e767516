"""zkcnn_tpu_torch's inner-product opening on the setup's fixed-base MSM
(`ipa.ipa_prove`, rounds over the original generators and Q) against the
fold-based prover `ipa_prove_by_folds` and an oracle in Python integers,
its round rows against generators folded in Python integers, and the MSM
over [points; Q] (`FixedBaseMSM.extend`) against `msm_host`.

Tolerance 0: points are compared as group elements (`points_equal`) or
affine integers, scalars as integers.  Inputs come from
np.random.default_rng(seed).
"""

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import FiatShamirTape, Tape
from zkcnn_tpu_torch.pcs import curve, ipa
from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM, msm_host, points_equal

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)


def _ipa_oracle(b, x, Gs, Q, chal):
    """The rounds of the argument in Python integers: (Ls, Rs, b0)."""
    def msm(ks, Ps):
        acc = None
        for k, P in zip(ks, Ps):
            acc = curve.py_add(acc, curve.py_mul(P, k))
        return acc
    dot = lambda u, v: sum(p * q for p, q in zip(u, v)) % FR_P
    Ls, Rs = [], []
    while len(b) > 1:
        n = len(b) // 2
        Ls.append(curve.py_add(msm(b[:n], Gs[n:]),
                               curve.py_mul(Q, dot(b[:n], x[n:]))))
        Rs.append(curve.py_add(msm(b[n:], Gs[:n]),
                               curve.py_mul(Q, dot(b[n:], x[:n]))))
        c = chal()
        ci = pow(c, -1, FR_P)
        b = [(c * lo + ci * hi) % FR_P for lo, hi in zip(b[:n], b[n:])]
        x = [(ci * lo + c * hi) % FR_P for lo, hi in zip(x[:n], x[n:])]
        Gs = [curve.py_add(curve.py_mul(lo, ci), curve.py_mul(hi, c))
              for lo, hi in zip(Gs[:n], Gs[n:])]
    return Ls, Rs, b[0]


class _Drawing(FiatShamirTape):
    """A Fiat-Shamir tape that keeps its draws: L_k and R_k are absorbed
    before each, so equal draws mean equal round messages."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def field(self):
        self.draws.append(super().field())
        return self.draws[-1]


def _instance(seed, L):
    """Generators and Q with known discrete logs, b and x: Python ints."""
    rng = np.random.default_rng(seed)
    draw = lambda: int.from_bytes(rng.bytes(31), "little") % FR_P
    gens = [curve.py_mul(G, draw()) for _ in range(L)]
    return gens, curve.py_mul(G, draw()), [draw() for _ in range(L)], \
        [draw() for _ in range(L)]


def _mont(vals):
    return torch.from_numpy(FR.pack_mont_host(vals))


def test_opening_equals_the_folds_and_the_oracle():
    """At L = 1 (no round), 2, 8 and 16: every L_k and R_k, b0 and the
    tape's draws and final state of ipa_prove equal ipa_prove_by_folds's
    and the oracle's."""
    for logn in (0, 1, 3, 4):
        gens, Q, b, x = _instance(40 + logn, 1 << logn)
        G_t = torch.from_numpy(curve.affine_pack(gens))
        Q_t = torch.from_numpy(curve.affine_pack([Q])[0])
        tape, ftape = _Drawing(b"fixed-base"), _Drawing(b"fixed-base")
        proof = ipa.ipa_prove(_mont(b), _mont(x), FixedBaseMSM(G_t), Q_t, 0,
                              tape)
        folds = ipa.ipa_prove_by_folds(_mont(b), _mont(x), G_t, Q_t, 0, ftape)
        assert len(proof.Ls) == len(proof.Rs) == len(folds.Ls) == logn
        assert tape.draws == ftape.draws and len(tape.draws) == logn
        assert (tape.state, tape.counter) == (ftape.state, ftape.counter)
        Ls, Rs, b0 = _ipa_oracle(b, x, gens, Q, iter(tape.draws).__next__)
        assert proof.b0 == folds.b0 == b0
        if not logn:
            continue
        for mine, ref, oracle in ((proof.Ls, folds.Ls, Ls),
                                  (proof.Rs, folds.Rs, Rs)):
            assert bool(points_equal(torch.stack(mine),
                                     torch.stack(ref)).all())
            assert curve.to_affine_host(torch.stack(mine)) == oracle


def test_round_rows_against_folded_generators_and_final_weights():
    """logn = 3: at every round the folded b and x (`ipa_round`, its plain
    version on the CPU) equal b and x folded in Python integers, and its
    two rows over the original generators and Q equal <b_lo, G^(k)_hi> +
    cl Q and <b_hi, G^(k)_lo> + cr Q on generators folded in Python
    integers, with cl = <b_lo, x_hi> and cr = <b_hi, x_lo>; the weights
    after the last round are ipa_verify's weight vector."""
    L = 8
    gens, Q, bi, xi = _instance(7, L)
    b, x = _mont(bi), _mont(xi)
    s = FR.const(1, "cpu").expand(L, FR.n)
    Gk, tape, chals, prev = list(gens), Tape(b"rows"), [], None
    bases = gens + [Q]
    dot = lambda u, v: sum(p * q for p, q in zip(u, v)) % FR_P  # noqa

    def row_msm(row):
        acc = None
        for k, P in zip(FR.unpack_mont_host(row.numpy()), bases):
            acc = curve.py_add(acc, curve.py_mul(P, k))
        return acc

    for _ in range(3):
        rows, s, b, x = ipa.ipa_round(b, x, s, prev)
        assert rows.shape == (2, L + 1, FR.n)
        assert FR.unpack_mont_host(b.numpy()) == bi
        assert FR.unpack_mont_host(x.numpy()) == xi
        h = len(bi) // 2
        want = [curve.py_mul(Q, dot(bi[:h], xi[h:])),
                curve.py_mul(Q, dot(bi[h:], xi[:h]))]
        for i in range(h):
            want[0] = curve.py_add(want[0], curve.py_mul(Gk[h + i], bi[i]))
            want[1] = curve.py_add(want[1], curve.py_mul(Gk[i], bi[h + i]))
        assert [row_msm(rows[0]), row_msm(rows[1])] == want
        c = tape.field()
        cinv = pow(c, -1, FR_P)
        chals.append((c, cinv))
        prev = (c, cinv)
        bi = [(c * lo + cinv * hi) % FR_P for lo, hi in zip(bi[:h], bi[h:])]
        xi = [(cinv * lo + c * hi) % FR_P for lo, hi in zip(xi[:h], xi[h:])]
        Gk = [curve.py_add(curve.py_mul(lo, cinv), curve.py_mul(hi, c))
              for lo, hi in zip(Gk[:h], Gk[h:])]
    s = ipa._reweigh(s, 2, *prev)           # the last round's challenge
    assert FR.unpack_mont_host(s.numpy()) == ipa.weights_host(chals, L)


def test_msm_over_points_and_q_equals_msm_host():
    """FixedBaseMSM(points).extend(Q) computes over [points; Q]: equal to
    msm_host over the joined points and to Python integers, zero scalars
    included; the object it extends is left as it was."""
    rng = np.random.default_rng(5)
    draw = lambda: int.from_bytes(rng.bytes(31), "little") % FR_P
    logs = [draw() for _ in range(6)]
    pts = torch.from_numpy(curve.affine_pack([curve.py_mul(G, k)
                                              for k in logs]))
    base = FixedBaseMSM(pts[:5])
    ext = base.extend(pts[5])
    assert (base.n_points, ext.n_points) == (5, 6)
    assert base.points.shape == (5, 3, 12) and ext.table is None
    ks = [[draw() for _ in range(6)] for _ in range(2)]
    ks[0][1] = ks[1][5] = 0
    rows = _mont([k for row in ks for k in row]).reshape(2, 6, FR.n)
    got = ext.compute(rows)
    assert bool(points_equal(got, msm_host(pts, rows)).all())
    assert curve.to_affine_host(got) == [
        curve.py_mul(G, sum(k * g for k, g in zip(row, logs)) % FR_P)
        for row in ks]
    with pytest.raises(ValueError):
        ext.compute(rows[:, :5])
