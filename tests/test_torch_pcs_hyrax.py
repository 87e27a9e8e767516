"""zkcnn_tpu_torch's Hyrax commitment on the CPU: the sqrt opening
against zkcnn_tpu's (JAX on the CPU, its MSMs in host mode), with proofs
verified across the two packages, and the inner-product opening against
an oracle in Python integers.

Tolerance 0: points are compared as affine integers, scalars as
integers.  Inputs come from np.random.default_rng(seed).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.gkr.tape import Tape as JTape
from zkcnn_tpu.pcs import HyraxPCS as JHyraxPCS
from zkcnn_tpu.pcs.hyrax import SqrtProof as JSqrtProof
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import Tape
from zkcnn_tpu_torch.interop import limbs16_to_words, words_to_limbs16, \
    pcs_from_jax, points_from_jax, points_to_jax
from zkcnn_tpu_torch.pcs import HyraxPCS, curve
from zkcnn_tpu_torch.pcs.hyrax import SqrtProof

G = (curve.G1_X, curve.G1_Y)
LOGN = 4


def _instance(seed, logn=LOGN):
    rng = np.random.default_rng(seed)
    draw = lambda: int.from_bytes(rng.bytes(31), "little") % FR_P
    vals = [draw() for _ in range(1 << logn)]
    r = [draw() for _ in range(logn)]
    v = list(vals)
    for rk in r:                         # the MLE at r, low variable first
        v = [(v[2 * i] * (1 - rk) + v[2 * i + 1] * rk) % FR_P
             for i in range(len(v) // 2)]
    return vals, r, v[0]


def _eq(r):
    out = [1]
    for rk in r:
        out = [x * (1 - rk) % FR_P for x in out] + \
            [x * rk % FR_P for x in out]
    return out


def test_sqrt_opening_matches_jax_and_cross_verifies(monkeypatch):
    monkeypatch.setenv("ZKCNN_TPU_MSM_HOST", "1")
    vals, r, ev = _instance(5)
    val0 = torch.from_numpy(FR.pack_mont_host(vals))
    jval0 = jnp.asarray(JFR.pack_mont_host(vals))
    np.testing.assert_array_equal(limbs16_to_words(np.asarray(jval0)),
                                  val0.numpy())

    jpcs, jtape = JHyraxPCS(mode="sqrt"), JTape(b"pcs-test")
    jpcs.setup(LOGN, jtape)
    jcom = jpcs.commit(jval0)
    pcs, tape = HyraxPCS(mode="sqrt"), Tape(b"pcs-test")
    pcs.setup(LOGN, tape, "cpu")
    com = pcs.commit(val0)
    assert tape.counter == jtape.counter == pcs.n_cols == 4
    assert curve.to_affine_host(pcs.gens) == \
        curve.to_affine_host(points_from_jax(jpcs.gens))
    assert curve.to_affine_host(com) == \
        curve.to_affine_host(points_from_jax(jcom))

    jproof = jpcs.open(jval0, r, ev, jtape)
    proof = pcs.open(val0, r, ev, tape)
    np.testing.assert_array_equal(limbs16_to_words(np.asarray(jproof.b)),
                                  proof.b)
    assert pcs.ps == jpcs.ps == 4 * 48 + 4 * 32
    assert pcs.verify(com, r, ev, proof, tape)
    assert not pcs.verify(com, r, (ev + 1) % FR_P, proof, tape)
    assert pcs.open_and_verify(com, val0, r, ev, tape)
    assert not pcs.open_and_verify(com, val0, r, ev + 1, tape)
    assert pcs.pt > 0 and pcs.vt > 0

    # the JAX proof and commitment verify in the port ...
    carried = pcs_from_jax(jpcs)
    assert (carried.mode, carried.logn, carried.ps) == ("sqrt", LOGN, jpcs.ps)
    assert carried.verify(carried.row_commits, r, ev, SqrtProof(
        limbs16_to_words(np.asarray(jproof.b))), Tape(b"pcs-test"))
    # ... and the port's in the JAX package
    jb = words_to_limbs16(proof.b)
    jc = jnp.asarray(points_to_jax(com))
    assert jpcs.verify(jc, r, ev, JSqrtProof(jb), jtape)
    assert not jpcs.verify(jc, r, (ev + 1) % FR_P, JSqrtProof(jb), jtape)


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


def _ipa_run(logn, seed, name):
    vals, r, ev = _instance(seed, logn)
    val0 = torch.from_numpy(FR.pack_mont_host(vals))
    pcs, tape = HyraxPCS(mode="ipa"), Tape(name)
    pcs.setup(logn, tape, "cpu")
    com = pcs.commit(val0)
    return vals, r, ev, val0, pcs, tape, com


def test_ipa_opening_matches_the_oracle_and_rejects():
    vals, r, ev, val0, pcs, tape, com = _ipa_run(LOGN, 9, b"ipa-test")
    vtape = tape.clone()
    proof = pcs.open(val0, r, ev, tape)
    assert pcs.ps == pcs.n_rows * 48 + 2 * pcs.l_col * 48 + 32
    assert pcs.verify(com, r, ev, proof, vtape.clone())
    assert not pcs.verify(com, r, (ev + 1) % FR_P, proof, vtape.clone())

    # the oracle: same generators (4 draws), then Q, then a draw a round
    otape = Tape(b"ipa-test")
    gens = [curve.py_mul(G, s) for s in otape.fields(pcs.n_cols)]
    Q = curve.py_mul(G, otape.field())
    eq_hi, eq_lo = _eq(r[pcs.l_col:]), _eq(r[:pcs.l_col])
    b = [sum(vals[i * pcs.n_cols + j] * eq_hi[i]
             for i in range(pcs.n_rows)) % FR_P for j in range(pcs.n_cols)]
    Ls, Rs, b0 = _ipa_oracle(b, eq_lo, gens, Q, otape.field)
    assert otape.counter == tape.counter
    assert curve.to_affine_host(torch.stack(proof.Ls)) == Ls
    assert curve.to_affine_host(torch.stack(proof.Rs)) == Rs
    assert proof.b0 == b0

    proof.Ls[0] = curve.padd(proof.Ls[0], curve.base_point())    # tampered
    assert not pcs.verify(com, r, ev, proof, vtape.clone())


class _AbsorbingTape(Tape):
    """A tape that is not precomputable: hash-to-curve generators, round
    messages absorbed."""
    precomputable = False

    def __init__(self, seed):
        super().__init__(seed)
        self.absorbed = []

    def absorb(self, *values):
        self.absorbed += values

    def clone(self):
        t = _AbsorbingTape(self.seed)
        t.counter = self.counter
        return t


def test_odd_bit_length_and_short_witness():
    """logn = 5: 4 rows of 8 columns, both modes; a layer shorter than
    2^logn values is refused; with a tape that is not precomputable the
    generators come from hash-to-curve (no draws) and every L_k, R_k is
    absorbed in its canonical encoding."""
    for mode in ("sqrt", "ipa"):
        vals, r, ev = _instance(7, 5)
        val0 = torch.from_numpy(FR.pack_mont_host(vals))
        pcs, tape = HyraxPCS(mode=mode), Tape(b"odd")
        pcs.setup(5, tape, "cpu")
        assert (pcs.n_rows, pcs.n_cols) == (4, 8)
        com = pcs.commit(val0)
        assert com.shape == (4, 3, 12)
        assert pcs.open_and_verify(com, val0, r, ev, tape)
        assert not pcs.open_and_verify(com, val0, r, ev + 1, tape)
        with pytest.raises(ValueError):
            pcs.commit(val0[:31])
    vals, r, ev = _instance(8, 3)
    val0 = torch.from_numpy(FR.pack_mont_host(vals))
    pcs, tape = HyraxPCS(mode="ipa"), _AbsorbingTape(b"fs")
    pcs.setup(3, tape, "cpu")
    assert tape.counter == 0
    assert curve.to_affine_host(pcs.gens[:1]) == \
        [curve.hash_to_group_host(b"zkcnn-hyrax-gen", 0)]
    com = pcs.commit(val0)
    assert pcs.open_and_verify(com, val0, r, ev, tape)
    assert len(tape.absorbed) == 2 + 1 and tape.counter == 2
    assert tape.absorbed[0].bit_length() > 8 * 96     # x||y of L_0 and R_0
    assert not pcs.open_and_verify(com, val0, r, ev + 1, tape)


@pytest.mark.slow
def test_ipa_proof_matches_jax(monkeypatch):
    """The JAX package's IPA proof at logn = 4 (its curve programs
    compile for minutes on the CPU) equals the port's: L_k, R_k as
    affine integers, b0."""
    monkeypatch.setenv("ZKCNN_TPU_MSM_HOST", "1")
    vals, r, ev, val0, pcs, tape, com = _ipa_run(LOGN, 9, b"ipa-test")
    proof = pcs.open(val0, r, ev, tape)
    jval0 = jnp.asarray(JFR.pack_mont_host(vals))
    jpcs, jtape = JHyraxPCS(mode="ipa"), JTape(b"ipa-test")
    jpcs.setup(LOGN, jtape)
    jpcs.commit(jval0)
    jproof = jpcs.open(jval0, r, ev, jtape)
    assert jtape.counter == tape.counter
    for mine, theirs in ((proof.Ls, jproof.Ls), (proof.Rs, jproof.Rs)):
        assert curve.to_affine_host(torch.stack(mine)) == \
            curve.to_affine_host(points_from_jax(np.stack(
                [np.asarray(t) for t in theirs])))
    assert proof.b0 == jproof.b0
