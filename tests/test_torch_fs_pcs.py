"""zkcnn_tpu_torch's Hyrax commitment under FiatShamirTape on the CPU:
the port's counterparts of tests/test_pcs.py::
test_hyrax_fs_mode_gens_and_split and ::test_ipa_fs_challenges_bind_
messages at logn = 4.  The curve work runs on Python integers on the
host (the CPU routes of scalar multiplication and the MSM), never the
JAX package's curve programs.  Inputs from np.random.default_rng;
points compared as affine integers (tolerance 0).
"""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import FiatShamirTape
from zkcnn_tpu_torch.pcs import HyraxPCS, curve

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

G = (curve.G1_X, curve.G1_Y)
LOGN = 4


def _instance(seed):
    rng = np.random.default_rng(seed)
    draw = lambda: int.from_bytes(rng.bytes(31), "little") % FR_P
    vals = [draw() for _ in range(1 << LOGN)]
    r = [draw() for _ in range(LOGN)]
    v = list(vals)
    for rk in r:                         # the MLE at r, low variable first
        v = [(v[2 * i] * (1 - rk) + v[2 * i + 1] * rk) % FR_P
             for i in range(len(v) // 2)]
    return torch.from_numpy(FR.pack_mont_host(vals)), r, v[0]


def test_hyrax_fs_mode_gens_and_split():
    """Generators and Q by hash-to-curve (on the curve, not G, no tape
    draw), the open()/verify() split on tape clones in both modes, the
    prover's and the verifier's tapes in the same state afterwards, and a
    wrong evaluation rejected."""
    val0, r, ev = _instance(11)
    for mode in ("sqrt", "ipa"):
        pcs = HyraxPCS(mode=mode)
        tape = FiatShamirTape(b"fs-pcs")
        pcs.setup(LOGN, tape, "cpu")
        assert tape.counter == 0
        gens = curve.to_affine_host(pcs.gens)
        assert gens == [curve.hash_to_group_host(b"zkcnn-hyrax-gen", i)
                        for i in range(pcs.n_cols)]
        for (x, y) in gens:
            assert (y * y - (x ** 3 + 4)) % curve.FP_P == 0
            assert (x, y) != G
        Q = curve.to_affine_host(pcs._aux_gen(tape)[None])[0]
        assert Q == curve.hash_to_group_host(b"zkcnn-hyrax-gen-Q", 0) != G
        com = pcs.commit(val0)
        ptape, vtape = tape.clone(), tape.clone()
        proof = pcs.open(val0, r, ev, ptape)
        assert pcs.verify(com, r, ev, proof, vtape)
        assert (ptape.state, ptape.counter) == (vtape.state, vtape.counter)
        assert not pcs.verify(com, r, (ev + 1) % FR_P, proof, tape.clone())


def test_ipa_fs_challenges_bind_messages():
    """A doubled L_0 changes the verifier's challenges (absorbed before
    each draw), so the proof fails rather than verify against the
    challenges of the untampered one."""
    val0, r, ev = _instance(13)
    pcs = HyraxPCS(mode="ipa")
    tape = FiatShamirTape(b"fs-bind")
    pcs.setup(LOGN, tape, "cpu")
    com = pcs.commit(val0)
    proof = pcs.open(val0, r, ev, tape.clone())
    assert pcs.verify(com, r, ev, proof, tape.clone())
    proof.Ls[0] = curve.pdouble(proof.Ls[0])
    assert not pcs.verify(com, r, ev, proof, tape.clone())
