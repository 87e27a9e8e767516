"""zkcnn_tpu_torch's GKR proof under FiatShamirTape on the CPU, against
the JAX package (tolerance 0: absorbed values are integers, tape states
bytes).

  * singleConv NAIVE_FAST, seed 33, FiatShamirTape(b"fs") -- the model
    of tests/test_gkr_e2e.py::test_fiat_shamir_e2e -- through both
    packages: the absorbed sequences, proof_size, eval_in and the final
    tape state are identical, and a tampered layer value fails in the
    port;
  * tiny_fc_fft (it has a DOT_PROD layer, so the cubic rounds) against
    the JAX package's run pinned below: its JAX run takes about 6.5
    minutes on one core;
  * (slow) ROADMAP's fault 3.2: LeNet5 built by the JAX package, carried
    across by interop, equals the port's own circuit and witness and
    proves to the port's pinned digest.

`JAX_PLATFORMS=cpu python -m tests.test_torch_fs_gkr`, from the
repository root, reproduces TINY_FC_FS_PIN with the JAX package.
"""

import numpy as np
import pytest

from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier
from zkcnn_tpu.gkr.tape import FiatShamirTape as JFiatShamirTape
from zkcnn_tpu.nn import random_source as j_random_source
from zkcnn_tpu.nn.models import singleConv as j_singleConv
from zkcnn_tpu.nn.params import ConvType as JConvType
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import Prover, Verifier, FiatShamirTape
from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
from zkcnn_tpu_torch.nn.models import singleConv
from zkcnn_tpu_torch.nn.params import ConvType, ConvKernel, PoolKernel, \
    PoolType, FconKernel

# tiny_fc_fft (__graft_entry__._dryrun_models), random_source(24),
# FiatShamirTape(b"fs-tiny_fc_fft"), no commitment: the JAX package's
# run (113 absorbs)
TINY_FC_FS_PIN = {
    "proof_size": 10336,
    "eval_in": 21167061991221289981587067697021778505552149214330531514614897003195011090318,
    "state": "029e0a8ff6e1ba41f8b1cd37cbf79f0a6cf4e7bde5cb23989ca7905f935647ab"
             "a98dfa5f563b0441f2cd5cef448c82582c604011a91c26030bce3e2108327a9f",
    "counter": 128,
}


# LeNet5 pic_cnt=1, random_source(17), Tape(b"zkcnn-demo-17"), no
# commitment: the port's digest, pinned in tests/test_torch_e2e.py
PINNED_LENET_DIGEST = \
    "3ffb56eaac141bde0071a6debbd0c8871385aeb16878983c6c2242648af12647"


class _tiny_fc(NeuralNetwork):
    """tiny_fc_fft of __graft_entry__._dryrun_models: FFT conv -> RELU ->
    AVG pool -> FC -> RELU -> FC."""

    def __init__(self):
        super().__init__(4, 4, 1, 1)
        self.conv_section.append([ConvKernel(ConvType.FFT, 2, 1, 2, 0, 0)])
        self.pool.append(PoolKernel(PoolType.AVG, 2, 1))
        self.full_conn = [FconKernel(4, 2), FconKernel(3, 4)]


def _recording(base):
    """A test-local tape of the given package that keeps every absorbed
    value (mod p, as the tape hashes it)."""

    class Recording(base):
        def __init__(self, seed):
            super().__init__(seed)
            self.absorbed = []

        def absorb(self, *values):
            self.absorbed.append(tuple(int(v) % FR_P for v in values))
            super().absorb(*values)

    return Recording


def test_single_conv_fiat_shamir_matches_jax():
    Cj, vj = j_singleConv(6, 1, 1, 3, 2, JConvType.NAIVE_FAST).create(
        j_random_source(33))
    jt = _recording(JFiatShamirTape)(b"fs")
    jp = JProver(Cj, vj)
    jv = JVerifier(jp, Cj, jt)
    assert jv.verify()

    C, vals = singleConv(6, 1, 1, 3, 2, ConvType.NAIVE_FAST).create(
        random_source(33), device="cpu")
    t = _recording(FiatShamirTape)(b"fs")
    p = Prover(C, vals)
    v = Verifier(p, C, t)
    assert v.verify()
    assert t.absorbed == jt.absorbed
    assert (p.proof_size, v.eval_in) == (jp.proof_size, jv.eval_in)
    assert (t.state, t.counter) == (jt.state, jt.counter)

    # a tampered layer value shifts the challenge stream: the proof fails
    bad = vals[1].clone()
    bad[2] = FR.const(77, "cpu")
    assert not Verifier(Prover(C, [vals[0], bad]), C,
                        FiatShamirTape(b"fs")).verify()


def _tiny_fc_fs(nn, rs, FS, Prover_, Verifier_, **create):
    C, vals = nn.create(rs(24), **create)
    t = FS(b"fs-tiny_fc_fft")
    p = Prover_(C, vals)
    v = Verifier_(p, C, t)
    ok = v.verify()
    return ok, {"proof_size": p.proof_size, "eval_in": v.eval_in,
                "state": t.state.hex(), "counter": t.counter}


def test_tiny_fc_fft_fiat_shamir_matches_jax_pin():
    """The cubic (DOT_PROD) rounds under Fiat-Shamir: the port's run
    equals the JAX package's, pinned in TINY_FC_FS_PIN."""
    ok, got = _tiny_fc_fs(_tiny_fc(), random_source, FiatShamirTape, Prover,
                          Verifier, device="cpu")
    assert ok
    assert got == TINY_FC_FS_PIN


@pytest.mark.slow
def test_lenet_jax_circuit_and_witness_prove_to_the_port_pin():
    """Fault 3.2: the JAX package's LeNet5 (--synthetic --seed 17),
    carried across by interop, equals the port's circuit and witness
    layer by layer and proves, with the port, to PINNED_LENET_DIGEST."""
    from zkcnn_tpu.nn import models as j_zoo
    from zkcnn_tpu.nn.params import PoolType as JPoolType
    from zkcnn_tpu_torch.gkr import Tape
    from zkcnn_tpu_torch.interop import circuit_from_jax, vals_from_jax, \
        limbs16_to_words
    from zkcnn_tpu_torch.nn import models as zoo
    Cj, vj = j_zoo.lenet(32, 32, 1, 1, JPoolType.MAX).create(
        j_random_source(17))
    C, vals = zoo.lenet(32, 32, 1, 1, PoolType.MAX).create(
        random_source(17), device="cpu")
    assert len(vj) == len(vals) and Cj.size == C.size
    for a, b in zip(vj, vals):
        np.testing.assert_array_equal(limbs16_to_words(np.asarray(a)),
                                      b.numpy())
    for lj, lt in zip(Cj.layers, C.layers):
        assert (lj.ty.name, lj.size, lj.bit_length) == \
            (lt.ty.name, lt.size, lt.bit_length)
        np.testing.assert_array_equal(lj.uni, lt.uni)
        np.testing.assert_array_equal(lj.bin, lt.bin)
    del vals
    p = Prover(circuit_from_jax(Cj), vals_from_jax(vj), own_vals=True)
    v = Verifier(p, p.C, Tape(b"zkcnn-demo-17"))
    assert v.verify()
    assert v.transcript_digest == PINNED_LENET_DIGEST
    assert "%.4f" % (p.proof_size / 1024) == "45.7188"


if __name__ == "__main__":
    from __graft_entry__ import _dryrun_models
    from zkcnn_tpu.gkr import Prover as JP, Verifier as JV
    build = dict(_dryrun_models())["tiny_fc_fft"]
    ok, pin = _tiny_fc_fs(build(), j_random_source, JFiatShamirTape, JP, JV)
    assert ok
    print(pin)
