"""zkcnn_tpu_torch end to end on the CPU: the three tiny models prove
and verify with the 1-device transcript digests and proof sizes pinned
for zkcnn_tpu, a JAX-built circuit and witness prove to the same
digest through the port, and (slow) LeNet5 pic_cnt=1 reproduces its
pinned digest.

The pins were made with a Hyrax commitment, whose setup draws
2^(bl - bl//2) challenges from the tape before the GKR proof; these
tests prove without one (`pcs=None`) and discard those draws so that
the GKR challenges line up.  tests/test_torch_pcs_e2e.py proves the same
models with the commitment in place.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import PINNED_1CHIP
from zkcnn_tpu.nn import random_source as j_random_source
from zkcnn_tpu.nn import models as j_zoo
from zkcnn_tpu.nn.params import ConvType as JConvType
from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.interop import circuit_from_jax, vals_from_jax, \
    limbs16_to_words
from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
from zkcnn_tpu_torch.nn import models as zoo
from zkcnn_tpu_torch.nn.params import PoolType, ConvType, ConvKernel, \
    PoolKernel, FconKernel

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

# LeNet5 pic_cnt=1, random_source(17), Tape(b"zkcnn-demo-17"), no PCS:
# the port's step-path digest on the CPU.  (The JAX package's
# PINNED_LENET_DIGEST was made on its TPU ladder path, whose padded
# round-poly rows enter the hash, so it is not this digest.)
PINNED_LENET_DIGEST = \
    "3ffb56eaac141bde0071a6debbd0c8871385aeb16878983c6c2242648af12647"


class _tiny_fc(NeuralNetwork):
    """FFT conv (PADDING/FFT/DOT_PROD/IFFT/ADD_BIAS) -> RELU -> AVG pool
    -> FC -> RELU -> FC, as in __graft_entry__._dryrun_models."""

    def __init__(self):
        super().__init__(4, 4, 1, 1)
        self.conv_section.append([ConvKernel(ConvType.FFT, 2, 1, 2, 0, 0)])
        self.pool.append(PoolKernel(PoolType.AVG, 2, 1))
        self.full_conn = [FconKernel(4, 2), FconKernel(3, 4)]


TINY = {
    "ccnn4_max": lambda: zoo.ccnn(4, 4, 1, 1, PoolType.MAX),
    "sconv_muladd": lambda: zoo.singleConv(6, 1, 1, 3, 2, ConvType.NAIVE),
    "tiny_fc_fft": _tiny_fc,
}


def _prove(name, C, vals):
    p = Prover(C, vals)
    tape = Tape(b"dryrun-" + name.encode())
    bl = C.layers[0].bit_length
    tape.fields(1 << (bl - (bl >> 1)))     # the PCS setup's draws
    v = Verifier(p, C, tape)
    return v.verify(), v.transcript_digest, p.proof_size


def test_tiny_models_match_1chip_pins():
    for name, build in TINY.items():
        C, vals = build().create(random_source(24), device="cpu")
        ok, digest, ps = _prove(name, C, vals)
        assert ok, name
        assert (digest, ps) == (PINNED_1CHIP[name]["digest"],
                                PINNED_1CHIP[name]["proof_size"]), name


def test_jax_built_circuit_proves_to_the_same_digest():
    """zkcnn_tpu's circuit and witness, carried over by interop, equal
    the port's own and prove to the same transcript."""
    name = "sconv_muladd"
    Cj, vj = j_zoo.singleConv(6, 1, 1, 3, 2, JConvType.NAIVE).create(
        j_random_source(24))
    C, vals = TINY[name]().create(random_source(24), device="cpu")
    for a, b in zip(vj, vals):
        np.testing.assert_array_equal(limbs16_to_words(np.asarray(a)),
                                      b.numpy())
    for lj, lt in zip(Cj.layers, C.layers):
        assert lj.ty.name == lt.ty.name
        np.testing.assert_array_equal(lj.uni, lt.uni)
        np.testing.assert_array_equal(lj.bin, lt.bin)
    ok, digest, ps = _prove(name, circuit_from_jax(Cj), vals_from_jax(vj))
    assert ok
    assert (digest, ps) == (PINNED_1CHIP[name]["digest"],
                            PINNED_1CHIP[name]["proof_size"])


def test_dotprod_gate_path_matches_structural_path():
    """Without the layers' structural dims (dp_dims) the DOT_PROD init
    takes the per-gate path (dotprod_p1_V0_gates); the transcript must
    not change."""
    name = "tiny_fc_fft"
    C, vals = TINY[name]().create(random_source(24), device="cpu")
    dp = [ly for ly in C.layers if ly.ty == LayerType.DOT_PROD]
    assert dp
    for ly in dp:
        del ly.dp_dims
    ok, digest, ps = _prove(name, C, vals)
    assert ok
    assert (digest, ps) == (PINNED_1CHIP[name]["digest"],
                            PINNED_1CHIP[name]["proof_size"])


@pytest.mark.slow
def test_lenet_digest_pinned():
    from zkcnn_tpu_torch.cli import demo_lenet
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--no-pcs",
                           "--pic-cnt", "1", "--cpu"])
    assert res["row"]["WS"] == "201734(2^18)"
    assert res["row"]["PS"] == "45.7188"
    assert res["digest"] == PINNED_LENET_DIGEST
