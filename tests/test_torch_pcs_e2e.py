"""zkcnn_tpu_torch end to end on the CPU with the Hyrax commitment in
place: the three tiny models prove and verify with a real sqrt
commitment and opening -- no tape draws thrown away -- and reproduce
the 1-device transcript digests and proof sizes pinned for zkcnn_tpu;
one of them also with the inner-product opening; the runner without
--no-pcs fills the POLY columns; and (slow) LeNet5 pic_cnt=1 with the
inner-product commitment reproduces its pinned digest.

Tolerance 0 (digests and byte counts).
"""

import pytest
import torch

from __graft_entry__ import PINNED_1CHIP
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
from zkcnn_tpu_torch.nn import models as zoo
from zkcnn_tpu_torch.nn.params import PoolType, ConvType, ConvKernel, \
    PoolKernel, FconKernel
from zkcnn_tpu_torch.pcs import HyraxPCS

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

# LeNet5 pic_cnt=1, random_source(17), Tape(b"zkcnn-demo-17"), with the
# commitment (512 generator draws before the GKR proof): the port's
# digest on the CPU, which the smoke script requires of the card
PINNED_LENET_PCS_DIGEST = \
    "709e96e190e563e67c417485bf3484939e1f0f87a77bcd4a1af71376318bf695"


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


def _prove(name, mode):
    C, vals = TINY[name]().create(random_source(24), device="cpu")
    p = Prover(C, vals, own_vals=True)
    pcs = HyraxPCS(mode=mode)
    v = Verifier(p, C, Tape(b"dryrun-" + name.encode()), pcs=pcs)
    assert v.verify(), name
    assert (v.transcript_digest, p.proof_size) == (
        PINNED_1CHIP[name]["digest"], PINNED_1CHIP[name]["proof_size"]), name
    return C, v, pcs


def test_tiny_models_with_sqrt_commitment_match_1chip_pins():
    for name in TINY:
        C, v, pcs = _prove(name, "sqrt")
        bl = C.layers[0].bit_length
        assert v.commitment.shape == (1 << (bl >> 1), 3, 12)
        assert pcs.ps == (1 << (bl >> 1)) * 48 + (1 << (bl - (bl >> 1))) * 32
        # a wrong evaluation of the committed input is rejected
        assert not pcs.open_and_verify(v.commitment, v.p.val[0], v.r_u[0],
                                       v.eval_in + 1, v.tape)


def test_tiny_model_with_ipa_commitment_matches_1chip_pin():
    C, v, pcs = _prove("sconv_muladd", "ipa")
    bl = C.layers[0].bit_length
    assert pcs.ps == (1 << (bl >> 1)) * 48 + 2 * (bl - (bl >> 1)) * 48 + 32


def test_runner_fills_the_poly_columns(capsys):
    from zkcnn_tpu_torch.cli import demo_lenet
    args = ["--synthetic", "--seed", "17", "--model", "ccnn", "--cpu"]
    res = demo_lenet.main(args)
    row = res["row"]
    assert float(row["POLY_PS"]) > 0 and float(row["POLY_PT"]) > 0 \
        and float(row["POLY_VT"]) > 0
    assert row["POLY_PS"] == f"{res['poly_ps']:.4f}"
    assert 0 < res["poly_commit_s"] < res["poly_pt"]    # commit, then open
    assert abs(float(row["TOT_PS"]) - float(row["PS"])
               - float(row["POLY_PS"])) < 2e-4       # four printed decimals
    assert row["POLY_PS"] in capsys.readouterr().out
    # without the commitment: the same proof size, no POLY columns, and
    # another digest (the generators' draws shift every challenge)
    bare = demo_lenet.main(args + ["--no-pcs"])
    assert bare["row"]["PS"] == row["PS"]
    assert bare["row"]["POLY_PS"] == "0.0000" and bare["poly_pt"] == 0.0 \
        and bare["poly_commit_s"] == 0.0
    assert bare["digest"] != res["digest"]


@pytest.mark.slow
def test_lenet_with_commitment_digest_pinned():
    from zkcnn_tpu_torch.cli import demo_lenet
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--pic-cnt", "1",
                           "--cpu"])
    assert res["row"]["WS"] == "201734(2^18)"
    assert res["row"]["PS"] == "45.7188"
    assert res["row"]["POLY_PS"] == "24.8750"
    assert res["digest"] == PINNED_LENET_PCS_DIGEST
