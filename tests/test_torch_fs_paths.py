"""zkcnn_tpu_torch's two verifier paths on the CPU (tolerance 0):

  * the per-round path driven by a plain seeded tape that is not
    precomputable (the reference draw order, as
    tests/test_gkr_e2e.py::test_fused_matches_per_round drives the JAX
    package) absorbs exactly the sequence of the three-pass path, with
    the same proof_size and eval_in, on the three tiny models; the
    three-pass transcripts stay PINNED_1CHIP;
  * the tiny models under FiatShamirTape with the Hyrax commitment (sqrt;
    sconv_muladd with the inner-product opening too): verified, the final
    tape state and counter -- the port's Fiat-Shamir fingerprint, which
    chip_smoke.py requires of the card -- pinned, a tampered witness
    rejected.  The sconv_muladd pins are the JAX package's run, so they
    hold the commitment's part of the transcript (the absorb of the
    commitment's digest; with the inner-product opening the absorbs of
    L_k, R_k and b0) to the JAX package;
  * (slow) LeNet5 pic_cnt=1 (--synthetic --seed 17) under
    FiatShamirTape(b"zkcnn-demo-17") with the inner-product commitment:
    WS, PS and POLY_PS of the reference and the pinned fingerprint.

`JAX_PLATFORMS=cpu ZKCNN_TPU_MSM_HOST=1 python -m tests.test_torch_fs_paths`,
from the repository root, reproduces the sconv_muladd entries of
PINNED_FS_TINY with the JAX package (about 5 minutes on one core).
"""

import pytest

from __graft_entry__ import PINNED_1CHIP
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape, FiatShamirTape
from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
from zkcnn_tpu_torch.nn import models as zoo
from zkcnn_tpu_torch.nn.params import PoolType, ConvType, ConvKernel, \
    PoolKernel, FconKernel
from zkcnn_tpu_torch.pcs import HyraxPCS

# FiatShamirTape(b"dryrun-<name>"), random_source(24), the commitment in
# the given mode: the final tape state (sha512, hex) and draw counter;
# the sconv_muladd entries are the JAX package's run (the module
# docstring gives the command), the others the port's run on the CPU
PINNED_FS_TINY = {
    ("ccnn4_max", "sqrt"): (
        "c5993cff83e015aa5b31b052f57de949ff2d279bafe667ec8198db0467beb60f"
        "759f1a9635b1148ac41e97e5b260c24cb7bd4c051aa4512bcb4de2b3cabc42b1",
        77),
    ("sconv_muladd", "sqrt"): (
        "f1b4f6a2ec7e4fb48a7cf53cd0d01a8d5d319fb7f452775147b435668608b415"
        "3ca462339221cfa8cda9545c27c21bcd78eb5a903cb456e5e3601666861858b5",
        38),
    ("sconv_muladd", "ipa"): (
        "9a1736bf6fcb97cb66a9ab71fb809ca5386cb1c11584a59bddeaf77b8f187db4"
        "65111dd1acbf3538661a4e902ec6aff84eab5269a0c8fe26d81bb199f624f0f2",
        41),
    ("tiny_fc_fft", "sqrt"): (
        "e6d55a26ee681f22e5574b0f3a3733a5446edca1f595c5c9d699117335ca212d"
        "1698cbd51bad5c5de967ff5ba72cc4c02dd68d4687b184b26f486ead2379e7fd",
        128),
}

# LeNet5 pic_cnt=1, random_source(17), FiatShamirTape(b"zkcnn-demo-17"),
# inner-product commitment: the port's run on the CPU
PINNED_FS_LENET = (
    "10736122550bca8d22784b5b1603a1b99ec37b05a88240315d3a04619be83600"
    "22808f60a53356f4b98f9857960b3c4bf38934bd9d5403597f97b4ea91ccf02b",
    548)


class _tiny_fc(NeuralNetwork):
    """tiny_fc_fft of __graft_entry__._dryrun_models."""

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


class _Recording(Tape):
    """A plain seeded tape that keeps every absorbed value."""

    def __init__(self, seed, precomputable):
        super().__init__(seed)
        self.precomputable = precomputable
        self.absorbed = []

    def absorb(self, *values):
        self.absorbed.append(tuple(v % FR_P for v in values))


def test_per_round_path_equals_three_pass_path():
    for name, build in TINY.items():
        out = []
        for precomputable in (True, False):
            C, vals = build().create(random_source(24), device="cpu")
            p = Prover(C, vals)
            tape = _Recording(b"dryrun-" + name.encode(), precomputable)
            bl = C.layers[0].bit_length
            tape.fields(1 << (bl - (bl >> 1)))     # the PCS setup's draws
            v = Verifier(p, C, tape)
            assert v.verify(), (name, precomputable)
            out.append((tape.absorbed, tape.counter, p.proof_size,
                        v.eval_in, v.transcript_digest))
        (seq, ctr, ps, ev, digest), (seq2, ctr2, ps2, ev2, none) = out
        assert (seq2, ctr2, ps2, ev2) == (seq, ctr, ps, ev), name
        assert none is None             # no digest on the per-round path
        assert (digest, ps) == (PINNED_1CHIP[name]["digest"],
                                PINNED_1CHIP[name]["proof_size"]), name


def test_tiny_models_fiat_shamir_with_commitment_pinned():
    for (name, mode), pin in PINNED_FS_TINY.items():
        C, vals = TINY[name]().create(random_source(24), device="cpu")
        tape = FiatShamirTape(b"dryrun-" + name.encode())
        p = Prover(C, vals)
        assert Verifier(p, C, tape, pcs=HyraxPCS(mode=mode)).verify(), name
        assert (tape.state.hex(), tape.counter) == pin, (name, mode)
        assert p.proof_size == PINNED_1CHIP[name]["proof_size"], name
        # a tampered witness value of the last layer fails
        bad = list(vals)
        bad[-1] = bad[-1].clone()
        bad[-1][0] = FR.add(bad[-1][0], FR.const(1, "cpu"))
        tape = FiatShamirTape(b"dryrun-" + name.encode())
        assert not Verifier(Prover(C, bad), C, tape,
                            pcs=HyraxPCS(mode=mode)).verify(), name


@pytest.mark.slow
def test_lenet_fiat_shamir_with_ipa_commitment_pinned():
    C, vals = zoo.lenet(32, 32, 1, 1, PoolType.MAX).create(
        random_source(17), device="cpu")
    assert C.layers[0].size == 201734
    p = Prover(C, vals, own_vals=True)
    pcs = HyraxPCS(mode="ipa")
    tape = FiatShamirTape(b"zkcnn-demo-17")
    v = Verifier(p, C, tape, pcs=pcs)
    assert v.verify()
    assert "%.4f" % (p.proof_size / 1024) == "45.7188"
    assert "%.4f" % (pcs.ps / 1024) == "24.8750"
    assert v.transcript_digest is None
    assert (tape.state.hex(), tape.counter) == PINNED_FS_LENET


if __name__ == "__main__":
    from __graft_entry__ import _dryrun_models
    from zkcnn_tpu.gkr import Prover as JP, Verifier as JV
    from zkcnn_tpu.gkr.tape import FiatShamirTape as JFS
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.pcs.hyrax import HyraxPCS as JHyraxPCS
    build = dict(_dryrun_models())["sconv_muladd"]
    for mode in ("sqrt", "ipa"):
        C, vals = build().create(j_random_source(24))
        tape = JFS(b"dryrun-sconv_muladd")
        assert JV(JP(C, vals), C, tape, pcs=JHyraxPCS(mode=mode)).verify()
        print(("sconv_muladd", mode), (tape.state.hex(), tape.counter))
