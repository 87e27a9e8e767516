"""Fiat-Shamir on the FFT-convolution path in zkcnn_tpu_torch on the CPU
(tolerance 0 throughout, no commitment).  Above one picture both
packages' models.py make every convolution an FFT one (PADDING -> FFT ->
DOT_PROD -> IFFT -> ADD_BIAS); under FiatShamirTape each DOT_PROD phase 1
runs as one cubic phase call of log2 K rounds and every other phase as
one quadratic phase call (`run_fs`), the path that vgg11 at pic_cnt=2 and
vgg16 at pic_cnt=8 take on the card:

  * ccnn 8x8 at pic_cnt=2 (one FFT convolution, then max pool),
    random_source(41), FiatShamirTape(b"ccnn-fft-fs"): the final tape
    state, counter and proof size equal FS_CCNN_FFT_PIN, made by the JAX
    package's own Prover and Verifier; a witness with one value of the
    FFT layer changed is rejected;
  * the short tiny vgg of tests/test_torch_vgg_fft.py at pic_cnt=2
    (tiny_vgg_fft, random_source(41)), FiatShamirTape(b"vgg-fft-fs"):
    the final state, counter and proof size equal FS_TINY_VGG_FFT_PIN,
    made by the JAX package's own Prover and Verifier too (XLA:CPU's
    programs released at every layer, as for TINY_VGG_FFT_PIN);
  * the same proof over 4 CPU shards gives the same fingerprint, its
    split phases on the host tape.

About 110 s on one core (the tiny vgg's proof about 40 s, over 4 shards
about 55 s).  `JAX_PLATFORMS=cpu python -m tests.test_torch_fs_vgg_fft`,
from the repository root, remakes both pins with the JAX package (about
5 minutes for the ccnn, 20 for the tiny vgg, on 4 cores).
"""

import pytest
import torch

from tests.test_torch_vgg_fft import tiny_vgg_fft
from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.gkr import Prover, Verifier, FiatShamirTape
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.parallel import COUNTS, make_mesh, reset_counts, \
    use_mesh

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores
torch.set_num_threads(1)

CCNN_SEED = b"ccnn-fft-fs"
VGG_SEED = b"vgg-fft-fs"

# ccnn 8x8 at pic_cnt=2 under FiatShamirTape(CCNN_SEED): the JAX
# package's run (python -m tests.test_torch_fs_vgg_fft)
FS_CCNN_FFT_PIN = {
    "state": "71730ab14de2fe2930ead746bdbd17508921412cc79e7db43e5f681db4a6a484"
             "e5214309f246fd60221e3ed76fc4da24132cafafc9def046f45852e78faee322",
    "counter": 157, "proof_size": 12128,
}
# the short tiny vgg at pic_cnt=2 under FiatShamirTape(VGG_SEED): the JAX
# package's run (python -m tests.test_torch_fs_vgg_fft)
FS_TINY_VGG_FFT_PIN = {
    "state": "7f8b98647f09a8a9af010a693d050f1eda6624a2086398536101805178974034"
             "112acfe6c15ae0b3ac071ceb94f6fc804da9a3de61c567cbe4de9f223e608b13",
    "counter": 499, "proof_size": 42944,
}


def ccnn_fft(models, PoolType):
    """ccnn 8x8 at two pictures from either package's model zoo: one FFT
    convolution, then max pool."""
    return models.ccnn(8, 8, 2, 1, PoolType.MAX)


def fs_proof(C, vals, seed, Prover, Verifier, FiatShamirTape, **kw):
    """(verified, the final tape state, counter and proof size) of one
    proof under FiatShamirTape(seed), with either package's classes."""
    p = Prover(C, list(vals))
    tape = FiatShamirTape(seed)
    ok = Verifier(p, C, tape, **kw).verify()
    return ok, {"state": tape.state.hex(), "counter": tape.counter,
                "proof_size": p.proof_size}


@pytest.fixture(scope="module")
def tiny_pic2():
    """The port's tiny vgg at pic_cnt=2, built once for both proofs (none
    of them writes to it)."""
    from zkcnn_tpu_torch.nn import models
    return tiny_vgg_fft(models, 2).create(random_source(41), device="cpu")


def test_ccnn_pic2_matches_the_jax_pin_and_rejects_a_changed_fft_value():
    from zkcnn_tpu_torch.nn import models
    from zkcnn_tpu_torch.nn.params import PoolType
    C, vals = ccnn_fft(models, PoolType).create(random_source(41),
                                                device="cpu")
    kinds = [ly.ty for ly in C.layers]
    assert LayerType.DOT_PROD in kinds and LayerType.NCONV not in kinds
    ok, got = fs_proof(C, vals, CCNN_SEED, Prover, Verifier, FiatShamirTape)
    assert ok
    assert got == FS_CCNN_FFT_PIN
    i = kinds.index(LayerType.FFT)
    bad = list(vals)
    bad[i] = bad[i].clone()
    bad[i][3] = FR.add(bad[i][3], FR.const(1, "cpu"))
    assert not fs_proof(C, bad, CCNN_SEED, Prover, Verifier,
                        FiatShamirTape)[0]


def test_tiny_vgg_pic2_under_fiat_shamir_matches_its_pin(tiny_pic2):
    ok, got = fs_proof(*tiny_pic2, VGG_SEED, Prover, Verifier,
                       FiatShamirTape)
    assert ok
    assert got == FS_TINY_VGG_FFT_PIN


def test_tiny_vgg_pic2_over_4_shards_gives_the_same_fingerprint(tiny_pic2):
    reset_counts()
    with use_mesh(make_mesh(4, devices=["cpu"] * 4)):
        ok, got = fs_proof(*tiny_pic2, VGG_SEED, Prover, Verifier,
                           FiatShamirTape)
    assert ok
    assert got == FS_TINY_VGG_FFT_PIN
    assert COUNTS["host_tape_phases"] > 0


if __name__ == "__main__":
    import gc
    import jax
    from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier
    from zkcnn_tpu.gkr.tape import FiatShamirTape as JFiatShamirTape
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.nn.params import PoolType as JPoolType

    def release(*_):
        """XLA:CPU's programs released at every log line (a layer), so
        that the proof does not run out of memory mappings."""
        jax.clear_caches()
        gc.collect()

    Cj, vj = ccnn_fft(j_models, JPoolType).create(j_random_source(41))
    ok, pin = fs_proof(Cj, vj, CCNN_SEED, JProver, JVerifier,
                       JFiatShamirTape, log=release)
    assert ok
    print("FS_CCNN_FFT_PIN", pin, flush=True)
    del Cj, vj
    Cj, vj = tiny_vgg_fft(j_models, 2).create(j_random_source(41))
    ok, pin = fs_proof(Cj, vj, VGG_SEED, JProver, JVerifier,
                       JFiatShamirTape, log=release)
    assert ok
    print("FS_TINY_VGG_FFT_PIN", pin, flush=True)
