"""A small vgg under FiatShamirTape in zkcnn_tpu_torch on the CPU
(tolerance 0 throughout): models.vgg on 32x32x1 with one NCONV
convolution of one channel (ReLU), one max pool and the FC tail patched
to 256 -> 8 -> 8 -> 10, random_source(41), FiatShamirTape(b"vgg-fs"),
so that vgg's layer kinds (NCONV, ReLU, max pool, FC) run the per-round
path and its phase calls:

  * with no commitment, the final tape state and counter, the proof size
    and the input claim equal FS_VGG_PIN, made by the JAX package's own
    Prover and Verifier on the same model, seed and tape;
  * with the inner-product commitment, the same with PS and POLY_PS equal
    FS_VGG_IPA_PIN (made by the JAX package too, its MSMs on the host);
  * a witness with one value changed in the output layer is rejected.

`JAX_PLATFORMS=cpu ZKCNN_TPU_MSM_HOST=1 python -m tests.test_torch_fs_vgg`,
from the repository root, remakes both pins with the JAX package.
"""

import torch

from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.gkr import Prover, Verifier, FiatShamirTape
from zkcnn_tpu_torch.nn import random_source

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

TOKENS = ["1", "M"]
SEED = b"vgg-fs"

# the JAX package's runs (python -m tests.test_torch_fs_vgg)
FS_VGG_PIN = {
    "state": "9475adc9b59b282f5c32d91491eb170c80c75a0f3639608b9eddd844e2ecb934"
             "2f902fcea77b92185e28bdccf7a0674b5247f612e5d733096de8372d1b0c25e2",
    "counter": 238, "proof_size": 20288,
    "eval_in": 45831240894859497096102808131910156464206005336164069874409277560406758975300,
}
FS_VGG_IPA_PIN = {
    "state": "fb90424ad6bcb8c46d9ebaf9b9bfb728af4195bc7539844341c2dff9a8886be9"
             "710e3359361b37b2ce38580942efa30b2a69c2f7b1b81e9aa79d863aa22cfe2e",
    "counter": 246, "proof_size": 20288, "poly_ps": 6944,
    "eval_in": 30330086348903800795162095253932577843235132125919424630460366667594926501283,
}


def small_vgg(models):
    """The small vgg, from either package's model zoo."""
    nn = models.vgg(32, 32, 1, 1, TOKENS)
    nn.full_conn[0].channel_out = 8
    nn.full_conn[1].channel_in = 8
    nn.full_conn[1].channel_out = 8
    nn.full_conn[2].channel_in = 8
    return nn


def fs_proof(C, vals, Prover, Verifier, FiatShamirTape, pcs=None):
    """(verified, the run's fingerprint) of one proof under
    FiatShamirTape(SEED), with either package's classes."""
    p = Prover(C, vals)
    tape = FiatShamirTape(SEED)
    v = Verifier(p, C, tape, pcs=pcs)
    ok = v.verify()
    got = {"state": tape.state.hex(), "counter": tape.counter,
           "proof_size": p.proof_size,
           "eval_in": getattr(v, "eval_in", None)}   # unset if rejected
    if pcs is not None:
        got["poly_ps"] = pcs.ps
    return ok, got


def _port_small():
    from zkcnn_tpu_torch.nn import models
    return small_vgg(models).create(random_source(41), device="cpu")


def test_small_vgg_under_fiat_shamir_matches_the_jax_pin():
    C, vals = _port_small()
    ok, got = fs_proof(C, vals, Prover, Verifier, FiatShamirTape)
    assert ok
    assert got == FS_VGG_PIN


def test_small_vgg_with_the_commitment_under_fiat_shamir():
    from zkcnn_tpu_torch.pcs import HyraxPCS
    C, vals = _port_small()
    ok, got = fs_proof(C, vals, Prover, Verifier, FiatShamirTape,
                       HyraxPCS(mode="ipa"))
    assert ok
    assert got == FS_VGG_IPA_PIN


def test_small_vgg_with_a_changed_value_is_rejected():
    C, vals = _port_small()
    bad = list(vals)
    bad[-1] = bad[-1].clone()
    bad[-1][3] = FR.add(bad[-1][3], FR.const(1, "cpu"))
    assert not fs_proof(C, bad, Prover, Verifier, FiatShamirTape)[0]


if __name__ == "__main__":
    import gc
    import sys
    import jax
    from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier
    from zkcnn_tpu.gkr.tape import FiatShamirTape as JFiatShamirTape
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.pcs import HyraxPCS as JHyraxPCS

    class Released(JVerifier):
        """XLA:CPU's programs released at every log line (a layer), so
        that the proof does not run out of memory mappings."""

        def __init__(self, *a, **k):
            super().__init__(*a, log=self.release, **k)

        @staticmethod
        def release(*_):
            jax.clear_caches()
            gc.collect()

    for mode in sys.argv[1:] or ["none", "ipa"]:
        Cj, vj = small_vgg(j_models).create(j_random_source(41))
        pcs = JHyraxPCS(mode="ipa") if mode == "ipa" else None
        ok, pin = fs_proof(Cj, vj, JProver, Released, JFiatShamirTape, pcs)
        assert ok
        print(mode, pin, flush=True)
