"""vgg with more than one picture in zkcnn_tpu_torch on the CPU: every
convolution an FFT one (PADDING -> FFT -> DOT_PROD -> IFFT -> ADD_BIAS,
the choice of both packages' models.py when pic_parallel > 1), the path
that vgg16 at pic_cnt=8 takes at full width.  The model is a short
tiny vgg: 32x32x1 pictures, two sections of two channels with a max pool
after each ("2", "M", "2", "M"), the FC tail patched to 128 -> 8 -> 8 ->
10, random_source(41); tolerance 0 throughout:

  * at pic_cnt=2 (slow: 8) both packages' builders give every
    convolution as an FFT one and the same circuit (layer types and
    sizes, fft_bit_length, dp_dims, zero starts, the gate arrays) and the
    same witness, as words through `interop`;
  * the port proves and verifies pic_cnt=2 under Tape(b"vgg-tiny-fft")
    to TINY_VGG_FFT_PIN, the JAX package's transcript digest and proof
    size; a witness with one value of the FFT layer under the last
    DOT_PROD layer changed is rejected at that DOT_PROD layer's cubic
    sumcheck (the per-round path, which stops at the first failed
    round);
  * the same proof with its witness, gates and inits split over 4 CPU
    shards (slow: over 2) gives the same digest and proof size.

It is shorter than the tiny vgg of tests/test_torch_vgg.py (five
sections of 2-4 channels): at pic_cnt=2 that one takes about a minute a
proof on one core.  Even so each test here takes 45-65 s on one core
(a proof of this model about 45 s, the JAX package's build about 40 s);
the two proofs share one build of the port's circuit and witness.  The
slow tests run pic_cnt=8 through both builders (the JAX package's NTTs
at pic_cnt=8 take over a minute) and the proof over 2 shards (a third
proof, 50-60 s).

`JAX_PLATFORMS=cpu python -m tests.test_torch_vgg_fft`, from the
repository root, remakes TINY_VGG_FFT_PIN with the JAX package.
"""

import hashlib

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.parallel import make_mesh, use_mesh

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores
torch.set_num_threads(1)

# the short tiny vgg at pic_cnt=2, random_source(41), Tape(b"vgg-tiny-fft"),
# no commitment: the JAX package's transcript digest and proof size
TINY_VGG_FFT_PIN = {
    "digest": "82fa2f97e4ebec9ad1f76da9dfe845c860750c62793f62aa48626cf99abd32d5",
    "proof_size": 42944,
}

TOKENS_FFT = ["2", "M", "2", "M"]
FFT_PATH = [LayerType.PADDING, LayerType.FFT, LayerType.DOT_PROD,
            LayerType.IFFT, LayerType.ADD_BIAS]


def tiny_vgg_fft(models, pic_cnt: int):
    """The short tiny vgg (module docstring) from either package's model
    zoo."""
    nn = models.vgg(32, 32, 1, pic_cnt, TOKENS_FFT)
    nn.full_conn[0].channel_in = 8 * 8 * 2
    nn.full_conn[0].channel_out = 8
    nn.full_conn[1].channel_in = 8
    nn.full_conn[1].channel_out = 8
    nn.full_conn[2].channel_in = 8
    return nn


def _port(pic_cnt: int, **create):
    from zkcnn_tpu_torch.nn import models
    return tiny_vgg_fft(models, pic_cnt).create(random_source(41),
                                                device="cpu", **create)


@pytest.fixture(scope="module")
def pic2():
    """The port's circuit and witness at pic_cnt=2, built once for the
    proofs of this file (none of them writes to it)."""
    return _port(2)


def _prove(C, vals, tape=None, log=None):
    p = Prover(C, list(vals))
    v = Verifier(p, C, tape or Tape(b"vgg-tiny-fft"),
                 **({"log": log} if log else {}))
    return v.verify(), {"digest": v.transcript_digest,
                        "proof_size": p.proof_size}


def _layer(ly):
    """What both packages' circuits must agree on for one layer: its
    kind, sizes, FFT bits, DOT_PROD dims, zero start and a sha256 of its
    gate arrays."""
    h = hashlib.sha256()
    for g in (ly.uni, ly.bin):
        h.update(np.ascontiguousarray(np.asarray(g, np.int64)).tobytes())
    return (ly.ty.name, ly.size, ly.bit_length, ly.fft_bit_length,
            tuple(getattr(ly, "dp_dims", None) or ()), ly.zero_start_id,
            h.hexdigest())


def _both_builders_agree(pic: int):
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu_torch.interop import limbs16_to_words
    Cj, vj = tiny_vgg_fft(j_models, pic).create(j_random_source(41),
                                                only_compute=True)
    C, vals = _port(pic, only_compute=True)
    kinds = [ly.ty for ly in C.layers]
    # two convolutions, each the five layers of the FFT path
    starts = [i for i, k in enumerate(kinds) if k == LayerType.PADDING]
    assert len(starts) == 2
    for s in starts:
        assert kinds[s:s + 5] == FFT_PATH
        assert C.layers[s + 2].dp_dims[0] == pic
    assert LayerType.NCONV not in kinds
    assert [_layer(ly) for ly in C.layers] == \
        [_layer(ly) for ly in Cj.layers]
    assert len(vals) == len(vj)
    for a, b in zip(vj, vals):
        np.testing.assert_array_equal(limbs16_to_words(np.asarray(a)),
                                      b.numpy())


def test_both_builders_give_the_fft_path_and_the_same_witness():
    _both_builders_agree(2)


@pytest.mark.slow
def test_both_builders_agree_at_pic8():
    """pic_cnt=8, the count of vgg16's multi-card configuration (about
    1.5 minutes on one core: the JAX package's NTTs at pic_cnt=8)."""
    _both_builders_agree(8)


def test_pic2_proves_to_the_jax_pin_and_rejects_a_changed_fft_value(pic2):
    C, vals = pic2
    ok, got = _prove(C, vals)
    assert ok
    assert got == TINY_VGG_FFT_PIN
    # one value of the FFT layer under the last DOT_PROD layer changed:
    # the per-round path checks the layers from the output down, and the
    # DOT_PROD layer's cubic (phase 1) sumcheck is the first to read it
    i = max(k for k, ly in enumerate(C.layers)
            if ly.ty == LayerType.DOT_PROD)
    assert C.layers[i - 1].ty == LayerType.FFT
    bad = list(vals)
    bad[i - 1] = bad[i - 1].clone()
    bad[i - 1][3] = FR.add(bad[i - 1][3], FR.const(1, "cpu"))
    tape = Tape(b"vgg-tiny-fft")
    tape.precomputable = False
    said = []
    ok, _ = _prove(C, bad, tape, log=said.append)
    assert not ok
    assert [s for s in said if str(s).startswith("FAIL")] == \
        [f"FAIL phase1 layer {i} bit 0"], said[-3:]


def _split_proof(C, vals, D: int):
    with use_mesh(make_mesh(D, devices=["cpu"] * D)):
        ok, got = _prove(C, vals)
    assert ok
    assert got == TINY_VGG_FFT_PIN


def test_pic2_split_over_4_shards_gives_the_same_digest(pic2):
    _split_proof(*pic2, 4)


@pytest.mark.slow
def test_pic2_split_over_2_shards_gives_the_same_digest(pic2):
    _split_proof(*pic2, 2)


if __name__ == "__main__":
    import gc
    import jax
    from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier, \
        Tape as JTape
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source

    def release(*_):
        """XLA:CPU's programs released at every log line (a layer), so
        that the proof does not run out of memory mappings."""
        jax.clear_caches()
        gc.collect()

    Cj, vj = tiny_vgg_fft(j_models, 2).create(j_random_source(41))
    jp = JProver(Cj, vj)
    jv = JVerifier(jp, Cj, JTape(b"vgg-tiny-fft"), log=release)
    assert jv.verify()
    print({"digest": jv.transcript_digest, "proof_size": jp.proof_size})
