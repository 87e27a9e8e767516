"""vgg in zkcnn_tpu_torch on the CPU: the tiny config-driven vgg of
tests/test_builder.py::test_vgg_config_build (32x32x1, channels 2, 4, 4,
4, 4 with a max pool after each, the FC tail patched to 4 -> 8 -> 8 ->
10), random_source(41), proven and verified under Tape(b"vgg-tiny")
without a commitment (tolerance 0 throughout):

  * the port's transcript digest and proof size equal TINY_VGG_PIN, made
    with the JAX package on the same model, seed and tape;
  * the same proof with every chunk lowered (GATE_CHUNK and EVAL_CHUNK
    to 1000 rows, the segment sums' finish block to 2^10 rows, the beta
    table's block to 2^10 rows), so that the conv and pool layers' gate
    lists run many chunks and a partial last one, gives the same digest;
    the chunked layer evaluation equals the witness; a witness with one
    value changed is rejected;
  * nn.debug's check_zero_regions and layer_summary equal the JAX
    package's on that model, and a planted nonzero value in a zero
    region is caught at the same (layer, gate).

vgg11 and vgg16 at full size are built by both packages in
tests/test_torch_zoo.py (slow).

`JAX_PLATFORMS=cpu python -m tests.test_torch_vgg`, from the repository
root, remakes TINY_VGG_PIN with the JAX package (about 20 minutes on one
core).
"""

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.nn.debug import check_zero_regions, layer_summary

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

# the tiny vgg, random_source(41), Tape(b"vgg-tiny"), no commitment: the
# JAX package's transcript digest and proof size
TINY_VGG_PIN = {
    "digest": "3f285cda1542d7b5a01ac5413ed997b239e38f05f4e7f7f419ac60aa2f19fd66",
    "proof_size": 54368,
}

TOKENS = ["2", "M", "4", "M", "4", "M", "4", "M", "4", "M"]


def tiny_vgg(models):
    """The tiny vgg of tests/test_builder.py, from either package's
    model zoo."""
    nn = models.vgg(32, 32, 1, 1, TOKENS)
    nn.full_conn[0].channel_in = 1 * 1 * 4
    nn.full_conn[0].channel_out = 8
    nn.full_conn[1].channel_in = 8
    nn.full_conn[1].channel_out = 8
    nn.full_conn[2].channel_in = 8
    return nn


def _prove(C, vals):
    p = Prover(C, list(vals))
    v = Verifier(p, C, Tape(b"vgg-tiny"))
    return v.verify(), {"digest": v.transcript_digest,
                        "proof_size": p.proof_size}


def _port_tiny(**create):
    from zkcnn_tpu_torch.nn import models
    return tiny_vgg(models).create(random_source(41), device="cpu",
                                   **create)


def test_tiny_vgg_proves_to_the_jax_pin():
    C, vals = _port_tiny()
    ok, got = _prove(C, vals)
    assert ok
    assert got == TINY_VGG_PIN


def test_tiny_vgg_with_every_chunk_lowered(monkeypatch):
    from zkcnn_tpu_torch.gkr import kernels
    from zkcnn_tpu_torch.circuit import eval as ev
    from zkcnn_tpu_torch.circuit.eval import eval_normal_layer
    from zkcnn_tpu_torch.field import ops
    from zkcnn_tpu_torch.mle import beta
    chunk = 1000
    monkeypatch.setattr(kernels, "GATE_CHUNK", chunk)
    monkeypatch.setattr(ev, "EVAL_CHUNK", chunk)
    monkeypatch.setattr(ops, "FINISH_BLOCK", 1 << 10)
    monkeypatch.setattr(beta, "BETA_BLOCK_BITS", 10)
    # the layer evaluation reads the gates before the subset compaction,
    # which create() makes last
    C, vals = _port_tiny(only_compute=True)
    for i in (1, 2, 6, 11):
        ly = C.layers[i]
        assert max(ly.uni.shape[0], ly.bin.shape[0]) > chunk
        assert torch.equal(eval_normal_layer(ly, vals[0], vals[i - 1]),
                           vals[i])
    C.init_subset()
    # the conv and pool gate lists run several chunks, the last partial
    big = [i for i, ly in enumerate(C.layers)
           if max(ly.uni.shape[0], ly.bin.shape[0]) > 3 * chunk]
    assert len(big) >= 4 and C.layers[1].bin.shape[0] % chunk
    assert C.layers[0].bit_length > 10          # Liu: blocked beta, finish
    ok, got = _prove(C, vals)
    assert ok
    assert got == TINY_VGG_PIN
    bad = list(vals)
    bad[6] = bad[6].clone()
    bad[6][5] = FR.add(bad[6][5], FR.const(1, "cpu"))
    assert not _prove(C, bad)[0]


def test_debug_matches_jax_and_catches_a_planted_value():
    import jax.numpy as jnp
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.nn.debug import check_zero_regions as j_check, \
        layer_summary as j_summary
    from zkcnn_tpu_torch.interop import limbs16_to_words, words_to_limbs16
    Cj, vj = tiny_vgg(j_models).create(j_random_source(41),
                                       only_compute=True)
    C, vals = _port_tiny()
    assert layer_summary(C) == j_summary(Cj)
    assert check_zero_regions(C, vals) == j_check(Cj, vj) == []
    for a, b in zip(vj, vals):
        np.testing.assert_array_equal(limbs16_to_words(np.asarray(a)),
                                      b.numpy())
    # a nonzero value planted in the zero region of a pool layer
    i = next(k for k, ly in enumerate(C.layers)
             if ly.ty == LayerType.MAX_POOL and ly.zero_start_id + 7
             < ly.size)
    g = C.layers[i].zero_start_id + 7
    vals = list(vals)
    vals[i] = vals[i].clone()
    vals[i][g] = FR.const(1, "cpu")
    vj = list(vj)
    vj[i] = vj[i].at[g].set(jnp.asarray(words_to_limbs16(
        FR.const(1, "cpu"))))
    assert check_zero_regions(C, vals, raise_on_fail=False) == \
        j_check(Cj, vj, raise_on_fail=False) == [(i, g)]
    with pytest.raises(AssertionError, match=f"\\({i}, {g}\\)"):
        check_zero_regions(C, vals)


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

    Cj, vj = tiny_vgg(j_models).create(j_random_source(41))
    jp = JProver(Cj, vj)
    jv = JVerifier(jp, Cj, JTape(b"vgg-tiny"), log=release)
    assert jv.verify()
    print({"digest": jv.transcript_digest, "proof_size": jp.proof_size})
