"""The rest of the model zoo in zkcnn_tpu_torch on the CPU: LeNet5 at
pic_cnt=16 (reference src/models.cpp:166-186, BASELINE.json config 2),
lenetCifar (src/models.cpp:188-206) and vgg16 (src/models.cpp:43-146,
BASELINE.json config 4), all random_source(17), max pool (tolerance 0
throughout):

  * the input layer's conversion in chunks (nn.builder.padded_from_int64,
    EVAL_CHUNK lowered to 7 rows) equals the unchunked FR.from_int64 and
    the JAX package's FR.from_int64 word for word, on 0, +-1, +-2^62 and
    random signed values, zero past the values;
  * LeNet5 pic_cnt=16 and lenetCifar as the port builds them: input
    sizes, layer counts, the DOT_PROD layers' sizes and FFT bits, and
    every zero region;
  * (slow) vgg11, vgg16, LeNet5 pic_cnt=16 and lenetCifar built by both
    packages: the same layers, gate arrays and witness through interop,
    compared layer by layer with each layer freed once recorded;
  * (slow) LeNet5 pic_cnt=16 and lenetCifar proven and verified with
    --no-pcs to the digests that chip_smoke.py holds the card to
    (PINNED_ZOO_NO_PCS; LeNet5 pic_cnt=16 about 20 minutes on an 8-core
    CPU, lenetCifar about one), and lenetCifar's digest reproduced by the
    JAX package's own prover and verifier.
"""

import hashlib

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.interop import limbs16_to_words
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.nn import models as zoo
from zkcnn_tpu_torch.nn.debug import check_zero_regions
from zkcnn_tpu_torch.nn.params import PoolType

# --synthetic --seed 17, Tape(b"zkcnn-demo-17"), --no-pcs: the port's
# digests on the CPU, which chip_smoke.py pins the card to
PINNED_ZOO_NO_PCS = {
    "lenet16": {
        "WS": "2302154(2^22)", "PS": "56.0312",
        "digest": "520847a982619b1813c7aa7f82f9f66cd62680f1510aaf2b75c3dc12356d588b"},
    "lenet-cifar": {
        "WS": "209998(2^18)", "PS": "50.0625",
        "digest": "6e44a2527c1a5ed294b45d6dc49394fd4e749cbc8197a789cf30f40a049f094e"},
}


def test_input_layer_conversion_in_chunks(monkeypatch):
    from zkcnn_tpu.field.limbs import FR as JFR
    from zkcnn_tpu_torch.circuit import eval as ev
    from zkcnn_tpu_torch.nn.builder import padded_from_int64
    rng = np.random.default_rng(12)
    edge = [0, 1, -1, 1 << 62, -(1 << 62), (1 << 63) - 1, -(1 << 63) + 1]
    v = np.concatenate([edge, rng.integers(-(1 << 62), 1 << 62, 40),
                        rng.integers(-300, 300, 30)]).astype(np.int64)
    monkeypatch.setattr(ev, "EVAL_CHUNK", 7)
    got = padded_from_int64(v, 7, "cpu")
    assert got.shape == (128, FR.n)
    want = FR.from_int64(v, "cpu")
    assert torch.equal(got[:v.size], want)
    assert not got[v.size:].any()
    np.testing.assert_array_equal(
        limbs16_to_words(np.asarray(JFR.from_int64(v))), want.numpy())
    for x in edge:
        assert FR.unpack_mont_host(FR.from_int64(np.array([x]), "cpu")
                                   .numpy())[0] == x % FR.p


def test_lenet16_and_lenet_cifar_build():
    sizes = {}
    for name, nn, ws, n_layers in (
            ("lenet16", zoo.lenet(32, 32, 1, 16, PoolType.MAX),
             2302154, 24),
            ("lenet-cifar", zoo.lenetCifar(32, 32, 3, 1, PoolType.MAX),
             209998, 28)):
        C, vals = nn.create(random_source(17), only_compute=True,
                            device="cpu")
        assert (C.layers[0].size, C.size) == (ws, n_layers), name
        assert check_zero_regions(C, vals) == [], name
        sizes[name] = [(ly.size, ly.fft_bit_length) for ly in C.layers
                       if ly.ty == LayerType.DOT_PROD]
    assert C.layers[0].bit_length == 18
    # LeNet16's two FFT convolutions: 16 pictures of 6 and of 16 output
    # channels over 2^11 and 2^9 FFT points
    assert sizes["lenet16"] == [(196608, 11), (131072, 9)]


# the full-size zoo that both packages build: (model function, its
# arguments after the pool, WS, input bit length)
ZOO = {
    "vgg11": ("vgg11", (32, 32, 3, 1), 12975498, 24),
    "vgg16": ("vgg16", (32, 32, 3, 1), 20843338, 25),
    "lenet16": ("lenet", (32, 32, 1, 16), 2302154, 22),
    "lenet-cifar": ("lenetCifar", (32, 32, 3, 1), 209998, 18),
}


def _layer_records(net, create, words):
    """Builds `net` through `create` and returns a record a layer: its
    type, size, bit length, zero start and FFT bits, its gate counts, a
    sha256 of its gate arrays (uni, bin, ori_id_u, ori_id_v as int64)
    and one of its values as the port's words.  A layer is recorded and
    its gates and values freed as soon as no later layer reads them (its
    integer values stay), so that vgg16's 3.1e8 gate rows are never held
    whole."""
    digests, real = {}, net._int_eval

    def retire(k):
        ly = net.C.layers[k]
        h = hashlib.sha256()
        for a in (ly.uni, ly.bin, ly.ori_id_u, ly.ori_id_v):
            h.update(b"none" if a is None else
                     np.ascontiguousarray(a, np.int64).tobytes())
        v = np.ascontiguousarray(words(net.vals[k]), np.int32)
        digests[k] = (len(ly.uni), len(ly.bin), h.hexdigest(),
                      v.shape, hashlib.sha256(v.tobytes()).hexdigest())
        ly.uni, ly.bin, net.vals[k] = ly.uni[:0], ly.bin[:0], None

    def int_eval(layer, lid):
        real(layer, lid)
        for k in range(1, lid - 1):      # the input layer is set last
            if k not in digests:
                retire(k)

    net._int_eval = int_eval
    C, _ = create()
    for k in range(C.size):
        if k not in digests:
            retire(k)
    return [(ly.ty.name, ly.size, ly.bit_length, ly.zero_start_id,
             ly.fft_bit_length) + digests[k] for k, ly in enumerate(C.layers)]


@pytest.mark.slow
@pytest.mark.parametrize("name", list(ZOO))
def test_circuits_of_both_packages_agree(name):
    """random_source(17), max pool: the JAX package's circuit and witness
    equal the port's layer by layer (types, sizes, zero regions, gate
    counts, gate arrays, and values carried across by interop), each
    package's build freed before the other's; vgg16 about 10 minutes
    and about 17 GB of host memory."""
    import gc
    import jax
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.nn.params import PoolType as JPoolType
    fn, dims, ws, bl = ZOO[name]
    j_net = getattr(j_models, fn)(*dims, JPoolType.MAX)
    want = _layer_records(
        j_net, lambda: j_net.create(j_random_source(17), only_compute=True),
        lambda v: limbs16_to_words(np.asarray(v)))
    del j_net
    jax.clear_caches()
    gc.collect()
    net = getattr(zoo, fn)(*dims, PoolType.MAX)
    got = _layer_records(
        net, lambda: net.create(random_source(17), only_compute=True,
                                device="cpu"),
        lambda v: v.numpy())
    assert got[0][1:3] == (ws, bl)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, (name, k)


@pytest.mark.slow
def test_lenet_cifar_no_pcs_digest_of_the_jax_package():
    """The JAX package's own prover and verifier, on its own lenetCifar
    circuit and witness under Tape(b"zkcnn-demo-17") with no commitment
    (what demo_lenet --synthetic --seed 17 --model lenet-cifar --no-pcs
    runs), give PINNED_ZOO_NO_PCS's digest and proof size.  XLA:CPU's
    programs are released at every layer so that the proof does not run
    out of memory mappings; about half an hour on an 8-core CPU."""
    import gc
    import jax
    from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier, \
        Tape as JTape
    from zkcnn_tpu.nn import models as j_models
    from zkcnn_tpu.nn import random_source as j_random_source
    from zkcnn_tpu.nn.params import PoolType as JPoolType

    def release(*_):
        jax.clear_caches()
        gc.collect()

    Cj, vj = j_models.lenetCifar(32, 32, 3, 1, JPoolType.MAX).create(
        j_random_source(17))
    jp = JProver(Cj, vj, own_vals=True)
    jv = JVerifier(jp, Cj, JTape(b"zkcnn-demo-17"), log=release)
    assert jv.verify()
    pin = PINNED_ZOO_NO_PCS["lenet-cifar"]
    assert (f"{jp.proof_size / 1024.0:.4f}", jv.transcript_digest) == (
        pin["PS"], pin["digest"])


@pytest.mark.slow
@pytest.mark.parametrize("name,argv", [
    ("lenet16", ["--pic-cnt", "16"]),
    ("lenet-cifar", ["--model", "lenet-cifar"])])
def test_zoo_no_pcs_digests_pinned(name, argv):
    from zkcnn_tpu_torch.cli import demo_lenet
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--no-pcs",
                           "--cpu"] + argv)
    pin = PINNED_ZOO_NO_PCS[name]
    assert (res["row"]["WS"], res["row"]["PS"], res["digest"]) == (
        pin["WS"], pin["PS"], pin["digest"])
