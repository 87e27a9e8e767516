"""zkcnn_tpu_torch witness pieces and soundness on the CPU: the
field-domain layer evaluation against the builder's integer replay,
the field matmul that gives the DOT_PROD witness, and the rejection of
a corrupted witness.  Exact equality throughout."""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field.matmul import field_matmul, field_batched_matmul
from zkcnn_tpu_torch.circuit import LayerType
from zkcnn_tpu_torch.circuit.eval import eval_normal_layer
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.nn import models as zoo
from zkcnn_tpu_torch.nn.params import PoolType, ConvType


def test_eval_normal_layer_matches_integer_replay():
    """The field-domain layer evaluation reproduces NeuralNetwork's
    exact integer replay on every normal layer (pre-subset gates)."""
    nn = zoo.ccnn(4, 4, 1, 1, PoolType.MAX)
    C, vals = nn.create(random_source(24), only_compute=True, device="cpu")
    checked = 0
    for i in range(1, C.size):
        ly = C.layers[i]
        if ly.ty in (LayerType.FFT, LayerType.IFFT, LayerType.DOT_PROD):
            continue
        got = eval_normal_layer(ly, vals[0], vals[i - 1] if i > 1 else None)
        assert torch.equal(got, vals[i]), f"layer {i} {ly.ty}"
        checked += 1
    assert checked >= 3


def test_field_matmul_matches_python():
    rng = np.random.default_rng(7)
    M, K, N = 2, 3, 4

    def ints(n):
        return [int.from_bytes(rng.bytes(32), "little") % FR_P
                for _ in range(n)]

    a = [ints(K) for _ in range(M)]
    b = [ints(N) for _ in range(K)]
    A = torch.stack([torch.from_numpy(FR.pack_mont_host(r)) for r in a])
    B = torch.stack([torch.from_numpy(FR.pack_mont_host(r)) for r in b])
    want = [[sum(a[i][k] * b[k][j] for k in range(K)) % FR_P
             for j in range(N)] for i in range(M)]
    assert [FR.unpack_mont_host(r.numpy()) for r in field_matmul(A, B)] \
        == want
    C = field_batched_matmul(torch.stack([A, A]), torch.stack([B, B]))
    assert [[FR.unpack_mont_host(r.numpy()) for r in c] for c in C] == \
        [want, want]


def test_corrupted_witness_is_rejected():
    nn = zoo.singleConv(6, 1, 1, 3, 2, ConvType.NAIVE_FAST)
    C, vals = nn.create(random_source(26), device="cpu")
    bad = vals[1].clone()
    bad[3] = FR.const(12345, "cpu")
    p = Prover(C, [vals[0], bad])
    assert not Verifier(p, C, Tape(b"bad")).verify()
