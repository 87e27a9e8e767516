"""Witness evaluation: replay gate tensors against layer values
(counterpart of `zkcnn_tpu/circuit/eval.py`).

calcNormalLayer / calcDotProdLayer / calcFFTLayer (reference
src/neuralNetwork.cpp:918-965) as gathers, batched field muls and one
exact segment sum per layer (in gate chunks); FFT layers use the batched NTT
(under a mesh, small batches the stage-sharded one) and the DOT_PROD
layer one batched field matmul.

Index arrays here are PRE-subset (original ids), exactly like the
reference, which evaluates witnesses before initSubset runs.
"""

from functools import lru_cache

import torch

from ..field import FR
from ..field.ops import segment_cols, segment_add, segment_finish
from ..ntt import ntt, intt
from .ir import Layer, LayerType, UNI_G, UNI_U, UNI_LU, UNI_SC, \
    BIN_G, BIN_U, BIN_V, BIN_SC, BIN_L


@lru_cache(maxsize=1)
def _two_mul_host(q_bit_size: int):
    from .ir import Circuit
    return FR.pack_mont_host(Circuit.init(q_bit_size, 1).two_mul)


def two_mul_table(device, q_bit_size: int = 220):
    """[2(q+1), 8] table of the +-2^k gate constants on `device`."""
    return torch.from_numpy(_two_mul_host(q_bit_size)).to(device)


EVAL_CHUNK = 1 << 19    # gate rows a step at a time (read at call time):
                        # a vgg NCONV layer's 2^25 gates stream through one
                        # column accumulator instead of one FR.mul each


def eval_normal_layer(layer: Layer, val0, val_prev):
    """calcNormalLayer (reference src/neuralNetwork.cpp:918-935); output
    padded to 2^bit_length.  A gate reads layer 0 or the previous
    layer per its source code; table = [val0 ; val_prev] so each gate
    class is one offset gather.  Gates go EVAL_CHUNK rows at a time into
    one exact column accumulator with one modular finish (JAX
    `_eval_uni_chunk`, `_eval_bin_chunk`)."""
    dev = val0.device
    out_pow2 = 1 << max(layer.bit_length, 0)
    tm = two_mul_table(dev)
    if val_prev is None:
        val_prev = val0[:1]
    n0 = val0.shape[0]
    table = torch.cat([val0, val_prev])
    acc = segment_cols(out_pow2, dev)
    step = EVAL_CHUNK
    for s in range(0, layer.uni.shape[0], step):
        uni = torch.as_tensor(layer.uni[s:s + step], device=dev)
        idx = uni[:, UNI_U] + torch.where(uni[:, UNI_LU] == 0, 0, n0)
        c = FR.mul(table[idx], tm[uni[:, UNI_SC]])
        segment_add(acc, c, uni[:, UNI_G])
    for s in range(0, layer.bin.shape[0], step):
        b = torch.as_tensor(layer.bin[s:s + step], device=dev)
        a = table[b[:, BIN_U] + torch.where(b[:, BIN_L] == 0, 0, n0)]
        v = table[b[:, BIN_V]
                  + torch.where((b[:, BIN_L] & 1) == 0, 0, n0)]
        c = FR.mul(FR.mul(a, v), tm[b[:, BIN_SC]])
        segment_add(acc, c, b[:, BIN_G])
    return FR.mul(segment_finish(acc), FR.const(layer.scale, dev))


def _pad_rows(x, rows: int):
    pad = rows - x.shape[0]
    return torch.cat([x, FR.zeros(pad, x.device)]) if pad > 0 else x


def eval_dot_prod_layer(layer: Layer, val_prev, pic_parallel: int,
                        channel_out: int, channel_in: int):
    """calcDotProdLayer (reference src/neuralNetwork.cpp:937-948),
    computed structurally: out[p,co,t] = sum_ci x^[p,ci,t] * w^[co,ci,t]
    is one field matmul [pic, ci] x [ci, co] per frequency t.  val_prev
    is the FFT layer output, layout [(pic | pic+co) * channel_in,
    fft_len, 8] row-major."""
    from ..field.matmul import field_batched_matmul
    L = 1 << layer.fft_bit_length
    cnt = pic_parallel + channel_out
    x = val_prev[: cnt * channel_in * L].reshape(cnt, channel_in, L, FR.n)
    x_hat = x[:pic_parallel].permute(2, 0, 1, 3)       # [L, pic, ci]
    w_hat = x[pic_parallel:].permute(2, 1, 0, 3)       # [L, ci, co]
    out = field_batched_matmul(x_hat, w_hat)
    out = out.permute(1, 2, 0, 3).reshape(
        pic_parallel * channel_out * L, FR.n)
    return _pad_rows(out, 1 << layer.bit_length)


def _witness_ntt(x, fb: int, inverse: bool):
    """The witness's NTT: under an active mesh of D shards, a batch of
    fewer than 2D transforms of at least D^2 points (D a power of two)
    takes the stage-sharded NTT (`parallel.stage_sharded_ntt`, split
    within each transform), and any other batch the batched NTT with its
    transforms split over the shards where D divides the batch
    (`parallel.sharded_ntt`; the JAX package's GSPMD splits the slot
    axis).  Each gives the words of the batched NTT on one device."""
    from ..parallel.context import active_mesh
    mesh = active_mesh()
    if mesh is not None:
        from ..parallel.sharding import sharded_ntt, stage_sharded_ntt
        D = mesh.size
        if D & (D - 1) == 0 and (1 << fb) >= D * D and x.shape[0] < 2 * D:
            return stage_sharded_ntt(mesh, x, fb, inverse)
        return sharded_ntt(mesh, x, fb, inverse)
    return intt(x, fb) if inverse else ntt(x, fb)


def eval_fft_layer(layer: Layer, val_prev):
    """calcFFTLayer (reference src/neuralNetwork.cpp:950-965).

    FFT: slots of lenh values zero-padded to len, forward NTT.
    IFFT: slots of len values, inverse NTT, keep first half.
    """
    fb = layer.fft_bit_length
    L = 1 << fb
    Lh = L >> 1
    if layer.ty == LayerType.FFT:
        n_slots = layer.size >> fb
        x = val_prev[: n_slots * Lh].reshape(n_slots, Lh, FR.n)
        x = torch.cat([x, torch.zeros_like(x)], dim=1)
        out = _witness_ntt(x, fb, False).reshape(n_slots * L, FR.n)
    else:
        n_slots = layer.size >> (fb - 1)
        x = val_prev[: n_slots * L].reshape(n_slots, L, FR.n)
        out = _witness_ntt(x, fb, True)[:, :Lh].reshape(
            n_slots * Lh, FR.n)
    return _pad_rows(out, 1 << layer.bit_length)
