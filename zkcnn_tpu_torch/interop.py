"""Carry the JAX package's circuits and witnesses into the port.

Both packages hold a field element as the same Montgomery residue
(R = 2^256): the JAX package as sixteen 16-bit limbs in uint32, the
port as eight 32-bit words in int32.  These helpers convert between
the two views and rebuild a JAX-built `Circuit` as the port's, working
only on numpy arrays and plain attributes -- nothing here imports jax
or zkcnn_tpu.  The tests use them to feed one circuit and witness to
both provers.
"""

import numpy as np
import torch

from .circuit import Circuit, Layer, LayerType


def limbs16_to_words(a) -> np.ndarray:
    """numpy [..., 16] uint32 16-bit limbs -> [..., 8] int32 words."""
    a = np.asarray(a).astype(np.uint32)
    w = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return w.view(np.int32)


def words_to_limbs16(w) -> np.ndarray:
    """[..., 8] int32 words (numpy or tensor) -> [..., 16] uint32 limbs."""
    w = np.asarray(w.cpu() if torch.is_tensor(w) else w)
    w = w.astype(np.int32).view(np.uint32)
    out = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=-1)
    return out.reshape(*w.shape[:-1], 2 * w.shape[-1])


def vals_from_jax(vals, device="cpu"):
    """A JAX witness (list of [N, 16] limb arrays) -> list of [N, 8]
    word tensors on `device`."""
    return [torch.from_numpy(limbs16_to_words(np.asarray(v))).to(device)
            for v in vals]


_LAYER_FIELDS = ("size", "bit_length", "zero_start_id", "need_phase2",
                 "fft_bit_length", "scale", "max_bl_u", "max_bl_v")


def circuit_from_jax(C) -> Circuit:
    """A zkcnn_tpu Circuit -> the port's Circuit: gate tensors, subset
    maps and layer metadata copied, layer types mapped by name."""
    layers = []
    for ly in C.layers:
        out = Layer(LayerType[ly.ty.name])
        for f in _LAYER_FIELDS:
            setattr(out, f, getattr(ly, f))
        out.uni = np.array(ly.uni, np.int64)
        out.bin = np.array(ly.bin, np.int64)
        out.size_u, out.size_v = list(ly.size_u), list(ly.size_v)
        out.bit_length_u = list(ly.bit_length_u)
        out.bit_length_v = list(ly.bit_length_v)
        for f in ("ori_id_u", "ori_id_v"):
            v = getattr(ly, f)
            setattr(out, f, None if v is None else np.array(v, np.int64))
        if getattr(ly, "dp_dims", None) is not None:
            out.dp_dims = tuple(ly.dp_dims)
        layers.append(out)
    return Circuit(layers, list(C.two_mul))
