"""Carry the JAX package's circuits, witnesses, points and commitment
state into the port.

Both packages hold a field element as the same Montgomery residue
(R = 2^256 for Fr, 2^384 for Fp): the JAX package as 16-bit limbs in
uint32 (16 for Fr, 24 for Fp), the port as 32-bit words in int32 (8 and
12).  These helpers convert between the two views and rebuild a
JAX-built `Circuit` or `HyraxPCS` as the port's, working only on numpy
arrays and plain attributes -- nothing here imports jax or zkcnn_tpu.
The tests use them to feed one circuit and witness to both provers and
to commit in one package and verify in the other.
"""

import numpy as np
import torch

from .circuit import Circuit, Layer, LayerType


def limbs16_to_words(a) -> np.ndarray:
    """numpy [..., 2n] uint32 16-bit limbs -> [..., n] int32 words (any
    even width: 16 -> 8 for Fr, 24 -> 12 for Fp)."""
    a = np.asarray(a).astype(np.uint32)
    w = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return w.view(np.int32)


def words_to_limbs16(w) -> np.ndarray:
    """[..., n] int32 words (numpy or tensor) -> [..., 2n] uint32 limbs
    (any width)."""
    w = np.asarray(w.cpu() if torch.is_tensor(w) else w)
    w = w.astype(np.int32).view(np.uint32)
    out = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=-1)
    return out.reshape(*w.shape[:-1], 2 * w.shape[-1])


def vals_from_jax(vals, device="cpu"):
    """A JAX witness (list of [N, 16] limb arrays) -> list of [N, 8]
    word tensors on `device`."""
    return [torch.from_numpy(limbs16_to_words(np.asarray(v))).to(device)
            for v in vals]


def points_from_jax(pts, device="cpu"):
    """JAX points [..., 3, 24] uint32 limbs -> [..., 3, 12] int32 word
    tensor on `device`."""
    return torch.from_numpy(limbs16_to_words(np.asarray(pts))).to(device)


def points_to_jax(pts) -> np.ndarray:
    """Port points [..., 3, 12] -> numpy [..., 3, 24] uint32 limbs."""
    return words_to_limbs16(pts)


def pcs_from_jax(jpcs, device="cpu"):
    """A zkcnn_tpu HyraxPCS after setup (and commit, if it committed)
    -> the port's, on `device`: mode, sizes, generators, row
    commitments and the accounting so far."""
    from .pcs import HyraxPCS
    from .pcs.msm import FixedBaseMSM
    pcs = HyraxPCS(jpcs.mode)
    pcs.device = torch.device(device)
    for f in ("logn", "l_col", "n_cols", "n_rows", "pt", "vt", "ps"):
        setattr(pcs, f, getattr(jpcs, f))
    pcs.gens = points_from_jax(jpcs.gens, device)
    pcs.gen_msm = FixedBaseMSM(pcs.gens)
    if hasattr(jpcs, "row_commits"):
        pcs.row_commits = points_from_jax(jpcs.row_commits, device)
    return pcs


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
