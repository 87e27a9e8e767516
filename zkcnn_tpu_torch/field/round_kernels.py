"""The two sumcheck round kernels: CUDA wrappers and plain versions.

Counterparts of the JAX package's Pallas kernels (the CUDA source
`csrc/round_kernels.cu` says which kernel each replaces and why it is
shaped as it is):

  * `round_step(A, V, r) -> (dots [4, 8], A', V')`: one quadratic
    sumcheck round.  dots[2x + y] = sum_i mont(A[2i+x], V[2i+y]), the
    value `FR.dot_mont` gives, and X'_i = (1-r) X[2i] + r X[2i+1].
  * `fold(X, r) -> X'`: the same kernel with the dots compiled out.
  * `cubic_round_step(m, V0, V1, r) -> (coeffs [4, 8], V0', V1')`: one
    DOT_PROD phase-1 round (m is indexed modulo its row count; fold m
    itself with `fold`).

`r` is a host int (the verifier's challenge).  A wrapper runs its
plain PyTorch version for a tensor on the CPU and launches the CUDA
kernel for a tensor on a CUDA device: there is no fallback from one to
the other.  Sizes go down to one pair; every output is a canonical
residue, equal bit for bit to the JAX package.  `LAUNCHES` counts the
kernel launches of each wrapper and `SHAPES` records the operand row
counts they launched at ((m,) or (K, M)).
"""

import ctypes
import math

import numpy as np
import torch

from .limbs import FR, N_WORDS

LAUNCHES = {"round_step": 0, "fold": 0, "cubic_round_step": 0}
SHAPES = {k: set() for k in LAUNCHES}
MAX_BLOCKS = 1024          # per-block partials stay <= 128 KiB

_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()


def _count(name: str, shape):
    LAUNCHES[name] += 1
    SHAPES[name].add(shape)


def _lib():
    global _LIB
    if _LIB is None:
        from ..cuda_build import load
        _LIB = load()
    return _LIB


# ---------------------------------------------------------------------
# plain versions


def fold_plain(X, r: int):
    """[2m, 8] -> [m, 8]: X'_i = (1-r) X_{2i} + r X_{2i+1}."""
    dev = X.device
    return FR.lincomb2_scalar(X[0::2], X[1::2], FR.const(1 - r, dev),
                              FR.const(r, dev))


def quad_dots_plain(A, V):
    """The four pair dots [4, 8]: D_xy = sum_i mont(A[2i+x], V[2i+y])."""
    a0, a1 = A[0::2], A[1::2]
    v0, v1 = V[0::2], V[1::2]
    return FR.dot_mont(torch.stack([a0, a0, a1, a1]),
                       torch.stack([v0, v1, v0, v1]))


def round_step_plain(A, V, r: int):
    return quad_dots_plain(A, V), fold_plain(A, r), fold_plain(V, r)


def cubic_terms_plain(m, V1, V0):
    """The four cubic coefficients (c0..c3) [4, 8] of
    h(x) = sum_i (m0 + x dm)[i mod M/2] (a + x da)_i (b + x db)_i."""
    m0, dm = m[0::2], FR.sub(m[1::2], m[0::2])
    a, da = V1[0::2], FR.sub(V1[1::2], V1[0::2])
    b, db = V0[0::2], FR.sub(V0[1::2], V0[0::2])
    reps = a.shape[0] // m0.shape[0]
    m0t, dmt = m0.repeat(reps, 1), dm.repeat(reps, 1)
    e0 = FR.mul(a, b)
    e1 = FR.add(FR.mul(da, b), FR.mul(a, db))
    e2 = FR.mul(da, db)
    c0 = FR.dot_mont(m0t, e0)
    c1 = FR.add(FR.dot_mont(dmt, e0), FR.dot_mont(m0t, e1))
    c2 = FR.add(FR.dot_mont(dmt, e1), FR.dot_mont(m0t, e2))
    c3 = FR.dot_mont(dmt, e2)
    return torch.stack([c0, c1, c2, c3])


def cubic_round_step_plain(m, V0, V1, r: int):
    return cubic_terms_plain(m, V1, V0), fold_plain(V0, r), fold_plain(V1, r)


# ---------------------------------------------------------------------
# CUDA wrappers


def _check(name, *xs):
    for x in xs:
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != N_WORDS:
            raise ValueError(f"{name}: expected [rows, 8] int32 field "
                             f"words, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operand must be contiguous")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: operands on different devices")
        if x.shape[0] < 2 or x.shape[0] % 2:
            raise ValueError(f"{name}: row count must be even and >= 2, "
                             f"got {x.shape[0]}")
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _blocks(npairs: int, threads: int) -> int:
    return max(1, min(MAX_BLOCKS, math.ceil(npairs / threads)))


def _launch(fn, *args):
    rc = fn(*args)
    if rc:
        raise RuntimeError("CUDA launch failed: "
                           + _lib().zk_error_string(rc).decode())


def _r8(r: int):
    return (ctypes.c_uint32 * N_WORDS)(
        *FR.to_mont_host(r).view(np.uint32).tolist())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _empty(rows: int, dev):
    return torch.empty((rows, N_WORDS), dtype=torch.int32, device=dev)


def round_step(A, V, r: int):
    """One quadratic sumcheck round: (dots [4, 8], A', V')."""
    on_cuda = _check("round_step", A, V)
    if A.shape != V.shape:
        raise ValueError(f"round_step: A {tuple(A.shape)} and V "
                         f"{tuple(V.shape)} differ")
    if not on_cuda:
        return round_step_plain(A, V, r)
    lib, dev = _lib(), A.device
    npairs = A.shape[0] // 2
    nb = _blocks(npairs, lib.zk_threads())
    A2, V2 = _empty(npairs, dev), _empty(npairs, dev)
    partials = torch.empty((nb, 4, N_WORDS), dtype=torch.int32, device=dev)
    dots = _empty(4, dev)
    _launch(lib.zk_round_step, A.data_ptr(), V.data_ptr(), A2.data_ptr(),
            V2.data_ptr(), partials.data_ptr(), dots.data_ptr(), npairs, nb,
            _r8(r), _stream(dev))
    _count("round_step", (A.shape[0],))
    return dots, A2, V2


def fold(X, r: int):
    """The fold alone: [2m, 8] -> [m, 8]."""
    if not _check("fold", X):
        return fold_plain(X, r)
    lib, dev = _lib(), X.device
    npairs = X.shape[0] // 2
    X2 = _empty(npairs, dev)
    _launch(lib.zk_fold, X.data_ptr(), X2.data_ptr(), npairs,
            _blocks(npairs, lib.zk_threads()), _r8(r), _stream(dev))
    _count("fold", (X.shape[0],))
    return X2


def cubic_round_step(m, V0, V1, r: int):
    """One DOT_PROD phase-1 round: (coeffs [4, 8], V0', V1')."""
    on_cuda = _check("cubic_round_step", m, V0, V1)
    if V0.shape != V1.shape:
        raise ValueError(f"cubic_round_step: V0 {tuple(V0.shape)} and V1 "
                         f"{tuple(V1.shape)} differ")
    M, K = m.shape[0], V0.shape[0]
    if M > K or (K // 2) % (M // 2):
        raise ValueError(f"cubic_round_step: need M/2 | K/2 and M <= K; "
                         f"got M={M}, K={K}")
    if not on_cuda:
        return cubic_round_step_plain(m, V0, V1, r)
    lib, dev = _lib(), m.device
    npairs = K // 2
    nb = _blocks(npairs, lib.zk_threads())
    V0o, V1o = _empty(npairs, dev), _empty(npairs, dev)
    partials = torch.empty((nb, 4, N_WORDS), dtype=torch.int32, device=dev)
    coeffs = _empty(4, dev)
    _launch(lib.zk_cubic_round_step, m.data_ptr(), V0.data_ptr(),
            V1.data_ptr(), V0o.data_ptr(), V1o.data_ptr(),
            partials.data_ptr(), coeffs.data_ptr(), npairs, M // 2, nb,
            _r8(r), _stream(dev))
    _count("cubic_round_step", (K, M))
    return coeffs, V0o, V1o
