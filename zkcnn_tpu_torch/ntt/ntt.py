"""Batched radix-2 field NTT over Fr (counterpart of
`zkcnn_tpu/ntt/ntt.py`).

The reference's recursive scalar `fft` (src/utils.cpp:105-145) as the
same Cooley-Tukey bit-reversed iterative schedule, vectorized over a
batch of transforms and over the butterfly index: logN stage passes of
batched field ops.  Forward transforms serve the FFT layer, inverse
ones (with the 1/N factor) the IFFT layer (calcFFTLayer,
src/neuralNetwork.cpp:950-965).
"""

from functools import lru_cache

import numpy as np
import torch

from ..field import FR, root_of_unity
from ..field.params import FR_P


@lru_cache(maxsize=32)
def _plan(logn: int, inverse: bool):
    N = 1 << logn
    rev = np.zeros(N, np.int64)
    for i in range(1, N):
        rev[i] = (rev[i >> 1] >> 1) | ((i & 1) << (logn - 1))
    w = root_of_unity(logn)
    if inverse:
        w = pow(w, FR_P - 2, FR_P)
    pows = [1] * (N // 2 if N > 1 else 1)
    for i in range(1, len(pows)):
        pows[i] = pows[i - 1] * w % FR_P
    return rev, FR.pack_mont_host(pows)


def _ntt_core(x, logn: int, inverse: bool):
    """x: [batch, N, 8] -> same shape, DFT along axis 1."""
    N = 1 << logn
    b = x.shape[0]
    rev, tw = _plan(logn, inverse)
    dev = x.device
    x = x[:, torch.from_numpy(rev).to(dev), :]
    tw = torch.from_numpy(tw).to(dev)
    for s in range(1, logn + 1):
        half = 1 << (s - 1)
        stride = N >> s               # number of blocks
        v = x.reshape(b, stride, 2, half, FR.n)
        u = v[:, :, 0]
        t = FR.mul(v[:, :, 1], tw[::stride][None, None])
        x = torch.stack([FR.add(u, t), FR.sub(u, t)], dim=2).reshape(
            b, N, FR.n)
    if inverse:
        x = FR.mul(x, FR.const(pow(N, FR_P - 2, FR_P), dev))
    return x


def ntt(x, logn: int):
    """Forward DFT of size 2^logn along axis -2 of [batch, N, 8]."""
    return _ntt_core(x, logn, False)


def intt(x, logn: int):
    """Inverse DFT (including the 1/N factor, like the reference fft
    with flag=true, src/utils.cpp:139-144)."""
    return _ntt_core(x, logn, True)
