"""Equality (beta) tables and FFT wiring-predicate (phi) tables
(counterpart of `zkcnn_tpu/mle/beta.py`).

Replacements for the reference's scalar table builders (initBetaTable /
initHalfTable, src/utils.cpp:32-51,148-180 and phiGInit / phiPowInit,
src/utils.cpp:53-103), with the reference's conventions:
  * index bits are little-endian: beta[i] = init * prod_k (r_k if bit k
    of i else 1-r_k), built by the doubling recurrence (bit k = high
    bit of step k);
  * phi tables evaluate the FFT butterfly predicate in closed form, so
    FFT/IFFT layers need no materialized gates.

`r` / scalar arguments are host Python ints (the verifier's
randomness); tables are [2^l, 8] Montgomery word tensors on `device`.
"""

from functools import lru_cache

import torch

from ..field import FR, root_of_unity
from ..field.params import FR_P


# the largest table built by the doubling loop alone (bits); above it the
# table is built in blocks of 2^BETA_BLOCK_BITS rows (read at call time):
# the doubling's last step at 2^23 -> 2^24 rows would hold about 8 GB of
# FR.mul temporaries at once (JAX `_BETA_JIT_MAX`)
BETA_BLOCK_BITS = 20


def beta_table(r, init, device):
    """beta[i] = init * prod_k (r_k if bit_k(i) else 1-r_k), i < 2^l.
    Above BETA_BLOCK_BITS challenges, out[j 2^m + i] = lo[i] * hi[j] with
    lo the table of the low m challenges (and init) and hi that of the
    rest: a canonical residue, so the same words as the doubling."""
    ell = len(r)
    if init % FR_P == 0:
        return FR.zeros(1 << ell, device)
    m = BETA_BLOCK_BITS
    if ell > m:
        lo = beta_table(r[:m], init, device)
        hi = beta_table(r[m:], 1, device)
        out = torch.empty((1 << ell, FR.n), dtype=torch.int32, device=device)
        for j in range(hi.shape[0]):
            out[j << m:(j + 1) << m] = FR.mul(lo, hi[j])
        return out
    B = FR.const(init, device)[None]
    for rk in r:
        top = FR.mul_scalar(B, FR.const(rk, device))
        bot = FR.sub(B, top)
        B = torch.cat([bot, top])
    return B


def beta_table_2pt(r0, r1, alpha, beta, device):
    """alpha-scaled eq at r0 plus beta-scaled eq at r1 (same length).

    Mirrors the two-point initBetaTable overload (src/utils.cpp:148-165):
    r1/beta may be absent (beta==0) and r0/alpha may be zero.
    """
    ell = len(r0) if r0 is not None else len(r1)
    out = None
    if alpha % FR_P != 0 and r0 is not None:
        out = beta_table(r0, alpha, device)
    if beta % FR_P != 0 and r1 is not None:
        t = beta_table(r1, beta, device)
        out = t if out is None else FR.add(out, t)
    if out is None:
        out = FR.zeros(1 << ell, device)
    return out


@lru_cache(maxsize=64)
def _omega_powers(n_bits: int, inverse: bool):
    """Host [2^n, 8] Montgomery powers of the 2^n-th root of unity (or
    its inverse)."""
    w = root_of_unity(n_bits)
    if inverse:
        w = pow(w, FR_P - 2, FR_P)
    N = 1 << n_bits
    pows = [1] * N
    for i in range(1, N):
        pows[i] = pows[i - 1] * w % FR_P
    return FR.pack_mont_host(pows)


def phi_table(r, scale: int, n_bits: int, inverse: bool, device):
    """Closed-form FFT wiring predicate table (reference phiGInit).

    Forward (FFT layer): table over u in [0, 2^(n-1)) with
        phi[u] = scale * prod_{k<n} ((1-r_k) + r_k * w^(u*2^k)),
    Inverse (IFFT layer): table over t in [0, 2^n) with
        phi[t] = scale * prod_{k<n-1} ((1-r_k) + r_k * w^(-t*2^k)).

    Contract: sum_u phi[u]*x[u] == MLE of the (I)FFT of x at r.
    """
    n_factors = n_bits - 1 if inverse else n_bits
    assert len(r) >= n_factors
    N = 1 << n_bits
    pw = torch.from_numpy(_omega_powers(n_bits, inverse)).to(device)
    out_bits = n_bits if inverse else n_bits - 1
    u = torch.arange(1 << out_bits, dtype=torch.int64, device=device)
    acc = FR.const(scale, device).expand(1 << out_bits, FR.n)
    for k in range(n_factors):
        g = pw[(u << k) & (N - 1)]
        term = FR.add(FR.const((1 - r[k]) % FR_P, device),
                      FR.mul(FR.const(r[k] % FR_P, device), g))
        acc = FR.mul(acc, term)
    return acc.contiguous()
