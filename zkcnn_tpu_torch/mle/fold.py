"""Sumcheck MLE folding (counterpart of `zkcnn_tpu/mle/fold.py`).

Each sumcheck operand is a field-value tensor halved once per round
(the reference's mult_array/V_mult of linear_poly,
src/prover.cpp:396-426):

  * the quadratic round message comes from the even/odd pair dots
    h(x) = sum_i (A0_i + x dA_i)(V0_i + x dV_i), and
  * the fold with the verifier's point is X'_i = X_{2i} + r*(X_{2i+1}
    - X_{2i}).

`fold` is the round-kernel module's fold (a CUDA kernel on a CUDA
device, its plain version on the CPU); `coeffs_quadratic_dots` is the
plain version of the round kernel's pair dots.
"""

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.round_kernels import fold, \
    quad_dots_plain as coeffs_quadratic_dots  # noqa: F401


def coeffs_from_dots(d) -> tuple:
    """(c0, c1, c2) host ints from the stacked dots [4, 8]:
    c0 = D00, c1 = D01 + D10 - 2*D00, c2 = D11 - D01 - D10 + D00."""
    d00, d01, d10, d11 = FR.unpack_mont_host(np.asarray(d.cpu()))
    c0 = d00
    c1 = (d01 + d10 - 2 * d00) % FR_P
    c2 = (d11 - d01 - d10 + d00) % FR_P
    return c0, c1, c2


def mle_eval_dev(X, rs):
    """Multilinear extension of X (zero-padded to 2^l rows) at the point
    rs (host ints), lowest variable first (prover::Vres,
    src/prover.cpp:434-457).  Returns the [8] Montgomery tensor."""
    m = 1 << len(rs)
    if X.shape[0] < m:
        X = torch.cat([X, FR.zeros(m - X.shape[0], X.device)])
    X = X[:m].contiguous()
    for r in rs:
        X = fold(X, r)
    return X[0]


def mle_eval(X, rs) -> int:
    return FR.from_mont_host(np.asarray(mle_eval_dev(X, rs).cpu()))
