"""Sumcheck MLE folding (counterpart of `zkcnn_tpu/mle/fold.py`).

Each sumcheck operand is a field-value tensor halved once per round
(the reference's mult_array/V_mult of linear_poly,
src/prover.cpp:396-426):

  * the quadratic round message comes from the even/odd pair dots
    h(x) = sum_i (A0_i + x dA_i)(V0_i + x dV_i), and
  * the fold with the verifier's point is X'_i = X_{2i} + r*(X_{2i+1}
    - X_{2i}).

`fold` and `fold_ladder` are the round-kernel module's folds (CUDA
kernels on a CUDA device, their plain versions on the CPU);
`coeffs_quadratic_dots` is the plain version of the round kernel's pair
dots.
"""

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.round_kernels import fold, fold_ladder, \
    quad_dots_plain as coeffs_quadratic_dots  # noqa: F401


def quad_from_dots(d00: int, d01: int, d10: int, d11: int) -> tuple:
    """(c0, c1, c2) of h(x) from the four pair dots as host ints:
    c0 = D00, c1 = D01 + D10 - 2*D00, c2 = D11 - D01 - D10 + D00."""
    return (d00, (d01 + d10 - 2 * d00) % FR_P,
            (d11 - d01 - d10 + d00) % FR_P)


def mle_eval_dev(X, rs):
    """Multilinear extension of X (zero-padded to 2^l rows) at the point
    rs (host ints), lowest variable first (prover::Vres,
    src/prover.cpp:434-457): one fold ladder.  Returns the [8]
    Montgomery tensor."""
    m = 1 << len(rs)
    if X.shape[0] < m:
        X = torch.cat([X, FR.zeros(m - X.shape[0], X.device)])
    X = X[:m].contiguous()
    return fold_ladder(X, list(rs))[0] if rs else X[0]


def mle_eval(X, rs) -> int:
    return FR.from_mont_host(np.asarray(mle_eval_dev(X, rs).cpu()))
