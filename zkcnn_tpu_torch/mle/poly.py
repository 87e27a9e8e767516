"""Round-message polynomials (host side).

The reference keeps dense coefficient classes linear/quadratic/cubic/
quadruple/quintuple_poly (src/polynomial.h:10-72; the degree-4/5 forms
are defined but unused by the current protocol — kept here for parity).
On the TPU side coefficients are produced directly by the fused round
kernels (mle/fold.py, gkr/engine.py); these helpers evaluate and
combine them as plain Python ints mod p for the verifier's checks.

Coefficient order: index k = coefficient of x^k (low to high).
"""

from typing import Sequence, Tuple

from ..field.params import FR_P


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR_P
    return acc


def poly_add(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    n = max(len(a), len(b))
    a = tuple(a) + (0,) * (n - len(a))
    b = tuple(b) + (0,) * (n - len(b))
    return tuple((x + y) % FR_P for x, y in zip(a, b))


def poly_scale(a: Sequence[int], s: int) -> Tuple[int, ...]:
    return tuple(c * s % FR_P for c in a)


def poly_mul(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % FR_P
    return tuple(out)


def interpolate_linear(v0: int, v1: int) -> Tuple[int, int]:
    """linear_poly from endpoint values (reference prover.cpp:13-15):
    returns (b, a) coefficients of a*x + b with a = v1 - v0, b = v0."""
    return (v0 % FR_P, (v1 - v0) % FR_P)


# degree names for parity with the reference's classes
LINEAR, QUADRATIC, CUBIC, QUADRUPLE, QUINTUPLE = 1, 2, 3, 4, 5
