"""The round-kernel wrappers on the CPU: routing to the plain versions,
operand checks, and the Fr constants hard-coded in the CUDA source."""

import pathlib
import re

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field import round_kernels as rk


def _rand(rng, m):
    return torch.from_numpy(FR.pack_mont_host(
        [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(m)]))


def test_wrappers_route_cpu_tensors_to_plain():
    """On a CPU tensor each wrapper is its plain version and launches
    nothing."""
    rng = np.random.default_rng(9)
    A, V = _rand(rng, 8), _rand(rng, 8)
    rk.reset_launches()
    r = 31337
    for r_prev in (None, r):
        for got, want in zip(rk.fold_round(A, V, r_prev),
                             rk.fold_round_plain(A, V, r_prev)):
            assert torch.equal(got, want)
        for got, want in zip(rk.fold_cubic_round(A[:4], A, V, r_prev),
                             rk.fold_cubic_round_plain(A[:4], A, V, r_prev)):
            assert torch.equal(got, want)
    assert torch.equal(rk.fold(A, r), rk.fold_plain(A, r))
    assert all(n == 0 for n in rk.LAUNCHES.values())


def test_wrappers_reject_bad_operands():
    A = FR.zeros(8, "cpu")
    with pytest.raises(ValueError, match="even"):
        rk.fold(A[:3], 1)
    with pytest.raises(ValueError, match="int32"):
        rk.fold(A.to(torch.int64), 1)
    with pytest.raises(ValueError, match="differ"):
        rk.fold_round(A, A[:4], 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        rk.fold_round(A[:6], A[:6], 1)      # a fold, then a pair of pairs
    with pytest.raises(ValueError, match="M <= K"):
        rk.fold_cubic_round(FR.zeros(16, "cpu"), A, A, 1)
    with pytest.raises(ValueError, match="pair up"):
        rk.fold_cubic_round(FR.zeros(3, "cpu"), A[:6], A[:6], None)


def test_cuda_source_constants_match_fr():
    """The modulus words, R^2, R^3 and R mod p and -p^-1 mod 2^32
    hard-coded in the CUDA sources' Fr header are those of Fr."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "zkcnn_tpu_torch"
           / "csrc" / "fr_arith.cuh").read_text()
    R = 1 << 256
    for name, want in (("P", FR_P), ("R2", FR.R2), ("R3", R ** 3 % FR_P),
                       ("ONE", R % FR_P)):
        body = re.search(name + r"\[NW\] = \{([^}]*)\}", src).group(1)
        words = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
        assert sum(w << (32 * k) for k, w in enumerate(words)) == want, name
    pinv = int(re.search(r"PINV = (0x[0-9a-f]+)u", src).group(1), 16)
    assert (FR_P * pinv + 1) % (1 << 32) == 0
