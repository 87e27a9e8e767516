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
    for got, want in zip(rk.round_step(A, V, r),
                         rk.round_step_plain(A, V, r)):
        assert torch.equal(got, want)
    assert torch.equal(rk.fold(A, r), rk.fold_plain(A, r))
    for got, want in zip(rk.cubic_round_step(A[:4], A, V, r),
                         rk.cubic_round_step_plain(A[:4], A, V, r)):
        assert torch.equal(got, want)
    assert all(n == 0 for n in rk.LAUNCHES.values())


def test_wrappers_reject_bad_operands():
    A = FR.zeros(8, "cpu")
    with pytest.raises(ValueError, match="even"):
        rk.fold(A[:3], 1)
    with pytest.raises(ValueError, match="int32"):
        rk.fold(A.to(torch.int64), 1)
    with pytest.raises(ValueError, match="differ"):
        rk.round_step(A, A[:4], 1)
    with pytest.raises(ValueError, match="M <= K"):
        rk.cubic_round_step(FR.zeros(16, "cpu"), A, A, 1)


def test_cuda_source_constants_match_fr():
    """The modulus words, R^2 mod p and -p^-1 mod 2^32 hard-coded in the
    CUDA source are those of Fr."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "zkcnn_tpu_torch"
           / "csrc" / "round_kernels.cu").read_text()
    body = re.search(r"__constant__ u32 P\[NW\] = \{([^}]*)\}", src).group(1)
    words = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    assert sum(w << (32 * k) for k, w in enumerate(words)) == FR_P
    body = re.search(r"__constant__ u32 R2\[NW\] = \{([^}]*)\}", src).group(1)
    words = [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    assert sum(w << (32 * k) for k, w in enumerate(words)) == FR.R2
    pinv = int(re.search(r"PINV = (0x[0-9a-f]+)u", src).group(1), 16)
    assert (FR_P * pinv + 1) % (1 << 32) == 0
