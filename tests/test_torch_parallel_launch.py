"""The port's mesh code stands alone, and launches on the card its
operands lie on:

  * a fresh interpreter that proves a tiny model over a two-shard CPU
    mesh (`parallel.dryrun`) has imported neither jax nor zkcnn_tpu;
  * (a card needed; skips without one) each CUDA wrapper launches on
    the card of its operands while another card is current: the round
    kernels and the curve kernels on the last card equal their plain
    versions there (with one card, the same with that card current).
    chip_smoke.py's mesh phase runs a proof over two cards when the
    machine has them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parallel_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from zkcnn_tpu_torch.parallel.dryrun import dryrun_multichip\n"
        "import zkcnn_tpu_torch.parallel.sharding\n"
        "dryrun_multichip(2, ['cpu'] * 2, log=lambda *a: None)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zkcnn_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.fixture
def last_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.device_count() - 1)


def test_wrappers_launch_on_their_operands_cuda_card(last_card):
    from zkcnn_tpu_torch.field import FR, FR_P
    from zkcnn_tpu_torch.field import round_kernels as rk
    from zkcnn_tpu_torch.pcs import curve
    from zkcnn_tpu_torch.pcs.msm import FixedBaseMSM, msm_host, points_equal
    rng = np.random.default_rng(7)

    def fe(n):
        return torch.from_numpy(FR.pack_mont_host(
            [int.from_bytes(rng.bytes(31), "little") % FR_P
             for _ in range(n)])).to(last_card)

    rs = [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(6)]
    A, V, m = fe(1 << 12), fe(1 << 12), fe(1 << 4)
    small = torch.from_numpy(np.stack([FR.words_host(int(k)) for k in
                                       rng.integers(1, 1 << 30, 8)]))
    ks = fe(3 * 8).reshape(3, 8, FR.n)
    with torch.cuda.device(0):
        got = rk.round_ladder(A, V, rs)
        got_fs = rk.fold_round(A, V, rs[0])
        got_c = rk.cubic_ladder(m, A, V, rs[:4])
        pts = curve.scalar_mul(curve.base_point(last_card),
                               small.to(last_card))
        sums = FixedBaseMSM(pts).compute(ks)
        pairs = curve.padd(pts[:4], pts[4:])
        torch.cuda.synchronize(last_card)
    for x, y in zip(got, rk.round_ladder_plain(A, V, rs)):
        assert torch.equal(x, y)
    for x, y in zip(got_fs, rk.fold_round_plain(A, V, rs[0])):
        assert torch.equal(x, y)
    for x, y in zip(got_c, rk.cubic_ladder_plain(m, A, V, rs[:4])):
        assert torch.equal(x, y)
    assert got[0].device == last_card and sums.device == last_card
    G = (curve.G1_X, curve.G1_Y)
    assert curve.to_affine_host(pts) == [curve.py_mul(G, int(k))
                                         for k in small[:, 0]]
    assert bool(points_equal(pairs, curve.padd_plain(pts[:4], pts[4:]))
                .all())
    assert bool(points_equal(sums.cpu(), msm_host(pts.cpu(), ks.cpu()))
                .all())
