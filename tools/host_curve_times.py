"""Times the host (Python-integer) curve work of zkcnn_tpu_torch's
commitment set-up under a Fiat-Shamir tape, on this machine's CPU: the
hash-to-curve of the 512 generators of a LeNet5 commitment (each a
square root and a cofactor multiplication), with `curve.py_mul` and with
the affine double-and-add over `py_add` that it replaced, one cofactor
multiplication each way, and the canonical encoding of 512 points (the
commitment's encode-and-absorb).

    python tools/host_curve_times.py [--n 512]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from zkcnn_tpu_torch.pcs import curve  # noqa: E402


def affine_mul(P, k, p=curve.FP_P):
    """k P by the affine double-and-add over py_add (an inversion a step)."""
    acc = None
    while k:
        if k & 1:
            acc = curve.py_add(acc, P, p)
        P = curve.py_add(P, P, p)
        k >>= 1
    return acc


def seconds(fn):
    t = time.perf_counter()
    out = fn()
    return time.perf_counter() - t, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512,
                    help="generators (a LeNet5 commitment has 512)")
    n = ap.parse_args().n
    G = (curve.G1_X, curve.G1_Y)
    gens = lambda: [curve.hash_to_group_host(b"zkcnn-hyrax-gen", i)
                    for i in range(n)]
    jac_s, pts = seconds(gens)
    py_mul = curve.py_mul
    curve.py_mul = affine_mul
    try:
        aff_s, pts_aff = seconds(gens)
    finally:
        curve.py_mul = py_mul
    assert pts == pts_aff
    cof_jac, _ = seconds(lambda: py_mul(G, curve.G1_COFACTOR))
    cof_aff, _ = seconds(lambda: affine_mul(G, curve.G1_COFACTOR))
    packed = torch.from_numpy(curve.affine_pack(pts))
    enc_s, _ = seconds(lambda: curve.encode_points_host(packed))
    print(f"hash-to-curve of {n} generators: {jac_s:.4f} s with py_mul, "
          f"{aff_s:.4f} s with the affine double-and-add (the same points)")
    print(f"one cofactor multiplication: {cof_jac * 1e3:.3f} ms with py_mul, "
          f"{cof_aff * 1e3:.3f} ms affine")
    print(f"canonical encoding of {n} points: {enc_s:.4f} s")


if __name__ == "__main__":
    main()
