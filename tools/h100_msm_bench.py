#!/usr/bin/env python3
"""g1_msm and the fixed-base table on one NVIDIA GPU, at the shapes of the
port's proofs, in this tree and (with --parent) in a checkout of another
commit, on the same operands.

    python3 tools/h100_msm_bench.py [--parent DIR] [--out FILE]

Needs a CUDA device and nvcc (each tree builds its own kernels).  Every
case runs in a process of its tree's own, the trees in turns: this tree
alone, or parent, this, this, parent.  The operands come from
numpy.random.default_rng(SEED): the bases are s_i G for random s_i; the
scalars of a case are of one of three kinds:

  witness  a quantized input layer: 40% zeros, the rest uniform signed
           values below 2^12 (Fr's r - |v| for a negative v);
  dense    uniform 255-bit residues below r;
  opening  dense, with row 0 zero over the second half of the bases and
           row 1 over the first (the inner-product opening's rows).

Each case is timed between two CUDA events over back-to-back calls after
a warm-up call, beside the rows' affine coordinates' sha256, which must
agree between the trees (the same group elements).  Each tree also times
its setup table at 8192, 4096 and 512 bases (`curve.table_kernel`, with
the entries to Z = 1 where the tree does that).  Beside each case: the
nonzero 4-bit digits of its scalars a term, as they are and with each
term's sign taken (min(k, r - k)), which is what the sign saves.  Prints
a line a measurement and writes them all as JSON to --out (default
chiprun_out/h100_msm_bench.json).
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

SEED = 18
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# (name, rows, bases, kind)
CASES = [("vgg16 commit", 4096, 8192, "witness"),
         ("vgg11 commit", 4096, 4096, "witness"),
         ("vgg16 pic_cnt=8 commit", 8192, 8192, "witness"),
         ("a shard's commit", 1024, 8192, "dense"),
         ("LeNet commit", 512, 512, "witness"),
         ("LeNet, dense", 512, 512, "dense"),
         ("vgg16 opening, round 0", 2, 8193, "opening"),
         ("LeNet opening, round 0", 2, 513, "opening"),
         ("vgg16 verifier", 1, 8192, "dense"),
         ("vgg16 generators", 8192, 1, "dense")]
TABLES = (8192, 4096, 512)


def scalars(np, rng, R, N, kind):
    """[R, N] int64 witness values, or [R, N, 8] dense words (int32)."""
    if kind == "witness":
        v = rng.integers(-(1 << 12) + 1, 1 << 12, size=(R, N))
        v[rng.random((R, N)) < 0.4] = 0
        return v
    w = rng.integers(0, 1 << 32, size=(R, N, 8), dtype=np.uint64)
    w[..., 7] %= R_MOD >> 224                      # below r
    if kind == "opening":
        w[0, N // 2:] = 0
        w[1, :N // 2] = 0
    return w.astype(np.uint32).view(np.int32)


def digits(ints):
    """(nonzero digits a term as they are, with each term's sign) of the
    plain scalars `ints`."""
    count = lambda k: sum((k >> (4 * j)) & 15 != 0 for j in range(64))  # noqa
    plain = sum(map(count, ints))
    signed = sum(count(min(k, R_MOD - k) if k else 0) for k in ints)
    return plain / len(ints), signed / len(ints)


def plain_ints(np, k, kind):
    """A sample of up to 16384 of the case's scalars as plain integers
    (the dense words are Montgomery words: k = w 2^-256 mod r)."""
    if kind == "witness":
        flat = k.reshape(-1)
        return [int(v) % R_MOD for v in flat[::max(1, flat.size // 16384)]]
    words = k.reshape(-1, 8)[::max(1, k.size // 8 // 16384)]
    r_inv = pow(1 << 256, -1, R_MOD)
    return [int.from_bytes(w.tobytes(), "little") * r_inv % R_MOD
            for w in words]


def witness_mont(torch, FR, v):
    """Montgomery words on the card of small signed values v (|v| < 2^32,
    negative ones as r - |v|): the plain words times R^2 in one
    Montgomery product."""
    a = torch.from_numpy(v).cuda()
    m = a.abs()
    w = torch.zeros(a.shape + (8,), dtype=torch.int64, device="cuda")
    w[..., 0] = m
    r_words = [(R_MOD >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    neg = torch.tensor(r_words, device="cuda").expand_as(w).clone()
    neg[..., 0] = (r_words[0] - m) & 0xFFFFFFFF      # r's word 0 is 1
    neg[..., 1] -= (m > r_words[0]).to(torch.int64)   # its word 1 is 2^32 - 1
    w = torch.where((a < 0)[..., None], neg, w)
    w = (w - ((w >> 31) << 32)).to(torch.int32)
    r2 = torch.from_numpy(FR.words_host(FR.R2)).cuda()
    return FR.mul(w, r2)


def child(tree, out):
    """The cases in `tree` (a process of its own): {case: measurements}."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.field import FR
    from zkcnn_tpu_torch.pcs import curve, msm
    cuda_build.build()
    got = {}

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            res = fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters, res

    rng = np.random.default_rng(SEED)
    logs = scalars(np, rng, 1, 8193, "dense")[0]
    bases = curve.scalar_mul(curve.base_point("cuda"),
                             torch.from_numpy(logs).cuda())
    for n in TABLES:
        ms, _ = timed(lambda: curve.table_kernel(bases[:n]), 5)
        got[f"table {n}"] = {"ms": ms}
    for name, R, N, kind in CASES:
        rng = np.random.default_rng([SEED, R, N])
        k = scalars(np, rng, R, N, kind)
        if kind == "witness":
            mont = torch.cat([witness_mont(torch, FR, k[r:r + 256])
                              for r in range(0, R, 256)])
        else:
            mont = torch.from_numpy(k).cuda()
        fixed = msm.FixedBaseMSM(bases[:N])
        ms, res = timed(lambda: fixed.compute(mont), 2 if R * N > 1 << 22
                        else 10)
        enc = curve.encode_points_host(res)
        got[name] = {"ms": ms, "shape": [R, N], "kind": kind,
                     "sha256": hashlib.sha256(enc).hexdigest()}
        del fixed, mont
    got["plain_calls"] = sum(curve.PLAIN_CALLS.values())
    with open(out, "w") as f:
        json.dump(got, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of the commit to compare")
    ap.add_argument("--out", default="chiprun_out/h100_msm_bench.json")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(*args.child)
    import numpy as np
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0] if smi.strip() else "no nvidia-smi"
    order = [("this", here)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        order = [("parent", parent), ("this", here), ("this", here),
                 ("parent", parent)]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = []
    for i, (which, tree) in enumerate(order):
        out = os.path.abspath(f"{args.out}.{i}.{which}")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, out], check=True)
        with open(out) as f:
            runs.append((which, json.load(f)))
        os.remove(out)
    result = {"device": smi, "order": [w for w, _ in runs], "cases": {}}
    for name, R, N, kind in CASES:
        rng = np.random.default_rng([SEED, R, N])
        plain, signed = digits(plain_ints(np, scalars(np, rng, R, N, kind),
                                          kind))
        shas = {r[name]["sha256"] for _, r in runs}
        row = {"shape": [R, N], "kind": kind, "same_points": len(shas) == 1,
               "digits_a_term": plain, "digits_a_term_signed": signed,
               "ms": {w: [r[name]["ms"] for v, r in runs if v == w]
                      for w in dict(order)}}
        result["cases"][name] = row
        print(name, json.dumps(row), f"({smi})", flush=True)
    result["tables"] = {f"table {n}": {w: [r[f"table {n}"]["ms"]
                                           for v, r in runs if v == w]
                                       for w in dict(order)}
                        for n in TABLES}
    result["plain_calls"] = {w: r["plain_calls"] for w, r in runs}
    print(json.dumps(result["tables"]), f"({smi})", flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    bad = [n for n, c in result["cases"].items() if not c["same_points"]]
    if bad:
        sys.exit(f"the trees disagree on {bad}")


if __name__ == "__main__":
    main()
