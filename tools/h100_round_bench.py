#!/usr/bin/env python3
"""Measurements of the port's sumcheck round kernels on one NVIDIA GPU.

    python3 tools/h100_round_bench.py [--parent DIR] [--out FILE]

Needs a CUDA device and nvcc (it builds zkcnn_tpu_torch's kernels).  It
prints one line per measurement and writes them all as JSON to --out
(default .chip_scratch/h100_round_bench.json).  Sections:

  sizes   the one-round entries from 2^12 to 2^24 rows, each with the
          least time the card could take (chip_smoke.bound);
  loop    LeNet's largest side (2^18 rows, 18 rounds): one ladder and one
          fetch against 18 one-round calls each fetched before the next;
  proof   LeNet5 proofs in this process on one witness: PT and the part
          of it spent in the round loops;
  lenet   (with --parent, a checkout of the commit to compare with) the
          LeNet5 demo's PT from a warm-up run, then parent, change,
          change, parent twice over, each in a process of its own;
  pcs     (with --parent) the same with the Hyrax commitment: PT,
          POLY_PT, POLY_VT and, where the tree prints it, the setup's
          generator table, from a warm-up run of each tree, then parent,
          change, change, parent.

Every time is the mean of back-to-back calls between two CUDA events.
"""

import argparse
import json
import os
import random
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import bound, rand_fe, smi_line, time_ms  # noqa: E402
from zkcnn_tpu_torch.field import round_kernels as rk  # noqa: E402

RESULTS = []


def record(section, **kw):
    RESULTS.append({"section": section, **kw})
    print(section, json.dumps(kw), flush=True)


def ladder_case(kind, rows, m_rows, R, gen, rng):
    rs = [rng.getrandbits(254) for _ in range(R)]
    if kind == "cubic":
        ops = [rand_fe(torch, m_rows, gen), rand_fe(torch, rows, gen),
               rand_fe(torch, rows, gen)]
        wrapped = lambda: rk.cubic_ladder(*ops, rs)      # noqa: E731
    elif kind == "fold":
        ops = [rand_fe(torch, rows, gen)]
        wrapped = lambda: rk.fold_ladder(ops[0], rs)     # noqa: E731
    else:
        ops = [rand_fe(torch, rows, gen), rand_fe(torch, rows, gen)]
        wrapped = lambda: rk.round_ladder(*ops, rs)      # noqa: E731
    return ops, rs, wrapped


def size_sweep(gen, rng, smi):
    r = rng.getrandbits(254)
    for lg in (12, 16, 18, 20, 22, 24):
        rows = 1 << lg
        A, V = rand_fe(torch, rows, gen), rand_fe(torch, rows, gen)
        m = rand_fe(torch, 1 << 11, gen)
        record("sizes", rows=rows, card=smi,
               round_step_bound=bound("round_step", (rows, 1)),
               fold_bound=bound("fold", (rows, 1)),
               cubic_round_step_bound=bound("cubic_round_step",
                                            (rows, 1 << 11, 1)),
               round_step_ms=time_ms(torch, lambda: rk.round_step(A, V, r),
                                     20),
               fold_ms=time_ms(torch, lambda: rk.fold(A, r), 20),
               cubic_round_step_ms=time_ms(
                   torch, lambda: rk.cubic_round_step(m, A, V, r), 20))
        del A, V


def loop_vs_ladder(gen, rng, smi):
    rows, R = 1 << 18, 18
    ops, rs, _ = ladder_case("round", rows, 0, R, gen, rng)
    A, V = ops

    def per_round():
        a, v = A, V
        for r in rs:
            d, a, v = rk.round_step(a, v, r)
            d.cpu()

    def ladder():
        rk.round_ladder(A, V, rs)[0].cpu()

    for name, fn in (("per_round", per_round), ("ladder", ladder),
                     ("ladder", ladder), ("per_round", per_round)):
        t0 = time.perf_counter()
        ms = time_ms(torch, fn, 20)
        record("loop", what=name, rows=rows, R=R, ms=ms,
               wall_s=time.perf_counter() - t0, card=smi)


def proof_sweep(gen, rng, smi):
    from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
    from zkcnn_tpu_torch.gkr import engine
    from zkcnn_tpu_torch.nn import models, random_source
    from zkcnn_tpu_torch.nn.params import PoolType
    nn = models.lenet(32, 32, 1, 1, PoolType.MAX)
    C, vals = nn.create(random_source(17))
    for run_no in range(5):
        p = Prover(C, vals)
        spent = [0.0]

        def timed(run, spent=spent):
            def call(rs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(rs)
                spent[0] += time.perf_counter() - t0
                return out
            return call

        p.run_rounds_quad = timed(p.run_rounds_quad)
        p.run_rounds_cubic = timed(p.run_rounds_cubic)
        rk.reset_launches()
        engine.FETCHES["rounds"] = 0
        v = Verifier(p, C, Tape(b"zkcnn-demo-17"))
        assert v.verify()
        record("proof", run="warm-up" if run_no == 0 else run_no,
               PT=p.prove_time, rounds_s=spent[0],
               kernel_launches=sum(rk.KERNEL_LAUNCHES.values()),
               fetches=engine.FETCHES["rounds"], digest=v.transcript_digest,
               card=smi)


def lenet_pt(tree: str, pcs: bool = False) -> dict:
    """One LeNet5 demo run from `tree`, in a process of its own, with the
    commitment or with --no-pcs."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "zkcnn_tpu_torch.cli.demo_lenet",
         "--synthetic", "--seed", "17", "--pic-cnt", "1"]
        + ([] if pcs else ["--no-pcs"]),
        cwd=tree, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"demo_lenet failed in {tree}:\n{out.stderr}")
    m = re.search(r"witness generation ([\d.]+)s, prove ([\d.]+)s, verify "
                  r"([\d.]+)s \(slow ([\d.]+)s\)", out.stderr)
    row = out.stdout.strip().splitlines()[-1].split(", ")
    res = {"PT": float(row[7]), "VT": float(row[8]), "PS": row[9],
           "WS": row[6], "witness_s": float(m.group(1)),
           "vt_slow_s": float(m.group(4)), "wall_s": time.time() - t0,
           "digest": re.search(r"sha256 (\w+)", out.stderr).group(1)}
    if pcs:
        res.update(POLY_PT=float(row[10]), POLY_VT=float(row[11]),
                   POLY_PS=row[12])
        table = re.search(r"generator table ([\d.]+)s", out.stderr)
        res["table_s"] = float(table.group(1)) if table else None
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare "
                    "the LeNet5 PT with")
    ap.add_argument("--out", default=os.path.join(
        ROOT, ".chip_scratch", "h100_round_bench.json"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="sections to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("h100_round_bench: no CUDA device")
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    rk._lib()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = random.Random(17)
    sections = {"sizes": size_sweep, "loop": loop_vs_ladder,
                "proof": proof_sweep}
    for name, fn in sections.items():
        if args.only is None or name in args.only:
            fn(gen, rng, smi)
    turns = [("parent", args.parent), ("change", ROOT),
             ("change", ROOT), ("parent", args.parent)]
    if args.parent and (args.only is None or "lenet" in args.only):
        for which, tree in [("warm-up", args.parent)] + 2 * turns:
            record("lenet", tree=which, card=smi, **lenet_pt(tree))
    if args.parent and (args.only is None or "pcs" in args.only):
        warm = [("warm-up parent", args.parent), ("warm-up change", ROOT)]
        for which, tree in warm + turns:
            record("pcs", tree=which, card=smi, **lenet_pt(tree, True))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1)


if __name__ == "__main__":
    main()
