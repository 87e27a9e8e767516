#!/usr/bin/env python3
"""The mesh (zkcnn_tpu_torch/parallel/) over the machine's cards, one
shard a card: every function of parallel/sharding.py against its
unsplit counterpart over 2 and 4 cards, the tiny models' dryrun over
the first 4 cards, and LeNet5 pic_cnt=1 (--no-pcs over 4 and over 2
cards; with the IPA commitment and under FiatShamirTape over 4 cards),
each held to its one-device pin and checked as chip_smoke.py's mesh
phase checks a run (`mesh_check`: every split operand gathered once, the
ladders at the shards' shapes), with bytes copied between cards; PT, VT
and POLY_PT beside the same process's one-device run.  Needs 4 CUDA
cards; run from the repository root:

    python3 tools/h100_mesh_cards.py

Writes its results to chiprun_out/cards4.json; exits 1 if a run failed.
"""

import json
import os
import random
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())


def main():
    import torch
    import chip_smoke as cs
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.cli import demo_lenet
    from zkcnn_tpu_torch.parallel import make_mesh
    from zkcnn_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.time()
    cuda_build.build()
    smi = cs.smi_line()
    n = torch.cuda.device_count()
    cs.say(f"build {time.time() - t0:.1f}s; cards {n}; {smi}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rng = random.Random(5)
    t = time.time()
    cs.mesh_functions(torch, gen, rng, smi)
    cs.say(f"functions {time.time() - t:.1f}s")
    t = time.time()
    dryrun_multichip(min(4, n), log=cs.say)
    cs.say(f"dryrun {time.time() - t:.1f}s")
    argv = ["--synthetic", "--seed", "17", "--pic-cnt", "1"]
    ws, ps = cs.PINNED_LENET["WS"], cs.PINNED_LENET["PS"]
    poly_ps = cs.PINNED_LENET_PCS["POLY_PS"]
    cubic = ((1 << 16, 1 << 9, 9),)
    plan = [
        ("lenet --no-pcs", demo_lenet.main, argv + ["--no-pcs"],
         (ws, ps, "0.0000", cs.PINNED_LENET["digest"]), [4, 2],
         dict(split=(18,), cubic=cubic)),
        ("lenet with the commitment", demo_lenet.main, argv,
         (ws, ps, poly_ps, cs.PINNED_LENET_PCS["digest"]), [4],
         dict(split=(18,), cubic=cubic)),
        ("lenet under FiatShamirTape", cs.fs_lenet_main, [],
         (ws, ps, poly_ps, "/".join(map(str, cs.PINNED_FS_LENET))), [4],
         dict(split=(18,), fiat_shamir=True))]
    out, failed = {}, []
    for run, fn, run_argv, want, sizes, how in plan:
        one = cs.run_entry(torch, fn, run_argv, run, smi)
        cs.check_run(one, want)
        for D in sizes:
            key = f"{run} over {D} cards"
            try:
                r = cs.mesh_entry(torch, fn, run_argv, key, smi, make_mesh(D))
                cs.check_run(r, want)
                checks = dict(how)
                if "commitment" in run and "Fiat" not in run:
                    checks["commits"] = D - 1
                cs.mesh_check(r, one, D, **checks)
                if not r["mesh"]["peer_bytes"]:
                    raise AssertionError(f"{key}: nothing moved between "
                                         f"cards")
                out[key] = cs.mesh_line(key, r, one["summary"], smi)
            except Exception as e:
                traceback.print_exc()
                cs.say(f"FAILED {key}: {e!r}"[:3000])
                failed.append(key)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/cards4.json", "w") as f:
        json.dump(out, f, default=str)
    cs.say(json.dumps(out, default=str)[:8000])
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
