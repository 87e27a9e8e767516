#!/usr/bin/env python3
"""The mesh (zkcnn_tpu_torch/parallel/) over the machine's cards, one
shard a card.  Two parts, both by default:

  * lenet: every function of parallel/sharding.py against its unsplit
    counterpart over 2 and 4 cards, the tiny models' dryrun over the
    first 4 cards, and LeNet5 pic_cnt=1 (--no-pcs over 4 and over 2
    cards; with the IPA commitment and under FiatShamirTape over 4
    cards), each held to its one-device pin and checked as chip_smoke.py's
    mesh phase checks a run (`mesh_check`: every split operand gathered
    once, the ladders at the shards' shapes, the witness, the gates and
    the accumulators split), with bytes copied between cards; PT, VT and
    POLY_PT beside the same process's one-device run;
  * vgg16: its circuit and witness built and saved through the port's
    proving tool (cli/prove.py vgg16 --pcs --snapshot --build-only, the
    kernels compiling beside it), then proven from the snapshot over 4
    cards (three-pass, the inner-product commitment) to PINNED_VGG16:
    Liu's phase at a card's (2^23, 23) only, one g1_msm a card for the
    commit, each card's peak memory by span of verify(), the bytes
    copied between cards and each shard's resident high-water.

Needs 4 CUDA cards; run from the repository root:

    python3 tools/h100_mesh_cards.py [--only lenet|vgg16]

Writes its results to chiprun_out/cards4.json; exits 1 if a run failed.
The snapshot (about 12 GB, under .snapshots/) is removed at exit.
"""

import json
import os
import random
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())


def card_spans(torch, spans, devices):
    """chip_smoke.memory_spans on every card of `devices`: each (class,
    method) of spans wrapped so that each card's peak memory is read and
    reset as a call starts and ends, the cards finished.  Returns the
    peaks {card: {span: bytes}} and a function that undoes the wraps."""
    peaks, real = {str(d): {} for d in devices}, []

    def read(key):
        for d in devices:
            torch.cuda.synchronize(d)
            got = peaks[str(d)]
            got[key] = max(got.get(key, 0), torch.cuda.max_memory_allocated(d))
            torch.cuda.reset_peak_memory_stats(d)

    def wrap(owner, name):
        fn = getattr(owner, name)

        def run(*args, **kw):
            read("before " + name)
            try:
                return fn(*args, **kw)
            finally:
                read(name)
        real.append((owner, name, fn))
        setattr(owner, name, run)

    for owner, name in spans:
        wrap(owner, name)

    def undo():
        for owner, name, fn in reversed(real):
            setattr(owner, name, fn)
    return peaks, undo


def vgg16_cards(torch, cs, smi, out, failed):
    """vgg16 from a snapshot over 4 cards (module docstring)."""
    import atexit
    from concurrent.futures import ThreadPoolExecutor
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.cli import prove
    from zkcnn_tpu_torch.parallel import make_mesh
    snap = cs.SNAPSHOT
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    atexit.register(lambda: os.path.exists(snap) and os.remove(snap))
    t0 = time.time()
    with ThreadPoolExecutor(1) as compiler:
        compiled = compiler.submit(cuda_build.build)
        built = prove.main(["vgg16", "--pcs", "--snapshot", snap,
                            "--build-only"])
        compiled.result()
    cs.say(f"vgg16's witness built and saved beside the build in "
           f"{time.time() - t0:.1f} s ({built['snapshot']['bytes']} bytes)")
    key = "vgg16 with the commitment over 4 cards"
    mesh = make_mesh(4)
    peaks, undo = card_spans(torch, cs.vgg_spans(), mesh.devices)
    try:
        for d in mesh.devices:
            torch.cuda.reset_peak_memory_stats(d)
        r = cs.mesh_entry(torch, prove.main, ["vgg16", "--pcs", "--snapshot",
                                              snap], key, smi, mesh)
        undo()
        pin = cs.PINNED_VGG16
        cs.check_run(r, (pin["WS"], pin["PS"], pin["POLY_PS"],
                         pin["digest"]),
                     must=("round_ladder", "g1_msm", "ipa_round"),
                     never=cs.PER_ROUND + ("cubic_ladder",))
        cs.storage_check(r)
        pcs = r.pop("committed")["pcs"]
        r.pop("seen")
        liu = (1 << pcs.logn - 2, pcs.logn - 2)
        quad = r["shapes"]["round_ladder"]
        if liu not in quad or (1 << pcs.logn, pcs.logn) in quad or \
                (pcs.n_rows // 4, pcs.n_cols) not in r["shapes"]["g1_msm"]:
            raise AssertionError(f"{key}: round_ladder shapes {quad}, g1_msm "
                                 f"shapes {r['shapes']['g1_msm']}")
        if not r["mesh"]["peer_bytes"]:
            raise AssertionError(f"{key}: nothing moved between cards")
        by_card = {d: {k: v / 2 ** 30 for k, v in p.items()}
                   for d, p in peaks.items()}
        s = r["summary"]
        cs.say(f"{key}: PINNED_VGG16 held; PT {s['pt_s']:.4f} s, VT "
               f"{s['vt_s']:.4f} s, VT slow {s['vt_slow_s']:.4f} s, POLY_PT "
               f"{s['poly_pt_s']:.4f} s, load {s['witness_s']:.2f} s, wall "
               f"{s['wall_s']:.1f} s; {r['mesh']['peer_bytes']} bytes between "
               f"cards ({r['mesh']['bytes']} copied, {r['mesh']['takes']} "
               f"indexed gathers of {r['mesh']['take_bytes']} bytes); peak "
               f"GiB by span of verify() a card: {json.dumps(by_card)}; "
               f"resident high-water a shard: {json.dumps(r['resident'])} "
               f"({smi})")
        out[key] = {**{k: s[k] for k in ("pt_s", "vt_s", "vt_slow_s",
                                         "poly_pt_s", "witness_s",
                                         "wall_s")},
                    "counts": r["mesh"], "resident_high": r["resident"],
                    "peak_gib_by_span_a_card": by_card,
                    "launches": r["launches"], "digest": s["digest"],
                    "snapshot_bytes": built["snapshot"]["bytes"]}
    except Exception as e:
        undo()
        traceback.print_exc()
        cs.say(f"FAILED {key}: {e!r}"[:3000])
        failed.append(key)
    os.remove(snap)


def main():
    import argparse
    import torch
    import chip_smoke as cs
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.cli import demo_lenet
    from zkcnn_tpu_torch.parallel import make_mesh
    from zkcnn_tpu_torch.parallel.dryrun import dryrun_multichip
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["lenet", "vgg16"])
    args = ap.parse_args()
    if torch.cuda.device_count() < 4:
        sys.exit("h100_mesh_cards: 4 CUDA cards needed, "
                 f"{torch.cuda.device_count()} present")
    smi = cs.smi_line()
    n = torch.cuda.device_count()
    out, failed = {}, []
    if args.only != "lenet":
        cs.say(f"cards {n}; {smi}")
        vgg16_cards(torch, cs, smi, out, failed)
    if args.only == "vgg16":
        return finish(cs, out, failed)
    t0 = time.time()
    cuda_build.build()
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
        ("lenet under FiatShamirTape", cs.fs_main, ["lenet"],
         (ws, ps, poly_ps, "/".join(map(str, cs.PINNED_FS_LENET))), [4],
         dict(split=(18,), fiat_shamir=True))]
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
    finish(cs, out, failed)


def finish(cs, out, failed):
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/cards4.json", "w") as f:
        json.dump(out, f, default=str)
    cs.say(json.dumps(out, default=str)[:8000])
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
