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
    kernels compiling beside it), then proven from the snapshot
    three-pass with the inner-product commitment on card 0 and over 4
    cards, each to PINNED_VGG16; over the cards mesh_check against the
    card-0 run (split_check and storage_check: the witness, the gates and
    the accumulators a quarter a shard, each block in its own storage;
    Liu's phase at a card's (2^23, 23) only; one g1_msm more a card for
    the commit, at a quarter of its rows), each card's peak memory by
    span of verify(), the bytes copied between cards and each shard's
    resident high-water;
  * vgg16x8 (only when asked for: BASELINE.json config 5, vgg16 at
    pic_cnt=8, every convolution an FFT one): the same to
    PINNED_VGG16_PIC8, and besides the 13 DOT_PROD phase 1s at a quarter
    of their rows, Liu's at a card's (2^24, 24), the FFT, IFFT and
    DOT_PROD layers' witness as 4 blocks, one a card;
  * vgg11 (only when asked for; one card): vgg11 pic_cnt=1 through
    demo_vgg with the inner-product commitment to PINNED_VGG11, as
    chip_smoke.py ran it before it took vgg11 at pic_cnt=2.

The mesh parts need 4 CUDA cards; run from the repository root:

    python3 tools/h100_mesh_cards.py [--only lenet|vgg16|vgg16x8|vgg11]

Writes its results to chiprun_out/cards4.json; exits 1 if a run failed.
The snapshots (about 12 GB for vgg16, 30 GB for vgg16x8, under
.snapshots/) are removed at exit.
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


def vgg16_cards(torch, cs, smi, out, failed, pic_cnt):
    """vgg16 at pic_cnt pictures from a snapshot on card 0, then over 4
    cards (module docstring): PINNED_VGG16 at pic_cnt=1, PINNED_VGG16_PIC8
    at pic_cnt=8."""
    import atexit
    from concurrent.futures import ThreadPoolExecutor
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.circuit import LayerType
    from zkcnn_tpu_torch.cli import prove
    from zkcnn_tpu_torch.parallel import make_mesh
    name = "vgg16" if pic_cnt == 1 else f"vgg16 pic_cnt={pic_cnt}"
    pin_name = "PINNED_VGG16" if pic_cnt == 1 else \
        f"PINNED_VGG16_PIC{pic_cnt}"
    snap = cs.SNAPSHOT if pic_cnt == 1 else \
        os.path.join(".snapshots", f"vgg16x{pic_cnt}.snap")
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    atexit.register(lambda: os.path.exists(snap) and os.remove(snap))
    argv = ["vgg16", "--pic-cnt", str(pic_cnt), "--pcs", "--snapshot", snap]
    t0 = time.time()
    with ThreadPoolExecutor(1) as compiler:
        compiled = compiler.submit(cuda_build.build)
        built = prove.main(argv + ["--build-only"])
        compiled.result()
    cs.say(f"{name}'s witness built and saved beside the build in "
           f"{time.time() - t0:.1f} s (the witness "
           f"{built['witness_s'] - built['snapshot']['save_s']:.1f} s, "
           f"{built['snapshot']['bytes']} bytes)")
    pin = getattr(cs, pin_name)
    want = (pin["WS"], pin["PS"], pin["POLY_PS"], pin["digest"])
    # above one picture every convolution is an FFT one: its DOT_PROD
    # phase 1 runs cubic_ladder
    fft = ("cubic_ladder",)
    must = ("round_ladder", "fold_ladder", "g1_msm", "ipa_round") + \
        (fft if pic_cnt > 1 else ())
    never = cs.PER_ROUND + cs.FOLD_KERNELS + (() if pic_cnt > 1 else fft)
    key1 = f"{name} with the commitment on card 0"
    key = f"{name} with the commitment over 4 cards"
    try:
        one = cs.run_entry(torch, prove.main, argv, key1, smi,
                           spans=cs.vgg_spans())
        cs.check_run(one, want, must=must, never=never)
        pcs = one.pop("committed")["pcs"]
        one.pop("seen")
        cs.say(f"{key1}: {pin_name} held; "
               + json.dumps({k: one["summary"][k] for k in (
                   "pt_s", "vt_s", "vt_slow_s", "poly_pt_s", "witness_s",
                   "wall_s", "peak_gib", "peak_gib_by_span",
                   "seconds_by_span")}))
        out[key1] = {**one["summary"], "shapes": one["shapes"],
                     "snapshot_bytes": built["snapshot"]["bytes"],
                     "build_s": built["witness_s"]
                     - built["snapshot"]["save_s"]}
        cubic = one["shapes"]["cubic_ladder"]
        mesh = make_mesh(4)
        peaks, undo = card_spans(torch, cs.vgg_spans(), mesh.devices)
        try:
            for d in mesh.devices:
                torch.cuda.reset_peak_memory_stats(d)
            r = cs.mesh_entry(torch, prove.main, argv, key, smi, mesh)
        finally:
            undo()
        cs.check_run(r, want, must=must, never=never)
        cs.mesh_check(r, one, 4, split=(pcs.logn,), cubic=cubic, commits=3)
        r.pop("committed")
        r.pop("seen")
        if (pcs.n_rows // 4, pcs.n_cols) not in r["shapes"]["g1_msm"]:
            raise AssertionError(f"{key}: the commit not a quarter of its "
                                 f"rows a card: g1_msm shapes "
                                 f"{r['shapes']['g1_msm']}")
        # the FFT path's layers: each one's witness as one block a card
        kinds = (LayerType.FFT, LayerType.IFFT, LayerType.DOT_PROD)
        fft_blocks = sorted((lid, rows, n) for lid, rows, n, _ in
                            r["split"]["val"]
                            if r["split"]["kinds"][lid] in kinds)
        convs = sum(k == LayerType.DOT_PROD
                    for k in r["split"]["kinds"].values())
        if convs != (13 if pic_cnt > 1 else 0) or \
                len(fft_blocks) != 3 * convs or \
                any(n != 4 for _, _, n in fft_blocks):
            raise AssertionError(f"{key}: the FFT path's layers held as "
                                 f"{fft_blocks}")
        if not r["mesh"]["peer_bytes"]:
            raise AssertionError(f"{key}: nothing moved between cards")
        by_card = {d: {k: v / 2 ** 30 for k, v in p.items()}
                   for d, p in peaks.items()}
        line = cs.mesh_line(key, r, one["summary"], smi)
        cs.say(f"{key}: {pin_name} held; the DOT_PROD phase 1s at "
               f"{r['shapes']['cubic_ladder']} (one card {cubic}); the FFT "
               f"path's {len(fft_blocks)} layers as 4 blocks each; peak GiB "
               f"by span of verify() a card: {json.dumps(by_card)} ({smi})")
        out[key] = {**line, "peak_gib_by_span_a_card": by_card,
                    "shapes": r["shapes"], "fft_path_blocks": fft_blocks}
    except Exception as e:
        traceback.print_exc()
        cs.say(f"FAILED {key}: {e!r}"[:3000])
        failed.append(key)
    os.remove(snap)


def vgg11_card(torch, cs, smi, out, failed):
    """vgg11 pic_cnt=1 on card 0 to PINNED_VGG11 (module docstring)."""
    from zkcnn_tpu_torch import cuda_build
    cuda_build.build()
    key = "vgg11 with the commitment"
    try:
        r = cs.vgg_run(torch, "vgg11", cs.PINNED_VGG11, smi)
        out[key] = r["summary"]
    except Exception as e:
        traceback.print_exc()
        cs.say(f"FAILED {key}: {e!r}"[:3000])
        failed.append(key)


def main():
    import argparse
    import torch
    import chip_smoke as cs
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.cli import demo_lenet
    from zkcnn_tpu_torch.parallel import make_mesh
    from zkcnn_tpu_torch.parallel.dryrun import dryrun_multichip
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["lenet", "vgg16", "vgg16x8",
                                       "vgg11"])
    args = ap.parse_args()
    smi = cs.smi_line()
    out, failed = {}, []
    if args.only == "vgg11":
        vgg11_card(torch, cs, smi, out, failed)
        return finish(cs, out, failed)
    if torch.cuda.device_count() < 4:
        sys.exit("h100_mesh_cards: 4 CUDA cards needed, "
                 f"{torch.cuda.device_count()} present")
    n = torch.cuda.device_count()
    if args.only != "lenet":
        cs.say(f"cards {n}; {smi}")
        vgg16_cards(torch, cs, smi, out, failed,
                    8 if args.only == "vgg16x8" else 1)
    if args.only in ("vgg16", "vgg16x8"):
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
