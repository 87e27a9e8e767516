#!/usr/bin/env python3
"""The mesh (zkcnn_tpu_torch/parallel/) over the machine's cards, and the
vgg16 runs that chip_smoke.py leaves out for its clock.  Two parts, both
by default:

  * lenet (4 cards): every function of parallel/sharding.py against its
    unsplit counterpart over 2 and 4 cards, the tiny models' dryrun over
    the first 4 cards, and LeNet5 pic_cnt=1 (--no-pcs over 4 and over 2
    cards; with the IPA commitment and under FiatShamirTape over 4
    cards), each held to its one-device pin and checked as chip_smoke.py's
    mesh phase checks a run (`mesh_check`: every split operand gathered
    once, the ladders at the shards' shapes, the witness, the gates and
    the accumulators split, one g1_msm more a card for the commit), with
    bytes copied between cards; PT, VT and POLY_PT beside the same
    process's one-device run;
  * vgg16 (vgg16_cards): its circuit and witness built and saved through
    the port's proving tool (cli/prove.py vgg16 --pcs --snapshot
    --build-only, the kernels compiling beside it), then proven from the
    snapshot three-pass through cli/prove.py with the inner-product
    commitment on card 0 (chip_smoke.vgg_run: Liu's phase at (2^25, 25),
    g1_msm at the commit's (4096, 8192), 13 ipa_round) and over 4 shards,
    shard i on card i % count, each to PINNED_VGG16; over the shards
    mesh_check against the card-0 run (split_check and storage_check: the
    witness, the gates and the accumulators a quarter a shard, each block
    in its own storage; Liu's phase at a shard's (2^23, 23) only; one
    g1_msm more a shard for the commit, at a quarter of its rows, never
    the whole matrix), the highest card peak within MESH_PEAK_RATIO of
    card 0's, each card's peak memory by span of verify(), the bytes
    copied between cards and each shard's resident high-water; then
    kernel_checks, the checks chip_smoke.py made at these runs' shapes
    while it ran them: every round-kernel entry at every shape of both
    runs against its plain version (round_ladder at (2^25, 25) and (2^23,
    23) timed), the commit's g1_msm at (4096, 8192) on the witness and on
    random 255-bit scalars and every other g1_msm shape (the shard's
    (1024, 8192) among them) against py_mul of the discrete logs, the
    setup's table of 8192 generators against the plain table, and the 13
    rounds of card 0's opening against the plain ipa_round;
  * vgg16x8 (only when asked for: BASELINE.json config 5, vgg16 at
    pic_cnt=8, every convolution an FFT one): the same to
    PINNED_VGG16_PIC8, and besides the 13 DOT_PROD phase 1s at a quarter
    of their rows, Liu's at a shard's (2^24, 24), the FFT, IFFT and
    DOT_PROD layers' witness as 4 blocks, one a shard (the peak ratio
    printed, not held: card 0 holds the loaded witness whole);
  * vgg16fs (only when asked for; card 0 alone): the same snapshot as
    vgg16, proven under FiatShamirTape(b"zkcnn-demo-17") with the
    inner-product commitment through chip_smoke.fs_main to
    PINNED_FS_VGG16 (chip_smoke.fs_vgg_run: WS, PS and POLY_PS those of
    PINNED_VGG16, fold_round as phase calls only, Liu's at (no side,
    2^25, 25 rounds)); kernel_checks with fold_round_phase at every phase
    shape of the run, random rows and rows of p - 1;
  * vgg16x8fs (only when asked for): vgg16x8's snapshot under
    FiatShamirTape on card 0 to PINNED_FS_VGG16_PIC8 (every DOT_PROD
    phase 1 a fold_cubic_round phase call, (2^26, 2^7, 26) among them)
    and over 4 shards to the same pin, with vgg16x8's checks of the split
    run under the tape's rules (mesh_check with fiat_shamir: the split
    phases on the host tape, a phase call only for a phase whose operands
    stayed whole), the phases on the host tape and the phase calls
    counted; kernel_checks with fold_cubic_round_phase and
    fold_round_phase at the run's largest cubic and quadratic phase;
  * vgg11 (only when asked for; one card): vgg11 pic_cnt=1 through
    demo_vgg with the inner-product commitment to PINNED_VGG11, as
    chip_smoke.py ran it before it took vgg11 at pic_cnt=2.

The lenet part needs 4 CUDA cards; the vgg16 modes run their 4 shards on
whatever cards there are (on one card, all four on it).  --only takes one
part or several: the vgg16 modes of one picture count (vgg16 and
vgg16fs; vgg16x8 and vgg16x8fs) then share one snapshot, and the later
mode skips the curve checks the earlier one made.  Run from the
repository root:

    python3 tools/h100_mesh_cards.py
        [--only {lenet,vgg11,vgg16,vgg16x8,vgg16fs,vgg16x8fs} ...]

Writes its results to chiprun_out/cards4.json; exits 1 if a run failed.
The snapshots (about 12 GB for vgg16, 30 GB for vgg16 pic_cnt=8, under
.snapshots/) are removed at exit.
"""

import json
import multiprocessing
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


def vgg16_names(pic_cnt):
    """vgg16's run name and its three-pass pin's name at pic_cnt."""
    if pic_cnt == 1:
        return "vgg16", "PINNED_VGG16"
    return f"vgg16 pic_cnt={pic_cnt}", f"PINNED_VGG16_PIC{pic_cnt}"


def vgg16_snapshot(cs, pic_cnt):
    """vgg16's circuit and witness at pic_cnt pictures built and saved
    through the port's proving tool (cli/prove.py vgg16 --pcs --snapshot
    --build-only), the kernels compiling beside it; the snapshot is
    removed at exit.  Returns its path and the tool's result."""
    import atexit
    from concurrent.futures import ThreadPoolExecutor
    from zkcnn_tpu_torch import cuda_build
    from zkcnn_tpu_torch.cli import prove
    snap = cs.SNAPSHOT if pic_cnt == 1 else \
        os.path.join(".snapshots", f"vgg16x{pic_cnt}.snap")
    os.makedirs(os.path.dirname(snap), exist_ok=True)
    atexit.register(lambda: os.path.exists(snap) and os.remove(snap))
    t0 = time.time()
    with ThreadPoolExecutor(1) as compiler:
        compiled = compiler.submit(cuda_build.build)
        built = prove.main(["vgg16", "--pic-cnt", str(pic_cnt), "--pcs",
                            "--snapshot", snap, "--build-only"])
        compiled.result()
    cs.say(f"{vgg16_names(pic_cnt)[0]}'s witness built and saved beside "
           f"the build in {time.time() - t0:.1f} s (the witness "
           f"{built['witness_s'] - built['snapshot']['save_s']:.1f} s, "
           f"{built['snapshot']['bytes']} bytes)")
    return snap, built


VGG16_MODES = {"vgg16": (1, False), "vgg16x8": (8, False),
               "vgg16fs": (1, True), "vgg16x8fs": (8, True)}
# how far above the card-0 run's a card's peak may go over the mesh at one
# picture, where the 4 shards may share a card (the blocks are the same
# bytes; on an H100, vgg16 over 4 shards on one card peaked at 0.87-0.88x
# the one-device run).
# At pic_cnt=8 the loaded witness stays whole on card 0 until the prover
# splits it, so there the ratio is printed, not held.
MESH_PEAK_RATIO = 1.15


def vgg16_cards(torch, cs, smi, out, failed, pic_cnt, snapshot,
                fiat_shamir=False, split=True, checked=None):
    """vgg16 at pic_cnt pictures from its snapshot (vgg16_snapshot's
    (path, result)) on card 0, then (split) over 4 shards, shard i on
    card i % count (module docstring): three-pass through cli/prove.py to
    PINNED_VGG16 or PINNED_VGG16_PIC8, or under FiatShamirTape through
    chip_smoke.fs_main to PINNED_FS_VGG16 or PINNED_FS_VGG16_PIC8; then
    the kernels at the runs' shapes against their plain versions
    (kernel_checks; `checked`: what an earlier mode on the same snapshot
    held already)."""
    from zkcnn_tpu_torch.circuit import LayerType
    from zkcnn_tpu_torch.cli import prove
    name, pin_name = vgg16_names(pic_cnt)
    pin = getattr(cs, pin_name)
    snap, built = snapshot
    argv = ["vgg16", "--pic-cnt", str(pic_cnt), "--snapshot", snap]
    must = ("fold_ladder", "g1_msm_table", "g1_table_affine", "g1_msm",
            "ipa_round")
    if fiat_shamir:
        pin_name = pin_name.replace("PINNED_", "PINNED_FS_")
        fs_pin = getattr(cs, pin_name)
        want = (pin["WS"], pin["PS"], pin["POLY_PS"],
                "/".join(map(str, fs_pin)))
        entry, spans = cs.fs_main, cs.fs_spans()
        run = f"{name} under FiatShamirTape with the commitment"
        must += ("fold_round",)
        never = ("round_ladder", "cubic_ladder") + cs.FOLD_KERNELS
        fft = ("fold_cubic_round",)
    else:
        want = (pin["WS"], pin["PS"], pin["POLY_PS"], pin["digest"])
        entry, spans = prove.main, cs.vgg_spans()
        argv.append("--pcs")
        run = f"{name} with the commitment"
        must += ("round_ladder",)
        never = cs.PER_ROUND + cs.FOLD_KERNELS
        fft = ("cubic_ladder",)
    # above one picture every convolution is an FFT one: its DOT_PROD
    # phase 1 runs the cubic kernel
    must += fft if pic_cnt > 1 else ()
    never += () if pic_cnt > 1 else fft
    mesh = cs.mesh_on_cards(torch, 4)
    cards = len(set(map(str, mesh.devices)))
    key1 = f"{run} on card 0"
    key = f"{run} over 4 shards on {cards} card{'s' * (cards > 1)}"
    runs = {}
    try:
        if fiat_shamir:
            one = cs.fs_vgg_run(torch, argv, key1, pin, fs_pin, smi,
                                cubic=(cs.FS_VGG_CUBIC,) if pic_cnt > 1
                                else ())
        else:
            one = cs.vgg_run(torch, "vgg16", pin, smi, prove.main, argv,
                             pic_cnt)
        cs.say(f"{key1}: {pin_name} held; " + json.dumps(
            {k: v for k, v in one["summary"].items() if k in (
                "pt_s", "vt_s", "vt_slow_s", "poly_pt_s", "poly_vt_s",
                "witness_s", "hash_to_curve_s", "wall_s", "peak_gib",
                "peak_gib_by_span", "seconds_by_span")}))
        out[key1] = {**one["summary"], "shapes": one["shapes"],
                     "snapshot_bytes": built["snapshot"]["bytes"],
                     "build_s": built["witness_s"]
                     - built["snapshot"]["save_s"]}
        runs[key1] = one
        if split:
            devices = list(dict.fromkeys(mesh.devices))
            peaks, undo = card_spans(torch, spans, devices)
            try:
                for d in devices:
                    torch.cuda.reset_peak_memory_stats(d)
                r = cs.mesh_entry(torch, entry, argv, key, smi, mesh)
            finally:
                undo()
            cs.check_run(r, want, must=must, never=never)
            pcs = r.pop("committed")["pcs"]
            r.pop("seen")
            cs.mesh_check(r, one, 4, split=(pcs.logn,),
                          cubic=one["shapes"]["cubic_ladder"], commits=3,
                          fiat_shamir=fiat_shamir)
            # the commit a quarter of its rows a shard, never the whole
            # matrix
            commits = r["shapes"]["g1_msm"]
            if (pcs.n_rows // 4, pcs.n_cols) not in commits or \
                    (pcs.n_rows, pcs.n_cols) in commits:
                raise AssertionError(f"{key}: the commit not a quarter of "
                                     f"its rows a shard: g1_msm shapes "
                                     f"{commits}")
            # the FFT path's layers: each one's witness as one block a shard
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
            if cards > 1 and not r["mesh"]["peer_bytes"]:
                raise AssertionError(f"{key}: nothing moved between cards")
            worst = max([r["peak"]] + [v for p in peaks.values()
                                       for v in p.values()])
            ratio = worst / one["peak"]
            if pic_cnt == 1 and ratio > MESH_PEAK_RATIO:
                raise AssertionError(f"{key}: a card's peak {worst} bytes, "
                                     f"over {MESH_PEAK_RATIO} x card 0's "
                                     f"{one['peak']}")
            by_card = {d: {k: v / 2 ** 30 for k, v in p.items()}
                       for d, p in peaks.items()}
            line = cs.mesh_line(key, r, one["summary"], smi)
            c = r["mesh"]
            cs.say(f"{key}: {pin_name} held; "
                   + (f"{c['host_tape_phases']} phases on the host tape, "
                      f"{c['device_tape_phases']} phase calls on a card "
                      f"({r['phase_shapes']})" if fiat_shamir else
                      f"the DOT_PROD phase 1s at "
                      f"{r['shapes']['cubic_ladder']} (card 0 "
                      f"{one['shapes']['cubic_ladder']})")
                   + f"; the FFT path's {len(fft_blocks)} layers as 4 "
                   f"blocks each; {c['peer_bytes']} bytes between cards; "
                   f"the highest card peak {ratio:.3f} x card 0's; peak GiB "
                   f"by span of verify() a card: {json.dumps(by_card)} "
                   f"({smi})")
            out[key] = {**line, "peak_gib_by_span_a_card": by_card,
                        "peak_ratio": ratio, "shapes": r["shapes"],
                        "phase_shapes": r["phase_shapes"],
                        "fft_path_blocks": fft_blocks}
            runs[key] = r
        out[key1]["kernel_checks"] = kernel_checks(
            torch, cs, smi, runs, pic_cnt, fiat_shamir,
            set() if checked is None else checked)
    except Exception as e:
        traceback.print_exc()
        cs.say(f"FAILED {key1}: {e!r}"[:3000])
        failed.append(key1)


def kernel_checks(torch, cs, smi, runs, pic_cnt, fiat_shamir, checked):
    """chip_smoke.py's phase 6 at the shapes of this mode's runs (card 0's
    first), after the proofs: every round-kernel entry at every shape a
    run launched it at against its plain version, exact on random rows,
    each run's largest shape of each entry timed beside its plain version
    and bound (round_ladder's: Liu's phase, on card 0 the whole side, over
    the mesh a shard's); under Fiat-Shamir the phase calls at card 0's
    phase shapes (fs_phase_checks: at one picture every shape on random
    rows and rows of p - 1, at eight the largest of each); g1_msm at every
    shape against py_mul of the discrete logs (card 0's three-pass commit
    on its own operands, commit_check; every shape, the commit's too, on
    random 255-bit scalars, g1_log_check), each timed beside its bound;
    the setup's table of the generators and every other table shape of
    the runs (on random bases) against one call of the plain version,
    entry by entry, and the table's normalisation (g1_table_affine) timed
    at the setup's shape; every round of card 0's opening against its
    plain version word for word (opening_rounds_check); g1_scalar_mul
    against its plain version on 8-bit scalars (scalar_mul_plain_checks,
    out of chip_smoke.py for its clock).  The curve checks skip what
    `checked` names (the g1_msm shapes, "tables", "opening", "scalar_mul"),
    which an earlier mode on the same snapshot held, and add to it.
    Returns the measurements."""
    from zkcnn_tpu_torch.field import FR, round_kernels as rk
    from zkcnn_tpu_torch.gkr import Tape
    from zkcnn_tpu_torch.pcs import curve, ipa, msm as msm_mod
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = random.Random(17)
    one = next(iter(runs.values()))
    got = {}
    for key, r in runs.items():
        for name in cs.LADDERS + cs.PER_ROUND:
            shapes = sorted(r["shapes"][name], reverse=True)
            for shape in shapes:
                e, kern, plain = cs.compare(torch, rk, name, shape, gen, rng)
                if shape == shapes[0]:
                    b_ms, b_by = cs.bound(name, shape)
                    got[f"{name} ({key})"] = {
                        "shape": list(shape), "max_abs_err": e,
                        "ms": cs.time_ms(torch, kern, 5),
                        "plain_ms": plain.ms, "bound_ms": b_ms,
                        "bound_by": b_by}
                del kern, plain
            if shapes:
                g = got[f"{name} ({key})"]
                cs.say(f"{name} at its {len(shapes)} shapes of {key}: "
                       f"equal to its plain version; at {shapes[0]} kernel "
                       f"{g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms, "
                       f"bound {g['bound_ms']:.6f} ms by {g['bound_by']} "
                       f"({smi})")
    if fiat_shamir:
        got.update(cs.fs_phase_checks(torch, rk, one, gen, rng, smi,
                                      pm1_everywhere=pic_cnt == 1,
                                      largest_only=pic_cnt > 1))
    if not fiat_shamir:
        c = one["committed"]
        got["g1_msm commit"] = cs.commit_check(torch, curve, msm_mod, FR,
                                               Tape, c, one["run"], smi)
    # every shape on random 255-bit scalars too: the commit's beside its
    # time on the witness
    msms = sorted(set().union(*(r["shapes"]["g1_msm"]
                                for r in runs.values())) - checked)
    checked.update(msms)
    for shape in msms:
        scalars, kern = cs.g1_log_check(torch, curve, msm_mod, FR, "g1_msm",
                                        shape, gen)
        b_ms, b_by = cs.g1_bound(torch, curve, "g1_msm", shape, scalars)
        got[f"g1_msm {shape}"] = {"shape": list(shape),
                                  "ms": cs.time_ms(torch, kern, 3),
                                  "bound_ms": b_ms, "bound_by": b_by}
        cs.say(f"g1_msm at {shape}: equal to py_mul of the discrete logs; "
               f"kernel {got[f'g1_msm {shape}']['ms']:.4f} ms, bound "
               f"{b_ms:.6f} ms by {b_by} ({smi})")
        del scalars, kern
    if "tables" in checked:
        return got
    checked.update(("tables", "opening", "scalar_mul"))
    gens = one["committed"]["gens"]
    tables = sorted(set().union(*(r["shapes"]["g1_msm_table"]
                                  for r in runs.values()))
                    - {(gens.shape[0], curve.NWIN)})
    extra = [curve.scalar_mul(curve.base_point("cuda"),
                              cs.rand_fe(torch, n, gen)) for n, _ in tables]
    bases = torch.cat([gens] + extra)
    pms, want = cs.time_once_ms(torch,
                                lambda: msm_mod.msm_table_plain(bases))
    cs.same_points(msm_mod, curve.table_kernel(gens), want[:gens.shape[0]],
                   f"g1_msm_table at {(gens.shape[0], curve.NWIN)} (the "
                   f"setup's of {one['run']})")
    at = gens.shape[0]
    for (n, w), pts in zip(tables, extra):
        cs.same_points(msm_mod, curve.table_kernel(pts, w),
                       want[at:at + n, :w], f"g1_msm_table at {(n, w)}")
        at += n
    shape = (gens.shape[0], curve.NWIN)
    b_ms, b_by = cs.table_bound(shape)
    got["g1_msm_table"] = {
        "shape": list(shape), "max_abs_err": 0,
        "ms": cs.time_ms(torch, lambda: curve.table_kernel(gens), 5),
        "plain_ms": pms, "plain_bases": bases.shape[0], "bound_ms": b_ms,
        "bound_by": b_by, "other_shapes": tables}
    cs.say(f"g1_msm_table at {shape} (the setup's of {one['run']}) and at "
           f"{tables}: equal to the plain version entry by entry; kernel "
           f"{got['g1_msm_table']['ms']:.4f} ms, plain {pms:.4f} ms (one "
           f"call on all {bases.shape[0]} bases), bound {b_ms:.6f} ms by "
           f"{b_by} ({smi})")
    del want, bases, extra
    # the table's entries to Z = 1 at the setup's shape, on its table (the
    # same work on entries already there), beside its bound; its plain
    # version, an inversion an entry, is held against it in chip_smoke.py
    tab = curve.table_kernel(gens)
    b_ms, b_by = cs.affine_bound(shape)
    got["g1_table_affine"] = {
        "shape": list(shape),
        "ms": cs.time_ms(torch, lambda: curve.table_affine_kernel(tab), 5),
        "bound_ms": b_ms, "bound_by": b_by}
    cs.say(f"g1_table_affine at {shape}: kernel "
           f"{got['g1_table_affine']['ms']:.4f} ms, bound {b_ms:.6f} ms by "
           f"{b_by} ({smi})")
    del tab
    got["ipa_round"] = cs.opening_rounds_check(torch, ipa, one["seen"],
                                               one["run"], smi)
    cs.scalar_mul_plain_checks(torch, curve, msm_mod, FR, gen)
    return got


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
    ap.add_argument("--only", nargs="+",
                    choices=["lenet", "vgg11"] + list(VGG16_MODES))
    args = ap.parse_args()
    only = args.only or []
    smi = cs.smi_line()
    out, failed = {}, []
    n = torch.cuda.device_count()
    if "vgg11" in only:
        vgg11_card(torch, cs, smi, out, failed)
    if (not only or "lenet" in only) and n < 4:
        sys.exit(f"h100_mesh_cards: 4 CUDA cards needed, {n} present")
    modes = [m for m in only if m in VGG16_MODES] or ([] if only
                                                      else ["vgg16"])
    if modes:
        # (pictures, Fiat-Shamir) of each vgg16 mode, vgg16 by default;
        # the modes of one picture count share one snapshot and the curve
        # checks; the py_mul references of kernel_checks on the host's
        # other cores
        cs.say(f"cards {n}; {smi}")
        workers = max(1, (os.cpu_count() or 2) - 1)
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            cs.HOST_POOL.append(pool)
            try:
                for pic_cnt in dict.fromkeys(VGG16_MODES[m][0]
                                             for m in modes):
                    snapshot, checked = vgg16_snapshot(cs, pic_cnt), set()
                    for m in modes:
                        if VGG16_MODES[m][0] == pic_cnt:
                            vgg16_cards(torch, cs, smi, out, failed, pic_cnt,
                                        snapshot, VGG16_MODES[m][1],
                                        split=m != "vgg16fs",
                                        checked=checked)
                    os.remove(snapshot[0])
            finally:
                cs.HOST_POOL.clear()
    if only and "lenet" not in only:
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
                if "--no-pcs" not in run:
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
