#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zkcnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. start: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from zkcnn_tpu_torch/csrc with nvcc (one
     compiler a source, side by side);
  3. each round-kernel entry against its plain PyTorch version on the
     card at edge sizes, on random rows and rows of p - 1, exact: the
     multi-round ladders and the fold at 2, 4, 1554 (folded while the row
     count is even), 2^12 and 2^18 rows with as many rounds as they
     allow, so that wide rounds with lazily reduced dots (from 2^18 rows)
     and without, the hand-over to the one-block tail and tail-only
     ladders are covered, and 2^21 rows; the per-round path's one-round
     entries (fold_round, fold_cubic_round) at 2, 4, 2^12, 2^18 and 2^21
     rows with and without the fold, fold_cubic_round also with m folding
     to one row and with one row.  The device tape (check entry
     fs_tape_check: absorb, draw, the digest's reduction mod p) against
     hashlib on 10^4 random states and the edge cases (values 0, 1,
     p - 1; counters 0, 255, 256, 2^32; digests 0, all 0xff and next to
     multiples of p), and one thread's absorb and draw timed; the phase
     calls (fold_round_phase, fold_cubic_round_phase: a whole Fiat-Shamir
     phase, the tape on the card) against their plain versions word for
     word at 2, 4, 2^12, 2^18 and 2^21 rows, at LeNet's largest phases,
     with sides that exhaust mid-phase and Liu's phase, random rows and
     rows of p - 1.  Then the curve kernels' Fp product in
     one thread (the check entry zk_fp_mul) and split over the table
     chain's lanes (zk_fp_mul_lanes) against Python integers on 0, 1,
     p - 1, R mod p, words of 0xffffffff below p, pairs that need the
     final subtraction and 10^5 random pairs, and a chain of dependent
     products in each form, whose latency it prints; the table's two
     stages apart (zk_g1_table_chain, zk_g1_table_digits) at LeNet's table
     shapes: the chain on lane groups word for word equal to the one-thread
     chain, chain and digits equal to the table word for word, each timed
     beside its bound; the curve
     kernels (g1_add, g1_scalar_mul, g1_msm_table, g1_msm) against
     their plain versions on the card, as group elements, and against
     Python integers on the host: the four edge cases of the addition,
     n = 1, 2, 3, 1554 and 2^18; scalars 0, 1, p - 1 and one with bit
     254 set at 255 bits against py_mul, random ones at 16 and 32 bits
     against the plain version, a shared point (the table route) and a
     shared scalar; (R, N) = (1, 1), (3, 5), (2, 512) and (3, 130) (a
     row of several blocks, the last one partly filled) with a repeated
     base for the MSM on its table (py_mul at full-size scalars, the
     plain version at 32-bit ones); a round of the inner-product opening
     (ipa_round: the fold of b and x, the two Q-column dots, the weights
     and the rows) against its plain version, word for word, at (L, n)
     from (2, 2) to (4096, 4096) (at (1024, 64) and L = 4096 a thread
     of the one block folds several pairs and forms several terms), with
     and without a fold, random and p - 1;
  4. the three tiny models proven and verified on the card with a real
     sqrt commitment and opening (HyraxPCS): transcript digest and proof
     size equal to their 1-device pins, a wrong evaluation rejected; one
     of them again with the inner-product opening; the same under
     FiatShamirTape (sqrt; sconv_muladd with the inner-product opening
     too): verified, final tape state and counter equal to the CPU pins,
     a tampered witness rejected; the per-round path on a plain tape
     that is not precomputable absorbing what the three-pass path
     absorbs; then the engines' phase calls (run_fs, which draws the
     challenges on the card) and the per-round engines (PhaseEngine.round,
     DotProdPhase1.round, then receive) at those challenges, driven on
     card tensors at the shapes of LeNet's largest phases, with the
     launch counts reset before and read after each: one phase call a
     phase; fold_round, fold_cubic_round and fold launched per round, no
     ladder; every round message and final claim equal to run_all's;
  5. LeNet5, pic_cnt=1, through the port's demo_lenet entry (--synthetic
     --seed 17) on the card, twice, each with the kernel launch counts
     reset just before and read just after.  With --no-pcs: it must
     verify, with WS 201734(2^18), PS 45.7188 KB, the pinned digest,
     every ladder launched, and at most one fetch per side per phase.
     With the commitment (inner-product opening): the same WS and PS,
     POLY_PS 24.8750 KB, its own pinned digest, every ladder launched,
     g1_msm_table, g1_msm and ipa_round launched (at most 5 tables, the
     base point's built once as in a fresh process; one ipa_round a
     round), no g1_scalar_mul and no g1_add (the opening
     folds no point), no curve operation through a plain or host
     version, and no call of the plain Fr ops FR_OPS inside ipa_prove
     (counted by wrapping them while it runs); POLY_PT split into the
     row commitments, ipa_prove and the rest of open (its eq table and
     row fold timed apart).  Every
     ipa_round call of the opening is held against its plain version
     word for word; the opening's own b, x, Q and tape then go through
     ipa_prove_by_folds (whose curve launches and shapes are G1's and
     G2's run): every L_k, R_k, b0 and the tape after must equal the
     opening's, and both openings are timed, the new one split into Q's
     table, the MSMs, the ipa_round launches (and their plain version)
     and the rest.  Then LeNet5 built as cli/runner.py builds it, under
     FiatShamirTape(b"zkcnn-demo-17") with the inner-product commitment,
     counts reset just before the proof: the same WS, PS and POLY_PS, the
     CPU-pinned final tape state and counter, fold_round and
     fold_cubic_round launched as phase calls, no fold and no round or
     cubic ladder (one fold ladder: the output layer's MLE at its point),
     at most one round fetch a phase, at most 4 tables; PT, VT,
     POLY_PT and POLY_VT printed, and verify()'s wall time span by span
     (the commitment's setup, its hash-to-curve apart from its table,
     the commit, the encode-and-absorb of the commitment, the per-round
     proof and check, the opening), its opening held as the three-pass
     run's is (ipa_round calls, no plain Fr op, ipa_prove_by_folds).
     Then the same proof with its rounds
     in the one-round form (round(prev_r), the host tape, a fetch a
     round): the same fingerprint, and its round loops' seconds beside
     the phase calls';
  6. each entry against its plain version at every shape its run
     launched it at (the round kernels exact; the curve kernels as group
     elements, on 32-bit scalars laid out as the run lays them out, and
     at the largest shape on full-size scalars too; the tables entry by
     entry, also at edge shapes that leave groups of a warp and of a block
     empty and at 1 and 2 windows), timed with CUDA events (g1_msm with
     and without building its table), with the least time the card could
     take for the same work beside it;
     fold_round's and fold_cubic_round's phase calls at every phase
     shape of the Fiat-Shamir LeNet run, timed a phase.  Then a LeNet
     side's rounds one by one as the one-round form runs them
     (fold_round, a fetch a round) against one ladder and one phase
     call;
  7. the seconds each phase took, one JSON line of the Fiat-Shamir
     path's measurements (round loops of the phase calls and of the
     one-round form, the device tape's microseconds, fetches, phases and
     device launches, one side three ways, the three-pass POLY_PT's
     split), one JSON line of phase 3's lane
     measurements (each Fp product form's dependent ns; the table's chain
     on lane groups and in one thread, digits and whole, in ms, by
     shape; the registers and spills of the table's and the product's
     kernels), one JSON line of kernel results (each entry's launches,
     shape and times belong to the run its `run` key names: the ladders'
     to LeNet --no-pcs, the per-round path's entries to LeNet under
     FiatShamirTape, the curve kernels' to LeNet
     with the commitment, but g1_add's and g1_scalar_mul's to the
     fold-based opening, with their launches on the main path, 0, beside
     them), the nvidia-smi name/power line, and the final JSON status
     line.
"""

import contextlib
import io
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

# 1-device transcript digests and proof sizes of the tiny models
# (seed 24, Tape(b"dryrun-<name>"), identical to the JAX package's pins)
PINNED_1CHIP = {
    "ccnn4_max": {
        "digest": "1b867d59ffc8f98a2ee23baf77553cd685234ab0"
                  "84d380bbbb03e0bcfee711e4",
        "proof_size": 5440},
    "sconv_muladd": {
        "digest": "d801eb929b093c9ca85f1a783cd3c5a0459e4c2e"
                  "6f4dd10483e1ca8dea418a16",
        "proof_size": 2752},
    "tiny_fc_fft": {
        "digest": "c18f271efe5df09760a90a2de42921745cfab602"
                  "2cee125825f7954b865041c7",
        "proof_size": 10336},
}

# LeNet5 pic_cnt=1, --synthetic --seed 17 --no-pcs: the port's digest on
# the CPU, pinned in tests/test_torch_e2e.py
PINNED_LENET = {
    "digest": "3ffb56eaac141bde0071a6debbd0c8871385aeb1"
              "6878983c6c2242648af12647",
    "WS": "201734(2^18)", "PS": "45.7188"}

# the same with the Hyrax commitment (512 generator draws before the GKR
# proof), pinned in tests/test_torch_pcs_e2e.py
PINNED_LENET_PCS = {
    "digest": "709e96e190e563e67c417485bf3484939e1f0f87a77bcd4a1af7"
              "1376318bf695",
    "POLY_PS": "24.8750"}

# FiatShamirTape(b"dryrun-<name>"), random_source(24), the commitment in
# the given mode: the final tape state and draw counter of the port's run
# on the CPU, pinned in tests/test_torch_fs_paths.py
PINNED_FS_TINY = {
    ("ccnn4_max", "sqrt"): (
        "c5993cff83e015aa5b31b052f57de949ff2d279bafe667ec8198db0467beb60f"
        "759f1a9635b1148ac41e97e5b260c24cb7bd4c051aa4512bcb4de2b3cabc42b1",
        77),
    ("sconv_muladd", "sqrt"): (
        "f1b4f6a2ec7e4fb48a7cf53cd0d01a8d5d319fb7f452775147b435668608b415"
        "3ca462339221cfa8cda9545c27c21bcd78eb5a903cb456e5e3601666861858b5",
        38),
    ("sconv_muladd", "ipa"): (
        "9a1736bf6fcb97cb66a9ab71fb809ca5386cb1c11584a59bddeaf77b8f187db4"
        "65111dd1acbf3538661a4e902ec6aff84eab5269a0c8fe26d81bb199f624f0f2",
        41),
    ("tiny_fc_fft", "sqrt"): (
        "e6d55a26ee681f22e5574b0f3a3733a5446edca1f595c5c9d699117335ca212d"
        "1698cbd51bad5c5de967ff5ba72cc4c02dd68d4687b184b26f486ead2379e7fd",
        128),
}

# LeNet5 pic_cnt=1, random_source(17), FiatShamirTape(b"zkcnn-demo-17"),
# inner-product commitment: the same, pinned in tests/test_torch_fs_paths.py
PINNED_FS_LENET = (
    "10736122550bca8d22784b5b1603a1b99ec37b05a88240315d3a04619be83600"
    "22808f60a53356f4b98f9857960b3c4bf38934bd9d5403597f97b4ea91ccf02b",
    548)

SOURCE = "zkcnn_tpu_torch/csrc/round_kernels.cu"
G1_SOURCE = "zkcnn_tpu_torch/csrc/g1_kernels.cu"
G1_REPLACES = {"g1_add": "zkcnn_tpu/pcs/curve.py:81",         # and pdouble :58
               "g1_scalar_mul": "zkcnn_tpu/pcs/curve.py:147",
               "g1_msm_table": "zkcnn_tpu/pcs/msm.py:100",   # from :269
               "g1_msm": "zkcnn_tpu/pcs/msm.py:271",  # ipa._msm_small :45
               # the opening's round: folds of b and x (:52), the dots
               # (:94) and the fold of G (:62), whose work the weights
               # take over
               "ipa_round": "zkcnn_tpu/pcs/ipa.py:86"}
FR_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FP_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
QUAD = "zkcnn_tpu/field/pallas_round2.py:237"       # and pallas_round.py:249
CUBIC = "zkcnn_tpu/field/pallas_round.py:475"
REPLACES = {"fold_round": QUAD, "fold": QUAD, "fold_cubic_round": CUBIC,
            "round_ladder": QUAD, "fold_ladder": QUAD,
            "cubic_ladder": CUBIC}
# the entries of the per-round (Fiat-Shamir) path and of the three-pass one
PER_ROUND = ("fold_round", "fold", "fold_cubic_round")
LADDERS = ("round_ladder", "fold_ladder", "cubic_ladder")
# the entries whose kernels also run a Fiat-Shamir phase whole
PHASES = ("fold_round", "fold_cubic_round")
P_WORDS = [0x00000001, 0xFFFFFFFF, 0xFFFE5BFE, 0x53BDA402,
           0x09A1D805, 0x3339D808, 0x299D7D48, 0x73EDA753]   # Fr modulus

# The card's published rates (NVIDIA H100 SXM): device memory 3.35 TB/s;
# 32-bit integer multiply-adds on the CUDA cores at half the FP32 lane
# count, so half of 67 TFLOP/s / 2 flops an FMA = 16.75e12 a second.
MEM_BYTES_S = 3.35e12
INT32_MULS_S = 16.75e12
ROW_BYTES = 32
# 32x32->64 multiplies: a full Montgomery product (8x8 for the product,
# 8x8 for its reduction) and a product that is summed unreduced (a dot's;
# the one reduction of the whole sum is not counted)
FULL_MULS = 128
DOT_MULS = 64
QUAD_PAIR_MULS = 4 * DOT_MULS + 2 * FULL_MULS     # four dots, two folds
# per pair of V: e0, e1 (two products), e2; six table dots; two folds
CUBIC_PAIR_MULS = 4 * FULL_MULS + 6 * DOT_MULS + 2 * FULL_MULS
FOLD_PAIR_MULS = FULL_MULS
# Curve work in Fp products of 288 multiplies (a 12 x 12 word product and
# its 12 x 12 word reduction): a Jacobian doubling is 7, an addition 16,
# the addition of a point with Z = 1 (a table entry) 11; a point is 144
# bytes
FP_MULS = 288
DOUBLE_PRODUCTS = 7
ADD_PRODUCTS = 16
MIXED_ADD_PRODUCTS = 11
POINT_BYTES = 144
# the runs that the `launches`, shapes and times of an entry come from
LENET_RUN = "lenet --no-pcs"
LENET_PCS_RUN = "lenet with the commitment"
LENET_FS_RUN = "lenet under FiatShamirTape with the commitment"
FOLDS_RUN = "ipa_prove_by_folds on the opening of lenet with the commitment"
ENGINES_RUN = "the per-round engines at lenet's largest phases"
# curve kernels that the LeNet opening no longer runs: their shapes and
# launches come from FOLDS_RUN
FOLD_KERNELS = ("g1_add", "g1_scalar_mul")
# calls of each opening, in turns, when the two are timed
OPENING_PAIRS = 8
# g1_msm_table's shapes in a LeNet proof with the commitment (N, nwin); and
# edge shapes: chain blocks (2 bases) partly filled, one and two windows,
# the digits on a ragged last block
TABLE_SHAPES = ((1, 64), (20, 64), (512, 64))
TABLE_EDGES = [(3, 64), (5, 2), (7, 1), (37, 63)]
# g1_msm_table launches at most: a three-pass LeNet proof with the
# commitment in a fresh process (the setup's table, the base point's
# table, Q's opening table, the verifier's two) and one under
# FiatShamirTape (no base point: hash-to-curve generators and Q)
TABLES_THREE_PASS = 5
TABLES_FIAT_SHAMIR = 4
# the plain Fr ops that a round of the opening ran before ipa_round; an
# opening on the card must call none of them
FR_OPS = ("dot_mont", "lincomb2_scalar", "mul")
# ipa_round's edge shapes (L, n), each with and without a fold
IPA_EDGE = [(2, 2), (4, 2), (8, 8), (8, 4), (128, 2), (512, 512), (512, 2),
            (1024, 64), (4096, 4096), (4096, 2048)]


def say(msg):
    print(msg, flush=True)


def ptxas_summary(text: str):
    """`nvcc -Xptxas -v` output -> one "kernel<args>: registers, spills"
    line a kernel (names read from the mangled ones: length-prefixed parts,
    then the integer template arguments)."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:
            rest, parts = m.group(1), []
            while rest[:1].isdigit():
                n = re.match(r"\d+", rest).group()
                parts.append(rest[len(n):len(n) + int(n)])
                rest = rest[len(n) + int(n):]
            args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2]) \
                if rest.startswith("I") else []
            name = parts[-1] + (f"<{', '.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} bytes spilled/reloaded"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_fe(torch, n: int, gen):
    """[n, 8] random canonical residues on the card (top word < p's)."""
    w = torch.randint(0, 1 << 32, (n, 8), dtype=torch.int64,
                      device="cuda", generator=gen)
    w[:, 7] %= P_WORDS[7]
    return (w - ((w >> 31) << 32)).to(torch.int32)


def pm1_fe(torch, n: int, gen=None):
    """[n, 8] rows of p - 1: every product and partial sum as large as it
    can be."""
    w = torch.tensor(P_WORDS, dtype=torch.int64, device="cuda")
    w[0] -= 1
    return (w - ((w >> 31) << 32)).to(torch.int32).repeat(n, 1)


def max_err(torch, a, b) -> int:
    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    return int((a - b).abs().max().item())


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def rounds_of(shape) -> int:
    """A shape is (rows, R) or (K, M, R): R rounds of a ladder, R = 1 for
    `fold`, and for the one-round entries R = 1 with a fold at the
    previous challenge, 0 without."""
    return shape[-1]


def bound(name: str, shape):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (inputs read once, outputs written once) over the memory rate
    and the 32-bit multiplies it needs (64 for a product that a dot sums
    unreduced, 128 for a fold's or a cubic term's) over the integer
    rate."""
    R = rounds_of(shape)
    if name == "fold_round":
        # a fold of A and V (rows / 2 pairs each), then the four dots of
        # the pairs of the folded rows
        rows, f = shape
        rows_in, rows_out = 2 * rows + f, f * rows + 4
        muls = f * rows * FOLD_PAIR_MULS + (rows >> (1 + f)) * 4 * DOT_MULS
    elif name == "fold_cubic_round":
        # folds of V0, V1 and of m while it has more than one row, then per
        # pair e0, e1 (two products), e2 and the table dots m0 e and dm e
        # (dm = 0 once m has one row: three dots)
        K, M, f = shape
        fm = f * (M > 1)
        Mf = M // 2 if fm else M
        rows_in = 2 * K + M + f
        rows_out = f * K + fm * (M // 2) + 4
        term_muls = 4 * FULL_MULS + (6 if Mf > 1 else 3) * DOT_MULS
        muls = (f * K + fm * (M // 2)) * FOLD_PAIR_MULS \
            + (K >> (1 + f)) * term_muls
    elif "cubic" in name:
        K, M, _ = shape
        rows_in, rows_out = 2 * K + M + R, 2 * (K >> R) + (M >> R) + 4 * R
        muls = sum(CUBIC_PAIR_MULS * (K >> (j + 1))
                   + FOLD_PAIR_MULS * (M >> (j + 1)) for j in range(R))
    elif name in ("fold", "fold_ladder"):
        rows, _ = shape
        rows_in, rows_out = rows + R, rows >> R
        muls = sum(FOLD_PAIR_MULS * (rows >> (j + 1)) for j in range(R))
    else:
        rows, _ = shape
        rows_in, rows_out = 2 * rows + R, 2 * (rows >> R) + 4 * R
        muls = sum(QUAD_PAIR_MULS * (rows >> (j + 1)) for j in range(R))
    by_bytes = (rows_in + rows_out) * ROW_BYTES / MEM_BYTES_S * 1e3
    by_ops = muls / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(torch, rk, name, shape, gen, rng, fill=rand_fe):
    """Kernel vs plain on the same card tensors; raises on a mismatch.
    Returns (max_abs_err, kernel_fn, plain_fn).  shape: (rows, R) or
    (K, M, R); a one-round step takes R = 1."""
    rs = [rng.getrandbits(254) for _ in range(max(1, rounds_of(shape)))]
    ch = rs if name.endswith("ladder") else rs[0]
    if name in ("fold_round", "fold_cubic_round") and not shape[-1]:
        ch = None                       # round 1: no fold
    if "cubic" in name:
        K, M, _ = shape
        args = (fill(torch, M, gen), fill(torch, K, gen),
                fill(torch, K, gen), ch)
    elif name in ("fold", "fold_ladder"):
        args = (fill(torch, shape[0], gen), ch)
    else:
        args = (fill(torch, shape[0], gen), fill(torch, shape[0], gen), ch)
    kern, plain = getattr(rk, name), getattr(rk, name + "_plain")
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or any(g.shape != w.shape
                                    for g, w in zip(got, want)):
        raise AssertionError(f"{name} at {shape}: output shapes differ")
    err = max(max_err(torch, g, w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{name} at {shape}: kernel differs from its "
                             f"plain version (max abs err {err})")
    return err, (lambda: kern(*args)), (lambda: plain(*args))


def even_rounds(rows: int) -> int:
    """The rounds a row count allows: folded while it is even."""
    return (rows & -rows).bit_length() - 1


def edge_shapes():
    """Edge shapes per entry: the one-round entries with and without a
    fold (fold_cubic_round also with m folding to one row, and with one
    row), the fold at R = 1, the ladders at every round their row counts
    allow."""
    rows = [2, 4, 1554, 1 << 12, 1 << 18]
    cubic = [(2, 2), (4, 2), (4, 4), (1554, 14), (1 << 11, 1 << 9),
             (1 << 12, 1 << 5), (1 << 12, 1 << 12), (1 << 18, 1 << 11)]
    quad = [(m, even_rounds(m)) for m in rows] + [(1 << 18, 3), (1 << 21, 2)]
    wide = [1 << 12, 1 << 18, 1 << 21]
    return {
        "fold_round": [(2, 0), (4, 0), (4, 1)]
                      + [(m, f) for m in wide for f in (0, 1)],
        "fold": [(m, 1) for m in rows],
        "fold_cubic_round": [(2, 2, 0), (4, 2, 1), (4, 4, 1), (4, 1, 1),
                             (1 << 12, 1 << 5, 1), (1 << 12, 1 << 12, 1),
                             (1 << 12, 2, 1), (1 << 18, 1 << 11, 0),
                             (1 << 18, 1 << 11, 1), (1 << 18, 1, 1),
                             (1 << 21, 1 << 11, 0), (1 << 21, 1 << 11, 1)],
        "round_ladder": quad,
        "fold_ladder": quad,
        "cubic_ladder": [(K, M, even_rounds(M)) for K, M in cubic]
                        + [(1 << 21, 1 << 11, 2)],
    }


def tiny_models(zoo, NeuralNetwork, P):
    """The three tiny models of the 1-device pins: every layer kind,
    Liu, FFT conv with its DOT_PROD cubic phase."""

    class _tiny_fc(NeuralNetwork):
        def __init__(self):
            super().__init__(4, 4, 1, 1)
            self.conv_section.append(
                [P.ConvKernel(P.ConvType.FFT, 2, 1, 2, 0, 0)])
            self.pool.append(P.PoolKernel(P.PoolType.AVG, 2, 1))
            self.full_conn = [P.FconKernel(4, 2), P.FconKernel(3, 4)]

    return [
        ("ccnn4_max", lambda: zoo.ccnn(4, 4, 1, 1, P.PoolType.MAX)),
        ("sconv_muladd", lambda: zoo.singleConv(6, 1, 1, 3, 2,
                                                P.ConvType.NAIVE)),
        ("tiny_fc_fft", _tiny_fc),
    ]


def recording_tape(Tape):
    """A plain seeded tape that keeps every absorbed value."""

    class Recording(Tape):
        def __init__(self, seed):
            super().__init__(seed)
            self.absorbed = []

        def absorb(self, *values):
            self.absorbed.append(tuple(v % FR_P for v in values))

    return Recording


def per_round_phases(torch, engine, FiatShamirTape, how, rss=None):
    """A quadratic phase (sides of 2^18 and 2^12 rows, a nonzero add_term,
    one round past the longer side) and a DOT_PROD phase 1 ((K, M) =
    (2^16, 2^9)) on card tensors made from a fixed seed, run whole under
    a FiatShamirTape (`run_fs`, which draws the challenges), or at the
    challenges rss it drew by `run_all` or per round (`round(prev_r)`,
    then `receive` at the last challenge); returns both lists of round
    messages, the final claims and the challenges."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    rng = random.Random(24)
    sides = [engine.Side(rand_fe(torch, 1 << nb, gen),
                         rand_fe(torch, 1 << nb, gen), nb) for nb in (18, 12)]
    quad = engine.PhaseEngine(sides, add_term=rng.getrandbits(254))
    cubic = engine.DotProdPhase1(rand_fe(torch, 1 << 9, gen),
                                 rand_fe(torch, 1 << 16, gen),
                                 rand_fe(torch, 1 << 16, gen), 9, 16)
    out, drawn = [], []
    for k, (phase, R) in enumerate(((quad, 19), (cubic, 16))):
        if how == "fs":
            tape = FiatShamirTape(b"engines")
            polys, rs, _, _ = phase.run_fs(R, tape.state, tape.counter)
            out.append(polys)
            drawn.append(rs)
            continue
        rs = rss[k]
        if how == "round":
            out.append([phase.round(rs[j - 1] if j else None)
                        for j in range(R)])
            phase.receive(rs[-1])
        else:
            out.append(phase.run_all(rs))
    claims = [quad.final_claim_dev(0, 18), quad.final_claim_dev(1, 12),
              *cubic.finalize_dev()]
    return out, torch.stack(claims), drawn or rss


def phase_edges():
    """Phase shapes held against the plain version in phase 3: one side
    of 2, 4, 2^12, 2^18 and 2^21 rows (as many rounds), Liu's phase
    (include_add_term False), LeNet's largest sides (2^18 and 2^12 rows,
    one round past the longer), sides that exhaust mid-phase, a side of
    one and of two rows; DOT_PROD phases with m folding to one row, as
    wide as V and of one row, LeNet's largest (2^16, 2^9), and 2^21."""
    quad = [(-1, nb, nb, True) for nb in (1, 2, 12, 18, 21)]
    quad += [(-1, 12, 12, False), (18, 12, 19, True), (3, 10, 10, True),
             (0, 9, 9, True), (1, 2, 4, True)]
    cubic = [(2, 2, 1), (4, 2, 2), (1 << 12, 1 << 5, 12), (1 << 8, 1, 8),
             (1 << 10, 1 << 10, 10), (1 << 16, 1 << 9, 16),
             (1 << 21, 1 << 11, 21)]
    return {"fold_round": quad, "fold_cubic_round": cubic}


def phase_compare(torch, rk, name, shape, gen, rng, fill=rand_fe):
    """The phase call against its plain version on the same card tensors,
    word for word (its buffer: the tape's state and counter, add_term, the
    challenges and messages; each side's last rows); raises on a
    mismatch.  A quadratic shape is (nb0, nb1, n, include) with -1 for no
    side (add_term an [8] tensor when both sides are there, else a host
    int), a cubic one (K, M, n).  Returns (max_abs_err, kernel_fn,
    plain_fn)."""
    state, counter = bytes(rng.getrandbits(8) for _ in range(64)), \
        rng.choice([0, 255, 256, 1 << 32, rng.getrandbits(40)])
    if name == "fold_round":
        nb0, nb1, n, include = shape
        sides = [None if nb < 0 else (fill(torch, 1 << nb, gen),
                                      fill(torch, 1 << nb, gen))
                 for nb in (nb0, nb1)]
        add = fill(torch, 1, gen)[0] if nb0 >= 0 else rng.getrandbits(254)
        args = (sides, n, add, include, state, counter)
    else:
        K, M, n = shape
        args = (fill(torch, M, gen), fill(torch, K, gen), fill(torch, K, gen),
                n, state, counter)
    kern = getattr(rk, name + "_phase")
    plain = getattr(rk, name + "_phase_plain")
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w) for g, w in zip(got[:2], want[:2]))
    if err:
        raise AssertionError(f"{name} phase at {shape}: kernel differs from "
                             f"its plain version (max abs err {err})")
    return err, (lambda: kern(*args)), (lambda: plain(*args))


def phase_bound(name: str, shape):
    """(bound_ms, bound_by) of a whole phase: its operands read once, the
    buffer and last rows written once; the multiplies of every round (a
    fold pair's full product, a dot's unreduced one; a cubic pair's terms)
    at the integer rate.  The device tape's hashing is not counted."""
    if name == "fold_round":
        nb0, nb1, n, _ = shape
        rows_in = sum(2 << nb for nb in (nb0, nb1) if nb >= 0)
        rows_out = 4 + 4 * n + 4
        muls = 0
        for nb in (nb0, nb1):
            for j in range(max(nb, 0)):      # round j: fold, then dots
                muls += (j > 0) * 2 * (1 << (nb - j)) * FOLD_PAIR_MULS \
                    + (1 << (nb - j - 1)) * 4 * DOT_MULS
            muls += (nb >= 0) * 2 * FOLD_PAIR_MULS          # the last fold
    else:
        K, M, n = shape
        rows_in, rows_out = 2 * K + M, 4 + 5 * n + 3
        muls = sum(CUBIC_PAIR_MULS * (K >> (j + 1))
                   + FOLD_PAIR_MULS * (M >> (j + 1)) for j in range(n))
    by_bytes = (rows_in + rows_out) * ROW_BYTES / MEM_BYTES_S * 1e3
    by_ops = muls / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def tape_checks(torch, rk, FR, gen, rng, smi):
    """The device tape (check entry fs_tape_check) against the host's
    hashlib, word for word: 10^4 random states, absorbs of three values
    (0, 1 and p - 1 among them), draws at counters 0, 255, 256, 2^32 and
    random ones, and digests 0, all 0xff and next to multiples of p; then
    one case on one thread, timed: a round's absorb and draw."""
    n = 10000

    def table(xs, w):
        rows = [[(x >> (32 * k)) & 0xFFFFFFFF for k in range(w)] for x in xs]
        t = torch.tensor(rows, dtype=torch.int64)
        return (t - ((t >> 31) << 32)).to(torch.int32).to("cuda")

    states = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 16), dtype=torch.int32,
                           device="cuda", generator=gen)
    vals = rand_fe(torch, 3 * n, gen).reshape(n, 3, 8)
    vals[:3] = torch.from_numpy(FR.pack_mont_host([0, 1, FR_P - 1] * 3)) \
        .reshape(3, 3, 8).to("cuda")
    ctrs = [0, 255, 256, 1 << 32, (1 << 32) - 1]
    ctrs += [rng.getrandbits(62) for _ in range(n - len(ctrs))]
    top = (1 << 512) // FR_P
    digs = [0, (1 << 512) - 1, (1 << 256) - 1]
    for k in [1, 2, top - 1, top] + [rng.randrange(top) for _ in range(30)]:
        digs += [k * FR_P - 1, k * FR_P, k * FR_P + 1]
    digs += [rng.getrandbits(512) for _ in range(n - len(digs))]
    counters, digests = table(ctrs, 2), table(digs, 16)
    got = rk.fs_tape_check(states, vals.contiguous(), counters, digests)
    want = rk.fs_tape_check_plain(states, vals, counters, digests)
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"the device tape differs from hashlib (max abs "
                             f"err {err})")
    one = tuple(x[:1].contiguous() for x in (states, vals, counters,
                                             digests))
    us = time_ms(torch, lambda: rk.fs_tape_check(*one), 50) * 1e3
    say(f"device tape (fs_tape_check) exact against hashlib on {n} cases "
        f"(values 0, 1, p - 1; counters 0, 255, 256, 2^32; digests 0, all "
        f"0xff, next to multiples of p); one thread's absorb of three "
        f"values and draw, launch included: {us:.2f} us ({smi})")
    return us


def time_once_ms(torch, fn):
    """One timed call with no warm-up, for a plain version that takes
    seconds; returns (ms, result)."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e), out


def plain_words(torch, ks):
    """host ints -> [k, 8] plain scalar words on the card."""
    rows = [[(k >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for k in ks]
    w = torch.tensor(rows, dtype=torch.int64, device="cuda")
    return (w - ((w >> 31) << 32)).to(torch.int32)


def same_points(msm_mod, got, want, what) -> int:
    """The number of positions at which the two point tensors hold
    different group elements; raises unless it is 0."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: output shapes differ")
    wrong = int((~msm_mod.points_equal(got, want)).sum().item())
    if wrong:
        raise AssertionError(f"{what}: kernel and plain version give "
                             f"different points at {wrong} positions")
    return wrong


def rand_scalars(torch, n: int, gen, bits: int):
    """[n, 8] random plain scalars below the modulus on the card: of full
    size (bits = 255) or of one word (bits = 32)."""
    k = rand_fe(torch, n, gen)
    if bits == 32:
        k[:, 1:] = 0
    return k


def g1_inputs(torch, curve, msm_mod, FR, name, shape, gen, bits=255):
    """Random operands of a curve kernel at `shape` on the card, laid out
    as the LeNet run lays them out: (the plain scalars or None, the kernel
    call, the plain call).  Points are k G from the scalar-multiplication
    kernel, so their Z is not 1.  With bits = 32 the scalars have one
    word and the plain version runs 32 steps, which takes seconds where
    255 take a minute.  g1_scalar_mul's shape names what its threads
    share ("point", "scalar" or nothing); a two-row MSM is a round of the
    inner-product opening, whose rows are zero over the other row's half
    of the bases."""
    base = curve.base_point("cuda")
    if name == "g1_msm_table":
        N, nwin = shape
        pts = curve.scalar_mul(base, rand_fe(torch, N, gen))
        return (None, lambda: curve.table_kernel(pts, nwin),
                lambda: msm_mod.msm_table_plain(pts, nwin))
    if name == "g1_add":
        a = curve.scalar_mul(base, rand_fe(torch, shape[0], gen))
        b = curve.scalar_mul(base, rand_fe(torch, shape[0], gen))
        return (None, lambda: curve.padd(a, b),
                lambda: curve.padd_plain(a, b))
    if name == "g1_scalar_mul":
        n, nbits, shared = shape
        pts = curve.scalar_mul(
            base, rand_fe(torch, 1 if shared == "point" else n, gen))
        k = rand_scalars(torch, 1 if shared == "scalar" else n, gen, bits)
        if shared == "point":
            pts = pts[0]
        if shared == "scalar":
            k = k[0]
        return (k.expand(n, 8), lambda: curve.scalar_mul(pts, k, nbits),
                lambda: curve.scalar_mul_plain(pts, k, min(nbits, bits)))
    R, N = shape
    pts = curve.scalar_mul(base, rand_fe(torch, N, gen))
    k = rand_scalars(torch, R * N, gen, bits).reshape(R, N, 8)
    if R == 2:
        k[0, N // 2:] = 0
        k[1, :N // 2] = 0
    mont = FR.mul_scalar(k, FR.const(FR.R, "cuda"))       # k R
    fixed = msm_mod.FixedBaseMSM(pts)
    kern = lambda: fixed.compute(mont)                  # noqa: E731
    kern.with_table = lambda: msm_mod.FixedBaseMSM(pts).compute(mont)
    return k, kern, lambda: msm_mod.msm_plain(pts, mont, bits)


def g1_bound(torch, curve, name, shape, scalars):
    """(bound_ms, bound_by) of a curve kernel on this run's operands: the
    bytes it must move against the multiplies of the cheapest algorithm
    this script can defend for the function, in Fp products of 288
    multiplies.  g1_add: 16 products a pair.  A point a thread
    (g1_scalar_mul without a shared point): 4-bit windows with the
    point's 15 multiples for free, so bit length - 1 doublings of 7 and
    one addition of 16 less than its nonzero digits, a scalar.  Shared
    bases (g1_msm, whose N bases serve all R rows, and g1_scalar_mul
    with one point): a fixed-base table of d 2^(4j) P with Z = 1, whose
    doublings are counted once a base (the longest scalar it meets, less
    one) and whose digit multiples and normalisation are not counted;
    then every nonzero digit is one addition of a table entry (11
    products), less one for each output, whose first entry is a copy.
    The row sums of an MSM are among those additions."""
    if name == "g1_add":
        n = shape[0]
        products, nbytes = ADD_PRODUCTS * n, 3 * POINT_BYTES * n
    else:
        nbits = shape[1] if name == "g1_scalar_mul" else 255
        bits = curve.scalar_bits(scalars, nbits)
        pos = torch.arange(1, nbits + 1, device=bits.device)
        top = (bits * pos).amax(-1)                   # bit lengths
        pad = torch.zeros(bits.shape[:-1] + (-nbits % 4,), dtype=bits.dtype,
                          device=bits.device)
        digits = torch.cat([bits, pad], -1).reshape(*bits.shape[:-1], -1, 4)
        nonzero = (digits.sum(-1) > 0).sum(-1)        # digits a scalar
        if name == "g1_msm":
            R, N = shape
            doublings = (top.amax(0) - 1).clamp(min=0).sum().item()
            adds = (nonzero.sum(1) - 1).clamp(min=0).sum().item()
            add_products = MIXED_ADD_PRODUCTS
            nbytes = N * POINT_BYTES + R * N * 32 + R * POINT_BYTES
        else:
            adds = (nonzero - 1).clamp(min=0).sum().item()
            if shape[2] == "point":
                doublings = max(top.amax().item() - 1, 0)
                add_products = MIXED_ADD_PRODUCTS
            else:
                doublings = (top - 1).clamp(min=0).sum().item()
                add_products = ADD_PRODUCTS
            nbytes = shape[0] * (2 * POINT_BYTES + 32)
        products = DOUBLE_PRODUCTS * doublings + add_products * adds
    by_bytes = nbytes / MEM_BYTES_S * 1e3
    by_ops = products * FP_MULS / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def table_bound(shape, part: str = "table"):
    """(bound_ms, bound_by) of g1_msm_table at (N, nwin), counted as
    g1_bound counts: the chain 2^t P, t < 4 nwin, is 4 nwin - 1 doublings
    of 7 products a base and holds the digits 1, 2, 4 and 8 of every
    window; the other 11 digits are one addition of 11 products (a Z = 1
    entry) each.  Or the bytes of the bases in and the table out.  part:
    "table", or one of its kernels, "chain" (the bases in, 4 entries a
    window out) or "digits" (4 entries a window in, 11 out)."""
    N, nwin = shape
    doublings = N * DOUBLE_PRODUCTS * (4 * nwin - 1)
    adds = N * MIXED_ADD_PRODUCTS * 11 * nwin
    products, entries = {"table": (doublings + adds, 1 + 15 * nwin),
                         "chain": (doublings, 1 + 4 * nwin),
                         "digits": (adds, 15 * nwin)}[part]
    nbytes = N * POINT_BYTES * entries
    by_bytes = nbytes / MEM_BYTES_S * 1e3
    by_ops = products * FP_MULS / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def table_lanes(curve):
    """(lanes a product, lanes a base) of g1_msm_table's chain."""
    import ctypes
    product, base = ctypes.c_int(), ctypes.c_int()
    curve.g1_lib().zk_g1_table_lanes(ctypes.byref(product),
                                     ctypes.byref(base))
    return product.value, base.value


def needs_final_subtraction(x: int, y: int) -> bool:
    """Whether the CIOS product of x and y ends at or above p (R = 2^384)."""
    r = 1 << 384
    t = x * y
    m = t * (-pow(FP_P, -1, r)) % r
    return (t + m * FP_P) >> 384 >= FP_P


def fp_checks(torch, curve, FP, rng, smi):
    """The curve kernels' Fp product, in one thread (zk_fp_mul) and split
    over the table chain's lanes (zk_fp_mul_lanes), against Python
    integers on edge values (all pairs), 64 pairs that need the final
    subtraction and 10^5 random pairs, and over a chain of 20000 dependent
    products, whose latency it prints form by form; raises on a mismatch.
    Returns {lanes: ns a dependent product} (1: one thread)."""
    import numpy as np
    lib = curve.g1_lib()
    rinv = pow(1 << 384, -1, FP_P)
    top = FP_P >> 352
    edge = [0, 1, 2, FP_P - 1, FP_P - 2, (1 << 384) % FP_P,
            (top << 352) - 1, (1 << 352) - 1, (1 << 380) - 1]
    sub = []
    while len(sub) < 64:
        x, y = rng.randrange(FP_P), rng.randrange(FP_P)
        if needs_final_subtraction(x, y):
            sub.append((x, y))
    xs = [a for a in edge for _ in edge] + [x for x, _ in sub] + \
        [rng.randrange(FP_P) for _ in range(100000)]
    ys = edge * len(edge) + [y for _, y in sub] + \
        [rng.randrange(FP_P) for _ in range(100000)]

    def pack(vals):
        return torch.from_numpy(np.stack(
            [FP.words_host(v) for v in vals])).to("cuda")

    def product(lanes, a, b, n, chain):
        out = torch.empty_like(a[:n])
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n, chain)
        fn = lib.zk_fp_mul if lanes == 1 else lib.zk_fp_mul_lanes
        curve.launch(fn, *args, curve.stream_of(a.device))
        return out

    A, B = pack(xs), pack(ys)
    want = [x * y * rinv % FP_P for x, y in zip(xs, ys)]
    chained = xs[-1] * pow(ys[-1] * rinv, 20000, FP_P) % FP_P
    ns = {}
    for lanes in (1, table_lanes(curve)[0]):
        got = [FP.int_host(w) for w in
               product(lanes, A, B, len(xs), 0).cpu().numpy()]
        wrong = sum(g != w for g, w in zip(got, want))
        if wrong:
            raise AssertionError(f"the device Fp product ({lanes} lanes) "
                                 f"differs from Python integers at {wrong} "
                                 f"of {len(xs)} pairs")
        times = {}
        for chain in (2000, 20000):
            times[chain] = time_ms(
                torch, lambda: product(lanes, A[-1:], B[-1:], 1, chain), 3)
        x = FP.int_host(product(lanes, A[-1:], B[-1:], 1, 20000)
                        .cpu().numpy()[0])
        if x != chained:
            raise AssertionError(f"a chain of 20000 device Fp products "
                                 f"({lanes} lanes) differs from Python "
                                 f"integers")
        ns[lanes] = (times[20000] - times[2000]) / 18000 * 1e6
    say(f"device Fp product, one thread and split over lanes, "
        f"equals Python integers on {len(edge)}^2 edge pairs (0, 1, p - 1, "
        f"R mod p, words of 0xffffffff below p, ...), {len(sub)} pairs that "
        f"need the final subtraction and 10^5 random pairs, and over a chain "
        f"of 20000; a dependent product: "
        + ", ".join(f"{'one thread' if k == 1 else f'{k} lanes'} "
                    f"{v:.1f} ns" for k, v in ns.items()) + f" ({smi})")
    return ns


def table_sweep(torch, curve, gen, smi):
    """g1_msm_table's stages apart at TABLE_SHAPES: the chain
    (zk_g1_table_chain) on lane groups and in one thread a base, the lane
    chain's entries d = 1, 2, 4, 8 word for word equal to the one-thread
    chain's; the digits (zk_g1_table_digits) on the lane chain, which then
    equals the whole table (zk_g1_msm_table) word for word; each timed
    beside its bound, and the whole table.  Raises on a mismatch; returns
    {shape: {"chain": ms, "thread_chain": ms, "digits": ms, "table":
    ms}}."""
    lib = curve.g1_lib()
    base = curve.base_point("cuda")
    lanes, per_base = table_lanes(curve)
    chain_entries = [(1 << s) - 1 for s in range(curve.WBITS)]
    out = {}
    for N, nwin in TABLE_SHAPES:
        pts = curve.scalar_mul(base, rand_fe(torch, N, gen))
        stream = curve.stream_of(pts.device)
        tabs, times = {}, {}
        for one_thread in (1, 0):
            tab = torch.zeros((N, nwin, curve.WTAB, 3, 12), dtype=torch.int32,
                              device="cuda")
            run = lambda: curve.launch(  # noqa: E731
                lib.zk_g1_table_chain, pts.data_ptr(), tab.data_ptr(), N,
                nwin, one_thread, stream)
            run()
            tabs[one_thread] = tab
            times[one_thread] = time_ms(torch, run, 5)
        if not torch.equal(tabs[0][:, :, chain_entries],
                           tabs[1][:, :, chain_entries]):
            raise AssertionError(f"the table's chain on lane groups differs "
                                 f"from the one-thread chain at {(N, nwin)}")
        whole = curve.table_kernel(pts, nwin)
        tab = tabs[0]
        run = lambda: curve.launch(  # noqa: E731
            lib.zk_g1_table_digits, tab.data_ptr(), N, nwin, stream)
        run()
        if not torch.equal(tab, whole):
            raise AssertionError(f"chain and digits apart differ from "
                                 f"g1_msm_table at {(N, nwin)}")
        out[(N, nwin)] = t = {
            "chain": times[0], "thread_chain": times[1],
            "digits": time_ms(torch, run, 5),
            "table": time_ms(torch, lambda: curve.table_kernel(pts, nwin), 5)}
        bounds = {k: table_bound((N, nwin), k)
                  for k in ("chain", "digits", "table")}
        say(f"g1_msm_table at {(N, nwin)}: chain on lane groups ({lanes} "
            f"lanes a product, {per_base} a base) {t['chain']:.4f} ms, one "
            f"thread a base {t['thread_chain']:.4f} ms (bound "
            f"{bounds['chain'][0]:.6f} ms by {bounds['chain'][1]}); digits "
            f"{t['digits']:.4f} ms (bound {bounds['digits'][0]:.6f} ms by "
            f"{bounds['digits'][1]}); the table {t['table']:.4f} ms (bound "
            f"{bounds['table'][0]:.6f} ms by {bounds['table'][1]}) ({smi})")
    say(f"g1_msm_table's chain on lane groups equals the one-thread chain "
        f"word for word, and chain plus digits the table, at "
        f"{list(TABLE_SHAPES)}")
    return out


def g1_checks(torch, curve, msm_mod, FR, gen, rng):
    """The curve kernels against Python integers on the host and against
    their plain versions on the card (as group elements); raises on a
    mismatch."""
    G = (curve.G1_X, curve.G1_Y)
    base = curve.base_point("cuda")
    neg = lambda P: None if P is None else (P[0], (-P[1]) % FP_P)

    # g1_scalar_mul at 255 bits against py_mul: one shared point, then
    # a point a thread, then one shared scalar
    ks = [0, 1, FR_P - 1, (1 << 254) | 3, 3] + \
        [rng.randrange(FR_P) for _ in range(3)]
    pts = curve.scalar_mul(base, plain_words(torch, ks))
    aff = [curve.py_mul(G, k) for k in ks]
    if curve.to_affine_host(pts) != aff:
        raise AssertionError("g1_scalar_mul: k G differs from py_mul")
    ks2 = [rng.randrange(FR_P) for _ in ks]
    ks2[1:4] = [FR_P - 1, 1, 0]
    got = curve.scalar_mul(pts, plain_words(torch, ks2))
    if curve.to_affine_host(got) != [curve.py_mul(P, k) if P else None
                                     for P, k in zip(aff, ks2)]:
        raise AssertionError("g1_scalar_mul: k P differs from py_mul")
    got = curve.scalar_mul(pts, plain_words(torch, ks2[:1])[0])
    if curve.to_affine_host(got) != [curve.py_mul(P, ks2[0]) if P else None
                                     for P in aff]:
        raise AssertionError("g1_scalar_mul: shared scalar differs from "
                             "py_mul")
    say("g1_scalar_mul equals py_mul at 255 bits: scalars 0, 1, p - 1, "
        "bit 254 set, random; a shared point, a point a thread (infinity "
        "among them), a shared scalar")
    # ... and at 16 and 32 bits against the plain version (a 255-bit
    # plain run is about 10^6 launches)
    for n in (1, 2, 3, 512):
        for nbits in (16, 32):
            for shared in ("", "point"):
                _, kern, plain = g1_inputs(torch, curve, msm_mod, FR,
                                           "g1_scalar_mul",
                                           (n, nbits, shared), gen)
                same_points(msm_mod, kern(), plain(),
                            f"g1_scalar_mul n={n} nbits={nbits} {shared}")
    say("g1_scalar_mul (a point a thread) and a shared point (its table "
        "and g1_msm) equal their plain version at 16 and 32 bits, "
        "n = 1, 2, 3, 512")

    # g1_add: the edge cases against Python integers and the plain
    # version, then random points
    P, Q = aff[1], aff[5]
    pa = [None, None, P, P, P, Q, Q]
    pb = [None, P, None, P, neg(P), P, neg(Q)]
    jac = lambda ps: torch.stack(
        [pts[aff.index(X)] if X in aff else
         curve.pneg(pts[aff.index(neg(X))]) for X in ps])
    a, b = jac(pa), jac(pb)
    got = curve.padd(a, b)
    if curve.to_affine_host(got) != [curve.py_add(x, y)
                                     for x, y in zip(pa, pb)]:
        raise AssertionError("g1_add: edge cases differ from py_add")
    if curve.to_affine_host(curve.pdouble(a)) != [curve.py_add(x, x)
                                                  for x in pa]:
        raise AssertionError("g1_add without a second operand differs "
                             "from py_add(P, P)")
    same_points(msm_mod, got, curve.padd_plain(a, b), "g1_add edge cases")
    worst = max_err(torch, got, curve.padd_plain(a, b))
    for n in (1, 2, 3, 1554, 1 << 18):
        _, kern, plain = g1_inputs(torch, curve, msm_mod, FR,
                                   "g1_add", (n,), gen)
        g, w = kern(), plain()
        same_points(msm_mod, g, w, f"g1_add n={n}")
        worst = max(worst, max_err(torch, g, w))
        a = g
        same_points(msm_mod, curve.pdouble(a), curve.pdouble_plain(a),
                    f"g1_add (doubling) n={n}")
    say(f"g1_add equals py_add on inf + inf, inf + P, P + inf, P + P, "
        f"P + (-P), and its plain version at n = 1, 2, 3, 1554, 2^18 (as "
        f"points; its coordinates differ from the plain version's by at "
        f"most {worst})")

    # g1_msm against Python integers (known discrete logs) at full-size
    # scalars, and against the plain version at 32-bit scalars (at 255
    # bits a plain run takes a minute; phase 6 makes one at the LeNet
    # shape)
    for R, N in ((1, 1), (3, 5), (2, 512), (3, 130)):
        gk = [rng.randrange(FR_P) for _ in range(N)]
        if N > 1:
            gk[1] = gk[0]                      # a repeated base
        bases = curve.scalar_mul(base, plain_words(torch, gk))
        fixed = msm_mod.FixedBaseMSM(bases)
        for bits in (255, 32):
            coeffs = [rng.getrandbits(bits) % FR_P for _ in range(R * N)]
            coeffs[0] = 0
            k = torch.from_numpy(FR.pack_mont_host(coeffs)).cuda().reshape(
                R, N, 8)
            got = fixed.compute(k)
            want = [curve.py_mul(G, sum(c * g for c, g in zip(
                coeffs[r * N:(r + 1) * N], gk)) % FR_P) for r in range(R)]
            if curve.to_affine_host(got) != want:
                raise AssertionError(f"g1_msm ({R}, {N}) differs from "
                                     f"py_mul at {bits}-bit scalars")
        same_points(msm_mod, got, msm_mod.msm_plain(bases, k, 32),
                    f"g1_msm ({R}, {N})")
    say("g1_msm equals py_mul (255- and 32-bit scalars) and its plain "
        "version (32-bit) at (R, N) = (1, 1), (3, 5), (2, 512), (3, 130), "
        "with a zero scalar and a repeated base")


def ipa_round_check(torch, ipa, args, what):
    """ipa_round against its plain version on the operands args (b, x,
    s, prev), word for word (rows, weights, folded b and x); raises on a
    mismatch.  Returns (max_abs_err, kernel_fn, plain_fn)."""
    kern, plain = (lambda: ipa.ipa_round(*args)), \
        (lambda: ipa.ipa_round_plain(*args))
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w) for g, w in zip(got, want)) \
        if all(g.shape == w.shape for g, w in zip(got, want)) else -1
    if err:
        raise AssertionError(f"ipa_round at {what}: kernel differs from "
                             f"its plain version (max abs err {err})")
    return err, kern, plain


def ipa_round_compare(torch, ipa, shape, fold, gen, rng, fill=rand_fe):
    """ipa_round at (L, n) on the card: b and x of n words (2n where
    fold is set, with a previous challenge: p - 1 with pm1_fe), the
    weights from `fill` too, against its plain version (ipa_round_check)."""
    L, n = shape
    m = 2 * n if fold else n
    b, x, s = fill(torch, m, gen), fill(torch, m, gen), fill(torch, L, gen)
    prev = None
    if fold:
        c = FR_P - 1 if fill is pm1_fe else rng.randrange(1, FR_P)
        prev = (c, pow(c, -1, FR_P))
    return ipa_round_check(torch, ipa, (b, x, s, prev),
                           f"{shape}, fold {fold}")


def ipa_round_shape(args):
    """(L, n) and whether it folds, of ipa_round's operands (b, x, s,
    prev)."""
    b, _, s, prev = args
    n = b.shape[0] // 2 if prev is not None else b.shape[0]
    return (s.shape[0], n), prev is not None


def ipa_round_bound(shape, fold):
    """(bound_ms, bound_by) of ipa_round at (L, n): b and x (2n words
    each with a fold, else n) and the weights read once, the rows
    written once and, with a fold, the folded b and x and the weights
    written once, against its Fr
    products at 128 multiplies each: the fold's four a term (with a
    fold), the dots' n, the weights' L (with a fold) and the rows' L.
    Without a fold b, x and the weights are not written: they stay."""
    L, n = shape
    m = 2 * n if fold else n
    nbytes = (2 * m + L + 2 * (L + 1) + ((2 * n + L) if fold else 0)) \
        * ROW_BYTES
    products = (4 * n + L if fold else 0) + n + L
    by_bytes = nbytes / MEM_BYTES_S * 1e3
    by_ops = products * FULL_MULS / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def table_shapes(torch, curve, msm_mod, shapes, gen):
    """g1_msm_table at each of its shapes (N, nwin) against one call of
    the plain version on all their bases at once (its time is a chain of
    doublings, whatever N), entries compared as group elements; raises on
    a mismatch."""
    nwin = max(w for _, w in shapes)
    base = curve.base_point("cuda")
    pts = curve.scalar_mul(base, rand_fe(torch, sum(n for n, _ in shapes),
                                         gen))
    want = msm_mod.msm_table_plain(pts, nwin)
    at = 0
    for N, w in shapes:
        got = curve.table_kernel(pts[at:at + N], w)
        same_points(msm_mod, got, want[at:at + N, :w],
                    f"g1_msm_table at {(N, w)}")
        at += N
    say(f"g1_msm_table equals its plain version, entry by entry as group "
        f"elements, at {shapes}")


def capture_opening(torch, hyrax, ipa, FR):
    """Wraps hyrax.ipa_prove so that the openings that follow keep their
    inputs: returns the dict the last one fills (b, x, the generators'
    FixedBaseMSM, Q, t and a clone of the tape as the rounds start; the
    operands of its ipa_round calls; its calls of the plain Fr ops
    FR_OPS, counted by wrapping them while it runs; its seconds, the
    device finished) and a function that undoes the wrap."""
    seen, real, real_round = {}, hyrax.ipa_prove, ipa.ipa_round

    def counted(name):
        fn = getattr(FR, name)

        def call(*args, **kw):
            seen["fr_calls"][name] += 1
            return fn(*args, **kw)
        return call

    def keep_round(*args):
        seen["rounds"].append(args)
        return real_round(*args)

    def run(b, x, gen_msm, Q, t, tape):
        seen.update(b=b.clone(), x=x.clone(), gen_msm=gen_msm, Q=Q.clone(),
                    t=t, tape=tape.clone(), rounds=[],
                    fr_calls={k: 0 for k in FR_OPS})
        ipa.ipa_round = keep_round
        for k in FR_OPS:
            setattr(FR, k, counted(k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(b, x, gen_msm, Q, t, tape)
        finally:
            torch.cuda.synchronize()
            seen["ipa_s"] = time.perf_counter() - t0
            ipa.ipa_round = real_round
            for k in FR_OPS:
                delattr(FR, k)

    hyrax.ipa_prove = run
    return seen, lambda: setattr(hyrax, "ipa_prove", real)


def opening_fr_check(seen, run):
    """The opening of `run` made no plain Fr op call and launched
    ipa_round once a round; raises otherwise."""
    rounds = seen["b"].shape[0].bit_length() - 1
    if any(seen["fr_calls"].values()) or len(seen["rounds"]) != rounds:
        raise AssertionError(f"{run}: the opening called {seen['fr_calls']} "
                             f"and ipa_round {len(seen['rounds'])} times for "
                             f"{rounds} rounds")
    say(f"{run}: ipa_prove made no plain Fr op call ({seen['fr_calls']}) "
        f"and {rounds} ipa_round calls in {seen['ipa_s']:.4f} s")


def poly_pt_split(torch, hyrax, FR, opened, res, seen, smi):
    """POLY_PT of a LeNet run with the commitment, in its parts: the row
    commitments and ipa_prove, as the run timed them, and the rest of
    open (POLY_PT less those two: its eq table of r_hi, its row fold,
    `FR.dot_mont` over the matrix, and whatever else open does); the eq
    table and the fold then timed alone on the run's own operands, and
    eq_lo's table (outside POLY_PT) beside them."""
    pcs, val0, r = (opened[k] for k in ("pcs", "val0", "r"))
    dev = pcs.device
    eq_hi = hyrax.beta_table(r[pcs.l_col:], 1, dev)
    mat = pcs._matrix(val0)
    part = {
        "commit_s": res["poly_commit_s"], "ipa_prove_s": seen["ipa_s"],
        "eq_hi_ms": time_ms(torch, lambda: hyrax.beta_table(
            r[pcs.l_col:], 1, dev), 5),
        "row_fold_ms": time_ms(torch, lambda: FR.dot_mont(
            mat, eq_hi[:, None, :], axis=0), 5),
        "eq_lo_ms": time_ms(torch, lambda: hyrax.beta_table(
            r[:pcs.l_col], 1, dev), 5)}
    part["open_rest_s"] = res["poly_pt"] - part["commit_s"] \
        - part["ipa_prove_s"]
    say(f"{LENET_PCS_RUN}: POLY_PT {res['poly_pt']:.4f} s = the row "
        f"commitments {part['commit_s']:.4f} s + ipa_prove "
        f"{part['ipa_prove_s']:.4f} s + the rest of open (not timed "
        f"itself: POLY_PT less the two) {part['open_rest_s']:.4f} s; "
        f"measured apart on the run's operands: eq table of r_hi "
        f"{part['eq_hi_ms']:.4f} ms, row fold over {tuple(mat.shape[:2])} "
        f"{part['row_fold_ms']:.4f} ms, "
        f"eq table of r_lo (outside POLY_PT) {part['eq_lo_ms']:.4f} ms "
        f"({smi})")
    return part


def wall_ms(torch, fn) -> float:
    """Host milliseconds of one call of fn, the device finished, after
    one call of warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def opening_checks(torch, ipa, curve, msm_mod, seen, smi, run):
    """The captured opening of the LeNet run `run` again, on its own b,
    x, Q and tape: every ipa_round call of the run against its plain
    version, word for word; ipa_prove_by_folds (its curve launches and
    shapes counted alone) held against ipa_prove, every L_k and R_k as
    group elements and b0, and the tapes after; both timed, a call each
    in turns, the new one split into Q's table, the MSMs on [G; Q], the
    ipa_round launches and the rest.  Returns the by-folds run's
    (launches, shapes) and the rounds' largest error."""
    b, x, gen_msm, Q, t = (seen[k] for k in ("b", "x", "gen_msm", "Q", "t"))
    G = gen_msm.points
    err = 0
    for k, args in enumerate(seen["rounds"]):
        err = max(err, ipa_round_check(torch, ipa, args,
                                       f"round {k} of {run}")[0])
    say(f"{run}: its {len(seen['rounds'])} ipa_round calls equal the plain "
        f"version word for word (rows, weights, folded b and x)")
    torch.cuda.synchronize()
    curve.reset_launches()
    ftape = seen["tape"].clone()
    folds = ipa.ipa_prove_by_folds(b, x, G, Q, t, ftape)
    torch.cuda.synchronize()
    fold_run = ({k: curve.LAUNCHES[k] for k in curve.NAMES},
                {k: sorted(curve.SHAPES[k]) for k in curve.NAMES})
    ntape = seen["tape"].clone()
    new = ipa.ipa_prove(b, x, gen_msm, Q, t, ntape)
    if len(new.Ls) != len(folds.Ls) or new.b0 != folds.b0:
        raise AssertionError("the opening on the setup's table and the "
                             "fold-based opening differ in rounds or b0")
    for mine, ref, what in ((new.Ls, folds.Ls, "L_k"),
                            (new.Rs, folds.Rs, "R_k")):
        same_points(msm_mod, torch.stack(mine), torch.stack(ref),
                    f"the opening's {what} against ipa_prove_by_folds")
    if (ntape.counter, getattr(ntape, "state", None)) != (
            ftape.counter, getattr(ftape, "state", None)):
        raise AssertionError("the two openings leave their tapes apart")
    say(f"{run}: the opening on the setup's table equals ipa_prove_by_folds "
        f"at L = {b.shape[0]}: {len(new.Ls)} L_k and R_k as group elements, "
        f"b0, the tape after")
    # the MSMs of one run and the run's ipa_round calls, each timed again
    # on its own operands (host work included)
    msms, rounds = [], seen["rounds"]
    real_msm = msm_mod.FixedBaseMSM.compute

    def keep_msm(self, rows):
        msms.append((self, rows))
        return real_msm(self, rows)

    msm_mod.FixedBaseMSM.compute = keep_msm
    try:
        ipa.ipa_prove(b, x, gen_msm, Q, t, seen["tape"].clone())
    finally:
        msm_mod.FixedBaseMSM.compute = real_msm
    # the two openings in turns (new, folds, folds, new, ...), a call each
    calls = {"new": lambda: ipa.ipa_prove(b, x, gen_msm, Q, t,
                                          seen["tape"].clone()),
             "folds": lambda: ipa.ipa_prove_by_folds(b, x, G, Q, t,
                                                     seen["tape"].clone())}
    turns = {"new": [], "folds": []}
    for i in range(OPENING_PAIRS):
        for k in (("new", "folds") if i % 2 == 0 else ("folds", "new")):
            turns[k].append(wall_ms(torch, calls[k]))
    times = {
        "new": statistics.median(turns["new"]),
        "folds": statistics.median(turns["folds"]),
        "q_table": time_ms(torch, lambda: gen_msm.extend(Q[None]), 5),
        "msms": sum(time_ms(torch, lambda: real_msm(m, rows), 5)
                    for m, rows in msms),
        "rounds": sum(time_ms(torch, lambda: ipa.ipa_round(*args), 5)
                      for args in rounds),
        "plain_rounds": sum(time_ms(
            torch, lambda: ipa.ipa_round_plain(*args), 5)
            for args in rounds)}
    times["rest"] = times["new"] - times["q_table"] - times["msms"] \
        - times["rounds"]
    say(f"{run}: the opening at L = {b.shape[0]} (a call, the device "
        f"finished): on the setup's table {times['new']:.4f} ms = Q's table "
        f"and the join {times['q_table']:.4f} ms + {len(msms)} MSMs on [G; Q] "
        f"{times['msms']:.4f} ms + {len(rounds)} ipa_round "
        f"{times['rounds']:.4f} ms (their plain version "
        f"{times['plain_rounds']:.4f} ms) + the rest (the tape and its "
        f"draws, b0's fetch) {times['rest']:.4f} ms; by folds "
        f"{times['folds']:.4f} ms (medians of {OPENING_PAIRS} calls each in "
        f"turns; on the table {[round(v, 4) for v in turns['new']]}, by "
        f"folds {[round(v, 4) for v in turns['folds']]}) ({smi})")
    return fold_run, err


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device: this script runs only on a "
                 "GPU machine")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "zkcnn_tpu_torch")):
        sys.exit("chip_smoke: zkcnn_tpu_torch not found beside this "
                 "script: run it from a checkout of the repository")
    sys.path.insert(0, root)

    # 1. start; lap(name) keeps the seconds since the last lap, so that
    # the script's command time can be read phase by phase
    laps, last = [], [time.time()]

    def lap(name):
        now = time.time()
        laps.append(f"{name} {now - last[0]:.1f}")
        last[0] = now

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    # 2. build
    from zkcnn_tpu_torch import cuda_build
    t0 = time.time()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        libs = cuda_build.build(verbose=True)
    regs = ptxas_summary(report.getvalue())
    say(f"build: {sorted(p.name for p in libs.values())} in "
        f"{time.time() - t0:.1f}s; registers and spills (ptxas): "
        + "; ".join(regs))
    lap("build")
    from zkcnn_tpu_torch.field import FP, FR, round_kernels as rk
    from zkcnn_tpu_torch.gkr import engine, FiatShamirTape
    from zkcnn_tpu_torch.pcs import HyraxPCS, curve, hyrax, ipa
    from zkcnn_tpu_torch.pcs import msm as msm_mod
    rk._lib()
    curve.g1_lib()

    # 3. kernels against their plain versions at edge sizes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = random.Random(17)
    edge = edge_shapes()
    worst = {k: 0 for k in edge}
    for name, shapes in edge.items():
        for shape in shapes:
            for fill in (rand_fe, pm1_fe):
                err, _, _ = compare(torch, rk, name, shape, gen, rng, fill)
                worst[name] = max(worst[name], err)
        say(f"edge sizes exact (tolerance 0; random rows and rows of "
            f"p - 1): {name} at {shapes}")

    # the device tape, then the phase calls against their plain versions
    tape_us = tape_checks(torch, rk, FR, gen, rng, smi)
    for name, shapes in phase_edges().items():
        for shape in shapes:
            for fill in (rand_fe, pm1_fe):
                phase_compare(torch, rk, name, shape, gen, rng, fill)
        say(f"phase calls exact (tolerance 0; random rows and rows of "
            f"p - 1): {name} at {shapes}")

    lap("round kernels at edge sizes")

    # the Fp product and the curve kernels against Python integers and
    # their plain versions
    fp_ns = fp_checks(torch, curve, FP, rng, smi)
    lap("Fp product")
    g1_checks(torch, curve, msm_mod, FR, gen, rng)
    sweep = table_sweep(torch, curve, gen, smi)
    ipa_err = 0
    for shape in IPA_EDGE:
        for fold in (False, True):
            for fill in (rand_fe, pm1_fe):
                ipa_err = max(ipa_err, ipa_round_compare(
                    torch, ipa, shape, fold, gen, rng, fill)[0])
    say(f"ipa_round exact (tolerance 0; random rows and rows of p - 1, "
        f"with and without a fold) at (L, n) = {IPA_EDGE}")
    lap("curve kernels' checks")

    from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
    from zkcnn_tpu_torch.nn import models as zoo
    from zkcnn_tpu_torch.nn import params as P
    from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape

    # 4. tiny models on the card, with a real commitment and opening
    for name, build in tiny_models(zoo, NeuralNetwork, P):
        for mode in ("sqrt", "ipa") if name == "sconv_muladd" else ("sqrt",):
            nn = build()
            C, vals = nn.create(random_source(24))   # default: the card
            p = Prover(C, vals, own_vals=True)
            pcs = HyraxPCS(mode=mode)
            v = Verifier(p, C, Tape(b"dryrun-" + name.encode()), pcs=pcs)
            if not v.verify():
                raise AssertionError(f"{name} ({mode}): verification failed "
                                     f"on cuda")
            pin = PINNED_1CHIP[name]
            if (v.transcript_digest, p.proof_size) != (pin["digest"],
                                                       pin["proof_size"]):
                raise AssertionError(
                    f"{name} ({mode}): digest {v.transcript_digest} / proof "
                    f"size {p.proof_size} differ from the pin {pin}")
            if pcs.open_and_verify(v.commitment, p.val[0], v.r_u[0],
                                   v.eval_in + 1, v.tape):
                raise AssertionError(f"{name} ({mode}): a wrong evaluation "
                                     f"of the input was accepted")
            say(f"tiny model {name}, {mode} commitment of {pcs.n_rows} x "
                f"{pcs.n_cols}: verified, digest and proof size "
                f"{p.proof_size} equal PINNED_1CHIP, commitment and opening "
                f"{pcs.ps} bytes, a wrong evaluation rejected")

    lap("tiny models")

    # the tiny models under Fiat-Shamir, with the commitment: the CPU's
    # fingerprints, a tampered witness rejected; then the per-round path
    # on a plain tape that is not precomputable against the three-pass one
    for name, build in tiny_models(zoo, NeuralNetwork, P):
        for mode in ("sqrt", "ipa") if name == "sconv_muladd" else ("sqrt",):
            C, vals = build().create(random_source(24))
            seed = b"dryrun-" + name.encode()
            tape, pcs = FiatShamirTape(seed), HyraxPCS(mode=mode)
            p = Prover(C, vals)
            if not Verifier(p, C, tape, pcs=pcs).verify():
                raise AssertionError(f"{name} ({mode}) under FiatShamirTape: "
                                     f"verification failed on cuda")
            got = (tape.state.hex(), tape.counter)
            if got != PINNED_FS_TINY[(name, mode)] or \
                    p.proof_size != PINNED_1CHIP[name]["proof_size"]:
                raise AssertionError(f"{name} ({mode}) under FiatShamirTape: "
                                     f"state/counter {got}, proof size "
                                     f"{p.proof_size} differ from the pins")
            bad = list(vals)
            bad[-1] = bad[-1].clone()
            bad[-1][0] = FR.add(bad[-1][0], FR.const(1, "cuda"))
            if Verifier(Prover(C, bad), C, FiatShamirTape(seed),
                        pcs=HyraxPCS(mode=mode)).verify():
                raise AssertionError(f"{name} ({mode}) under FiatShamirTape: "
                                     f"a tampered witness was accepted")
            say(f"tiny model {name} under FiatShamirTape, {mode} commitment: "
                f"verified, state and counter {got[1]} equal the CPU pin, a "
                f"tampered witness rejected")
        out = []
        for precomputable in (True, False):
            C, vals = build().create(random_source(24))
            tape = recording_tape(Tape)(b"dryrun-" + name.encode())
            tape.precomputable = precomputable
            bl = C.layers[0].bit_length
            tape.fields(1 << (bl - (bl >> 1)))     # the PCS setup's draws
            p = Prover(C, vals)
            v = Verifier(p, C, tape)
            if not v.verify():
                raise AssertionError(f"{name}: verification failed on cuda "
                                     f"(precomputable={precomputable})")
            out.append((tape.absorbed, tape.counter, p.proof_size, v.eval_in))
        if out[0] != out[1]:
            raise AssertionError(f"{name}: the per-round path and the "
                                 f"three-pass path absorb different values")
        say(f"tiny model {name}: the per-round path on a plain tape absorbs "
            f"the three-pass path's {len(out[0][0])} values, proof size and "
            f"input claim")

    lap("tiny models under Fiat-Shamir")

    # the engines' phase call (run_fs), which draws the challenges, then
    # the per-round engines at those challenges, whose counts cover exactly
    # their two phases, then run_all
    rk.reset_launches()
    fs_polys, fs_claims, rss = per_round_phases(torch, engine,
                                                FiatShamirTape, "fs")
    torch.cuda.synchronize()
    phases_ran = dict(rk.LAUNCHES)
    rk.reset_launches()
    round_polys, round_claims, _ = per_round_phases(
        torch, engine, FiatShamirTape, "round", rss)
    torch.cuda.synchronize()
    engines_ran = dict(rk.LAUNCHES)
    engine_shapes = {k: sorted(rk.SHAPES[k]) for k in PER_ROUND}
    say(f"engines' phase calls, wrapper calls that launched: {phases_ran}; "
        f"per-round engines: {engines_ran}")
    for name in PER_ROUND:
        if engines_ran[name] <= 0:
            raise AssertionError(f"the per-round engines never launched "
                                 f"{name}")
    if any(engines_ran[k] for k in LADDERS) or phases_ran["fold"] or \
            any(phases_ran[k] != 1 for k in PHASES):
        raise AssertionError(f"the engines ran other kernels: {phases_ran}, "
                             f"{engines_ran}")
    all_polys, all_claims, _ = per_round_phases(torch, engine,
                                                FiatShamirTape, "run_all",
                                                rss)
    if not (fs_polys == round_polys == all_polys) or not (
            torch.equal(fs_claims, all_claims)
            and torch.equal(round_claims, all_claims)):
        raise AssertionError("the phase calls, the per-round engines and "
                             "run_all give different round messages or "
                             "claims")
    say(f"engines: {len(round_polys[0])} quadratic and "
        f"{len(round_polys[1])} cubic round messages and the final claims "
        f"of the phase calls and of the per-round engines equal to "
        f"run_all's")

    lap("per-round engines")

    # 5. LeNet through the demo entry; counts cover exactly this run
    from zkcnn_tpu_torch.cli import demo_lenet
    rk.reset_launches()
    engine.FETCHES["rounds"] = 0
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--no-pcs",
                           "--pic-cnt", "1"])      # no --cpu: the card
    torch.cuda.synchronize()
    lenet = {k: rk.LAUNCHES[k] for k in rk.NAMES}
    launches = {k: lenet[k] for k in LADDERS}
    shapes = {k: sorted(rk.SHAPES[k]) for k in LADDERS}
    device_launches = sum(rk.KERNEL_LAUNCHES.values())
    fetches = engine.FETCHES["rounds"]
    row = res["row"]
    say(f"lenet: Verification pass, WS {row['WS']}, PS {row['PS']} KB, "
        f"PT {row['PT']} s, VT {row['VT']} s, witness "
        f"{res['witness_s']:.2f} s, digest {res['digest']}")
    say(f"lenet row: {res['line']}")
    say(f"lenet wrapper calls that launched: {lenet}")
    say(f"lenet round loops: {device_launches} device launches "
        f"({dict(rk.KERNEL_LAUNCHES)}), {fetches} host fetches, for "
        f"{lenet['round_ladder']} quadratic sides and "
        f"{lenet['cubic_ladder']} cubic phases")
    if row["WS"] != PINNED_LENET["WS"] or row["PS"] != PINNED_LENET["PS"]:
        raise AssertionError(f"lenet WS/PS {row['WS']}/{row['PS']} differ "
                             f"from {PINNED_LENET}")
    if res["digest"] != PINNED_LENET["digest"]:
        raise AssertionError(f"lenet digest {res['digest']} differs from "
                             f"the CPU pin {PINNED_LENET['digest']}")
    for name in LADDERS:
        if lenet[name] <= 0:
            raise AssertionError(f"lenet never launched kernel {name}")
    for name in PER_ROUND:
        if lenet[name]:
            raise AssertionError(f"lenet ran {name} {lenet[name]} times: "
                                 f"its rounds should all run in ladders")
    # a phase fetches once for all its sides
    if fetches > lenet["round_ladder"] + lenet["cubic_ladder"]:
        raise AssertionError(f"{fetches} fetches for "
                             f"{lenet['round_ladder']} sides")

    lap("lenet --no-pcs")

    # LeNet again with the commitment (inner-product opening); the counts
    # of the curve kernels and of the ladders cover exactly this run, and
    # the opening keeps its inputs for the fold-based opening below
    pcs_seen, uncapture = capture_opening(torch, hyrax, ipa, FR)
    opened, real_open = {}, hyrax.HyraxPCS.open

    def keep_open(self, val0, r, eval_in, tape):
        opened.update(pcs=self, val0=val0, r=list(r))
        return real_open(self, val0, r, eval_in, tape)

    hyrax.HyraxPCS.open = keep_open
    curve.BASE_TABLES.clear()          # the base point's table as a fresh
    rk.reset_launches()                # process builds it
    curve.reset_launches()
    try:
        res = demo_lenet.main(["--synthetic", "--seed", "17",
                               "--pic-cnt", "1"])
        torch.cuda.synchronize()
    finally:
        uncapture()
        hyrax.HyraxPCS.open = real_open
    g1_launches = dict(curve.LAUNCHES)
    g1_shapes = {k: sorted(curve.SHAPES[k]) for k in curve.NAMES}
    g1_plain = dict(curve.PLAIN_CALLS)
    row = res["row"]
    say(f"lenet with the commitment: Verification pass, WS {row['WS']}, PS "
        f"{row['PS']} KB, POLY_PS {row['POLY_PS']} KB, PT {row['PT']} s, "
        f"POLY_PT {row['POLY_PT']} s (the row commitments "
        f"{res['poly_commit_s']:.4f} s, the opening "
        f"{res['poly_pt'] - res['poly_commit_s']:.4f} s; the setup's table "
        f"of the generators, outside POLY_PT, {res['poly_table_s']:.4f} s), "
        f"POLY_VT {row['POLY_VT']} s ({smi}), digest {res['digest']}")
    say(f"lenet row: {res['line']}")
    say(f"lenet with the commitment, curve wrapper calls that launched: "
        f"{g1_launches} (device kernels {dict(curve.KERNEL_LAUNCHES)}), "
        f"not through a kernel: {g1_plain}; ladders: "
        f"{ {k: rk.LAUNCHES[k] for k in LADDERS} }")
    if (row["WS"], row["PS"], row["POLY_PS"]) != (
            PINNED_LENET["WS"], PINNED_LENET["PS"],
            PINNED_LENET_PCS["POLY_PS"]):
        raise AssertionError(f"lenet with the commitment: WS/PS/POLY_PS "
                             f"{row['WS']}/{row['PS']}/{row['POLY_PS']}")
    if res["digest"] != PINNED_LENET_PCS["digest"]:
        raise AssertionError(f"lenet digest {res['digest']} differs from "
                             f"the CPU pin {PINNED_LENET_PCS['digest']}")
    # the opening runs on the setup's table: a round is one ipa_round
    # and one g1_msm launch, no fold of G and no table of its own; the
    # tables are the setup's, the base point's (the tape's generators and
    # Q's in open and in verify draw on it), Q's opening table and the
    # verifier's two
    rounds_ipa = len(pcs_seen["b"]).bit_length() - 1
    for name in curve.NAMES:
        if name not in FOLD_KERNELS and g1_launches[name] <= 0:
            raise AssertionError(f"lenet never launched kernel {name}")
    for name in FOLD_KERNELS:
        if g1_launches[name]:
            raise AssertionError(f"lenet launched {name} "
                                 f"{g1_launches[name]} times: the opening "
                                 f"should fold no point")
    if g1_launches["g1_msm_table"] > TABLES_THREE_PASS or \
            g1_launches["ipa_round"] != rounds_ipa:
        raise AssertionError(f"lenet with the commitment: "
                             f"{g1_launches['g1_msm_table']} tables (at most "
                             f"{TABLES_THREE_PASS}), "
                             f"{g1_launches['ipa_round']} ipa_round "
                             f"launches for {rounds_ipa} rounds")
    if any(g1_plain.values()):
        raise AssertionError(f"curve operations went past the kernels: "
                             f"{g1_plain}")
    for name in LADDERS:
        if rk.LAUNCHES[name] <= 0:
            raise AssertionError(f"lenet with the commitment never launched "
                                 f"kernel {name}")
    opening_fr_check(pcs_seen, LENET_PCS_RUN)
    poly_split = poly_pt_split(torch, hyrax, FR, opened, res, pcs_seen, smi)
    del opened

    lap("lenet with the commitment")

    # the same opening by folds, on its own inputs: the proof must not
    # change; its curve launches and shapes are G1's and G2's run
    fold_run, e = opening_checks(torch, ipa, curve, msm_mod, pcs_seen, smi,
                                 LENET_PCS_RUN)
    ipa_err = max(ipa_err, e)
    say(f"{FOLDS_RUN}, curve wrapper calls that launched: {fold_run[0]}")
    for name in FOLD_KERNELS:
        if fold_run[0][name] <= 0:
            raise AssertionError(f"{FOLDS_RUN} never launched kernel {name}")

    lap("the opening against the fold-based opening")

    # LeNet under Fiat-Shamir with the commitment (inner-product opening),
    # built as cli/runner.py builds it; the counts cover exactly the proof
    def fs_lenet():
        C, vals = zoo.lenet(32, 32, 1, 1, P.PoolType.MAX).create(
            random_source(17))
        p = Prover(C, vals, own_vals=True)
        pcs, tape = HyraxPCS(mode="ipa"), FiatShamirTape(b"zkcnn-demo-17")
        return C, p, pcs, tape, Verifier(p, C, tape, pcs=pcs)

    C, p, pcs, tape, v = fs_lenet()
    rounds = C.layers[0].bit_length + sum(
        ly.max_bl_u + (ly.max_bl_v if ly.need_phase2 else 0)
        for ly in C.layers[1:])
    # the round loops' seconds: every phase call, which ends in its fetch
    round_s = [0.0]

    def timed_round(fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            round_s[0] += time.perf_counter() - t
            return out
        return run

    for m in ("phase_quadratic", "phase_cubic", "liu_phase"):
        setattr(p, m, timed_round(getattr(p, m)))
    # verify() span by span: the commitment's setup (hash-to-curve of the
    # generators, then their table), its commit, the encode-and-absorb of
    # the commitment (from the commit's return to the per-round path's
    # start), the per-round proof and check, the opening
    marks = {}

    def spanned(obj, name):
        fn = getattr(obj, name)

        def run(*args):
            torch.cuda.synchronize()
            marks[name] = [time.perf_counter()]
            out = fn(*args)
            torch.cuda.synchronize()
            marks[name].append(time.perf_counter())
            return out
        setattr(obj, name, run)

    for obj, name in ((pcs, "setup"), (pcs, "commit"),
                      (v, "_verify_per_round"), (v, "verify_input")):
        spanned(obj, name)
    fs_seen, uncapture = capture_opening(torch, hyrax, ipa, FR)
    torch.cuda.synchronize()
    rk.reset_launches()
    curve.reset_launches()
    engine.FETCHES["rounds"] = 0
    t0 = time.perf_counter()
    ok = v.verify()
    torch.cuda.synchronize()
    fs_wall = time.perf_counter() - t0
    uncapture()
    span = {k: b - a for k, (a, b) in marks.items()}
    span["absorb"] = marks["_verify_per_round"][0] - marks["commit"][1]
    fs = {k: rk.LAUNCHES[k] for k in rk.NAMES}
    fs_device = dict(rk.KERNEL_LAUNCHES)
    fs_tables = curve.LAUNCHES["g1_msm_table"]
    fs_fetches = engine.FETCHES["rounds"]
    fs_phases = fs["fold_round"] + fs["fold_cubic_round"]
    phase_shapes = {k: sorted(rk.PHASE_SHAPES[k]) for k in PHASES}
    launches.update({k: fs[k] for k in PER_ROUND})
    shapes.update(engine_shapes)
    ws = f"{C.layers[0].size}(2^{(C.layers[0].size - 1).bit_length()})"
    ps, poly_ps = f"{p.proof_size / 1024:.4f}", f"{pcs.ps / 1024:.4f}"
    fingerprint = (tape.state.hex(), tape.counter)
    say(f"lenet under FiatShamirTape: {'Verification pass' if ok else 'FAILED'}"
        f", WS {ws}, PS {ps} KB, POLY_PS {poly_ps} KB, PT "
        f"{p.prove_time:.4f} s, VT {v.vt:.4f} s, POLY_PT {pcs.pt:.4f} s, "
        f"POLY_VT {pcs.vt:.4f} s (setup's table {pcs.table_s:.4f} s; "
        f"verify() {fs_wall:.4f} s in all) ({smi}); state "
        f"{fingerprint[0][:16]}..., counter {fingerprint[1]}")
    say(f"lenet under FiatShamirTape, verify() by span: setup "
        f"{span['setup']:.4f} s (hash-to-curve of the generators "
        f"{span['setup'] - pcs.table_s:.4f} s, their table "
        f"{pcs.table_s:.4f} s), commit {span['commit']:.4f} s, "
        f"encode-and-absorb of the commitment {span['absorb']:.4f} s, "
        f"per-round proof and check {span['_verify_per_round']:.4f} s, "
        f"opening {span['verify_input']:.4f} s, the rest "
        f"{fs_wall - sum(span.values()):.4f} s ({smi})")
    say(f"lenet under FiatShamirTape, wrapper calls that launched: {fs} "
        f"(device kernels {fs_device}); {fs_fetches} round fetches for "
        f"{fs_phases} phases of {rounds} rounds; round loops (the phase "
        f"calls) {round_s[0]:.4f} s ({smi}); curve wrapper calls "
        f"{dict(curve.LAUNCHES)}")
    if not ok:
        raise AssertionError("lenet under FiatShamirTape: verification "
                             "failed on cuda")
    if (ws, ps, poly_ps) != (PINNED_LENET["WS"], PINNED_LENET["PS"],
                             PINNED_LENET_PCS["POLY_PS"]):
        raise AssertionError(f"lenet under FiatShamirTape: WS/PS/POLY_PS "
                             f"{ws}/{ps}/{poly_ps}")
    if fingerprint != PINNED_FS_LENET:
        raise AssertionError(f"lenet under FiatShamirTape: state/counter "
                             f"{fingerprint} differ from the CPU pin")
    for name in ("fold_round", "fold_cubic_round"):
        if fs[name] <= 0:
            raise AssertionError(f"lenet under FiatShamirTape never launched "
                                 f"kernel {name}")
    # the rounds run no ladder and no fold; the output layer's MLE
    # evaluation (v_res, at a point drawn whole before anything is
    # absorbed) is one fold ladder
    if fs["round_ladder"] or fs["cubic_ladder"] or fs["fold_ladder"] != 1 \
            or fs["fold"]:
        raise AssertionError(f"lenet under FiatShamirTape ran ladders or "
                             f"folds: {fs}")
    if fs_fetches > fs_phases:
        raise AssertionError(f"lenet under FiatShamirTape: {fs_fetches} "
                             f"round fetches for {fs_phases} phases")
    if fs_tables > TABLES_FIAT_SHAMIR:
        raise AssertionError(f"lenet under FiatShamirTape: {fs_tables} "
                             f"tables (at most {TABLES_FIAT_SHAMIR})")

    # its opening against the fold-based one too: under FiatShamirTape a
    # round's absorb of L_k and R_k waits for the device
    opening_fr_check(fs_seen, LENET_FS_RUN)
    ipa_err = max(ipa_err, opening_checks(torch, ipa, curve, msm_mod,
                                          fs_seen, smi, LENET_FS_RUN)[1])
    del p, v

    # the same proof with its rounds in the one-round form (round(prev_r),
    # a fetch a round, the challenges on the host tape), in this process:
    # its round loops' seconds beside the phase calls'
    C, p, pcs, tape, v = fs_lenet()
    one_s = [0.0]

    def one_round_form(step):
        def run(n, state, counter):
            t0 = time.perf_counter()
            host = FiatShamirTape()
            host.state, host.counter = state, counter
            polys, rs = [], []
            for _ in range(n):
                polys.append(step(rs[-1] if rs else None))
                host.absorb(*polys[-1])
                rs.append(host.field())
            p.phase.receive(rs[-1])
            one_s[0] += time.perf_counter() - t0
            return polys, rs, host.state, host.counter
        return run

    for m, step in (("phase_quadratic", p.round_quadratic),
                    ("phase_cubic", p.round_cubic),
                    ("liu_phase", p.liu_round)):
        setattr(p, m, one_round_form(step))
    rk.reset_launches()
    engine.FETCHES["rounds"] = 0
    if not v.verify() or (tape.state.hex(), tape.counter) != PINNED_FS_LENET:
        raise AssertionError("lenet under FiatShamirTape in the one-round "
                             "form: not verified or another fingerprint")
    one = dict(rk.LAUNCHES)
    say(f"lenet under FiatShamirTape, the rounds in the one-round form: "
        f"verified, the same fingerprint; round loops {one_s[0]:.4f} s "
        f"(the phase calls {round_s[0]:.4f} s) ({smi}); "
        f"{engine.FETCHES['rounds']} round fetches; wrapper calls {one} "
        f"(device kernels {dict(rk.KERNEL_LAUNCHES)})")
    if engine.FETCHES["rounds"] != rounds or one["fold_round"] <= 0:
        raise AssertionError(f"the one-round form: {engine.FETCHES['rounds']}"
                             f" fetches for {rounds} rounds, {one}")
    del p, v

    lap("lenet under Fiat-Shamir")

    # 6. every entry against its plain version at the shapes of its run,
    # timed; the reported time is at the largest of them.  The per-round
    # entries' one-round form: the per-round engines' shapes; fold_round's
    # and fold_cubic_round's phase calls: LeNet under Fiat-Shamir's
    kernels = []
    for name in rk.NAMES:
        seen = shapes[name]
        run = ENGINES_RUN if name in PER_ROUND else LENET_RUN
        say(f"shapes of {name} in its run ({run}): {seen}")
        err, times = worst[name], []
        for shape in seen:
            e, kern, _ = compare(torch, rk, name, shape, gen, rng)
            err = max(err, e)
            times.append((shape, time_ms(torch, kern, 20)))
        for shape, ms in times:
            say(f"time {name} {shape}: kernel {ms:.4f} ms ({smi})")
        shape = max(seen)
        e, kern, plain = compare(torch, rk, name, shape, gen, rng)
        ms, pms = time_ms(torch, kern, 20), time_ms(torch, plain, 3)
        b_ms, b_by = bound(name, shape)
        say(f"reported time of {name}: the largest shape of its run "
            f"({run}) {shape}: "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.6f} ms "
            f"by {b_by} ({smi})")
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": max(err, e), "ms": ms, "plain_ms": pms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "shape": list(shape), "run": run}
        if name == "fold":
            entry["launches"] = engines_ran[name]
            entry["launches_on_the_main_path"] = launches[name]
        if name in PHASES:
            # the phase calls of the main path, each word for word against
            # its plain version, timed a phase (the launch sequence, no
            # fetch); reported at the phase of the most rows
            one_round = {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "shape", "run")}
            one_round["launches"] = engines_ran[name]
            perr, ptimes = err, []
            for shape in phase_shapes[name]:
                e, kern, _ = phase_compare(torch, rk, name, shape, gen, rng)
                perr = max(perr, e)
                ptimes.append((shape, time_ms(torch, kern, 5)))
            for shape, ms in ptimes:
                say(f"time {name} phase {shape}: {ms:.4f} ms ({smi})")
            big = max(phase_shapes[name], key=lambda sh: (
                sum(1 << nb for nb in sh[:2] if nb >= 0), sh)
                if name == "fold_round" else sh)
            e, kern, plain = phase_compare(torch, rk, name, big, gen, rng)
            ms, pms = time_ms(torch, kern, 10), time_ms(torch, plain, 1)
            b_ms, b_by = phase_bound(name, big)
            say(f"reported time of {name}: its largest phase in "
                f"{LENET_FS_RUN} {big}: kernels {ms:.4f} ms a phase "
                f"({fs_device[name]} device launches in {launches[name]} "
                f"phases), plain {pms:.4f} ms, bound {b_ms:.6f} ms by "
                f"{b_by} ({smi})")
            entry.update(launches=launches[name],
                         device_launches=fs_device[name],
                         max_abs_err=max(perr, e), ms=ms, plain_ms=pms,
                         bound_ms=b_ms, bound_by=b_by, shape=list(big),
                         run=LENET_FS_RUN, one_round_form=one_round)
        kernels.append(entry)
    say("kernels exact (tolerance 0) at every shape of their runs")

    lap("round kernels at their runs' shapes")

    # the curve kernels at every shape of their run (the LeNet run with
    # the commitment; G1 and G2: the fold-based opening of its opening),
    # as group elements: against the plain version on 32-bit scalars (it
    # takes seconds a shape), and at the largest shape on full-size
    # scalars too (one call of the plain version: about a minute);
    # ipa_round word for word
    for name in curve.NAMES:
        run, seen_shapes, launched = LENET_PCS_RUN, g1_shapes, g1_launches
        if name in FOLD_KERNELS:
            run, seen_shapes, launched = FOLDS_RUN, fold_run[1], fold_run[0]
        say(f"shapes of {name} in its run ({run}): {seen_shapes[name]}")
        shape = max(seen_shapes[name])
        if name == "ipa_round":
            # the rounds of the run's own opening, each timed on its own
            # operands; reported at round 0, the largest (L, L)
            per = []
            for args in pcs_seen["rounds"]:
                _, kern, _ = ipa_round_check(torch, ipa, args, run)
                per.append((ipa_round_shape(args), time_ms(torch, kern, 20)))
            for (sh, fold), ms in per:
                say(f"time {name} {sh}, fold {fold}: kernel {ms:.4f} ms "
                    f"({smi})")
            _, kern, plain = ipa_round_check(torch, ipa,
                                             pcs_seen["rounds"][0], run)
            ms, pms = time_ms(torch, kern, 20), time_ms(torch, plain, 5)
            b_ms, b_by = ipa_round_bound(shape, False)
            kernels.append({"name": name, "route": "cuda",
                            "source": G1_SOURCE,
                            "replaces": G1_REPLACES[name],
                            "launches": launched[name],
                            "max_abs_err": ipa_err, "ms": ms,
                            "plain_ms": pms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None,
                            "shape": list(shape), "run": run,
                            "ms_all_rounds": sum(t for _, t in per)})
            say(f"reported time of {name}: the largest shape of its run "
                f"({run}) {shape}, round 0 (no fold): kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms, bound {b_ms:.6f} ms by {b_by}; its "
                f"{len(per)} rounds {sum(t for _, t in per):.4f} ms "
                f"({smi})")
            continue
        if name == "g1_msm_table":
            table_shapes(torch, curve, msm_mod,
                         sorted(seen_shapes[name]) + TABLE_EDGES, gen)
        for sh in seen_shapes[name]:
            if name != "g1_msm_table":
                _, kern, plain = g1_inputs(torch, curve, msm_mod, FR, name,
                                           sh, gen, 32)
                same_points(msm_mod, kern(), plain(),
                            f"{name} at {sh}, 32-bit scalars")
            _, kern, _ = g1_inputs(torch, curve, msm_mod, FR, name, sh, gen)
            with_table = ""
            if name == "g1_msm":
                with_table = (f", with building its table "
                              f"{time_ms(torch, kern.with_table, 3):.4f} ms")
            say(f"time {name} {sh}: kernel "
                f"{time_ms(torch, kern, 3):.4f} ms{with_table} ({smi})")
        scalars, kern, plain = g1_inputs(torch, curve, msm_mod, FR,
                                         name, shape, gen)
        pms, want = time_once_ms(torch, plain)
        err = same_points(msm_mod, kern(), want, f"{name} at {shape}")
        ms = time_ms(torch, kern, 5)
        if name == "g1_msm_table":
            b_ms, b_by = table_bound(shape)
        else:
            b_ms, b_by = g1_bound(torch, curve, name, shape, scalars)
        entry = {"name": name, "route": "cuda", "source": G1_SOURCE,
                 "replaces": G1_REPLACES[name],
                 "launches": launched[name], "max_abs_err": err,
                 "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "shape": list(shape), "run": run}
        if name in FOLD_KERNELS:
            entry["launches_on_the_main_path"] = g1_launches[name]
        if name == "g1_msm_table" and shape in sweep:
            entry.update(chain_ms=sweep[shape]["chain"],
                         digits_ms=sweep[shape]["digits"],
                         lanes_a_base=table_lanes(curve)[1])
        with_table = ""
        if name == "g1_msm":
            entry["ms_with_table"] = time_ms(torch, kern.with_table, 5)
            with_table = (f" (with building its table "
                          f"{entry['ms_with_table']:.4f} ms)")
        say(f"reported time of {name}: the largest shape of its run "
            f"({run}) {shape}: kernel {ms:.4f} ms{with_table}, "
            f"plain {pms:.4f} ms (one call), bound {b_ms:.6f} ms by {b_by} "
            f"({smi})")
        kernels.append(entry)
    say("curve kernels equal to their plain versions as group elements "
        "(tolerance 0 after normalising Z; ipa_round word for word) at "
        "every shape of their run")

    lap("curve kernels at their run's shapes")

    # what a ladder saves at LeNet's largest side: its rounds one by one
    # as the per-round path runs them (fold_round, each round's dots
    # fetched before the next), against one ladder and one fetch
    rows, R = max(shapes["round_ladder"])
    A, V = rand_fe(torch, rows, gen), rand_fe(torch, rows, gen)
    rs = [rng.getrandbits(254) for _ in range(R)]

    def per_round():
        a, v, prev = A, V, None
        for r in rs:
            d, a, v = rk.fold_round(a, v, prev)
            d.cpu()
            prev = r

    state = FiatShamirTape(b"side").state
    per_ms = time_ms(torch, per_round, 10)
    lad_ms = time_ms(torch, lambda: rk.round_ladder(A, V, rs)[0].cpu(), 10)
    fs_ms = time_ms(torch, lambda: rk.fold_round_phase(
        [None, (A, V)], R, 0, True, state, 0)[0].cpu(), 10)
    say(f"{R} rounds from {rows} rows, dots fetched: per round "
        f"{per_ms:.4f} ms, one ladder {lad_ms:.4f} ms, one phase call "
        f"drawing its own challenges {fs_ms:.4f} ms ({smi})")

    lap("per round against a ladder")
    say(f"seconds by phase: {'; '.join(laps)} ({smi})")

    # 7. results: the lane forms' measurements of phase 3 and the
    # registers of their kernels again, where the end of the output keeps
    # them, then the kernels
    say(json.dumps({"round_loops_s": {"phase_calls": round_s[0],
                                      "one_round_form": one_s[0]},
                    "device_tape_us": tape_us,
                    "fs_fetches": fs_fetches, "fs_phases": fs_phases,
                    "fs_device_launches": fs_device,
                    "one_side_ms": {"per_round": per_ms, "ladder": lad_ms,
                                    "phase_call": fs_ms},
                    "poly_pt_split": poly_split,
                    "device": smi}))
    say(json.dumps({"fp_product_ns": {str(k): v for k, v in fp_ns.items()},
                    "table_ms": {str(shape): t for shape, t in sweep.items()},
                    "ptxas": [r for r in regs
                              if r.startswith(("g1_table", "fp_mul"))],
                    "device": smi}))
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
