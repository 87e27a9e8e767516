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
     to one row and with one row.  Then the curve kernels' Fp product (the
     check entry zk_fp_mul) against Python integers on 0, 1, p - 1,
     R mod p, words of 0xffffffff below p and 10^5 random pairs, and one
     thread's chain of dependent products, whose latency it prints; the
     curve kernels (g1_add, g1_scalar_mul, g1_msm_table, g1_msm) against
     their plain versions on the card, as group elements, and against
     Python integers on the host: the four edge cases of the addition,
     n = 1, 2, 3, 1554 and 2^18; scalars 0, 1, p - 1 and one with bit
     254 set at 255 bits against py_mul, random ones at 16 and 32 bits
     against the plain version, a shared point (the table route) and a
     shared scalar; (R, N) = (1, 1), (3, 5), (2, 512) and (3, 130) (a
     row of several blocks, the last one partly filled) with a repeated
     base for the MSM on its table (py_mul at full-size scalars, the
     plain version at 32-bit ones); the inner-product opening's round
     scalars (ipa_scalars) against their plain version, word for word, at
     (L, n) from (2, 2) to (1024, 64), random and p - 1;
  4. the three tiny models proven and verified on the card with a real
     sqrt commitment and opening (HyraxPCS): transcript digest and proof
     size equal to their 1-device pins, a wrong evaluation rejected; one
     of them again with the inner-product opening; the same under
     FiatShamirTape (sqrt; sconv_muladd with the inner-product opening
     too): verified, final tape state and counter equal to the CPU pins,
     a tampered witness rejected; the per-round path on a plain tape
     that is not precomputable absorbing what the three-pass path
     absorbs; then the per-round engines (PhaseEngine.round,
     DotProdPhase1.round, then receive) driven on card tensors at the
     shapes of LeNet's largest phases, with the launch counts reset
     before and read after: fold_round, fold_cubic_round and fold
     launched, no ladder, every round message and final claim equal to
     run_all's;
  5. LeNet5, pic_cnt=1, through the port's demo_lenet entry (--synthetic
     --seed 17) on the card, twice, each with the kernel launch counts
     reset just before and read just after.  With --no-pcs: it must
     verify, with WS 201734(2^18), PS 45.7188 KB, the pinned digest,
     every ladder launched, and at most one fetch per side per phase.
     With the commitment (inner-product opening): the same WS and PS,
     POLY_PS 24.8750 KB, its own pinned digest, every ladder launched,
     g1_msm_table, g1_msm and ipa_scalars launched (at most 7 tables, one
     ipa_scalars a round), no g1_scalar_mul and no g1_add (the opening
     folds no point), and no curve operation through a plain or host
     version.  Its opening's own b, x, Q and tape then go through
     ipa_prove_by_folds (whose curve launches and shapes are G1's and
     G2's run): every L_k, R_k, b0 and the tape after must equal the
     opening's, and both openings are timed, the new one split into Q's
     table, the MSMs, the ipa_scalars launches (and their plain version)
     and the rest.  Then LeNet5 built as cli/runner.py builds it, under
     FiatShamirTape(b"zkcnn-demo-17") with the inner-product commitment,
     counts reset just before the proof: the same WS, PS and POLY_PS, the
     CPU-pinned final tape state and counter, fold_round and
     fold_cubic_round launched, no round or cubic ladder (one fold ladder:
     the output layer's MLE at its point), one fetch a round; PT, VT,
     POLY_PT and POLY_VT printed, and verify()'s wall time span by span
     (the commitment's setup, its hash-to-curve apart from its table,
     the commit, the encode-and-absorb of the commitment, the per-round
     proof and check, the opening);
  6. each entry against its plain version at every shape its run
     launched it at (the round kernels exact; the curve kernels as group
     elements, on 32-bit scalars laid out as the run lays them out, and
     at the largest shape on full-size scalars too; the tables entry by
     entry), timed with CUDA events (g1_msm with and without building its
     table), with the least time the card could take for the same work
     beside it;
     Then a LeNet side's rounds one by one as the per-round path runs
     them (fold_round, a fetch a round) against one ladder;
  7. the seconds each phase took, one JSON line of kernel results
     (each entry's launches, shape and times belong to the run its `run`
     key names: the ladders' to LeNet --no-pcs, the per-round path's
     entries to LeNet under FiatShamirTape, the curve kernels' to LeNet
     with the commitment, but g1_add's and g1_scalar_mul's to the
     fold-based opening, with their launches on the main path, 0, beside
     them), the nvidia-smi name/power line, and the final JSON status
     line.
"""

import json
import os
import random
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
               # the fold of G, whose work the weights take over
               "ipa_scalars": "zkcnn_tpu/pcs/ipa.py:60"}
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
# curve kernels that the LeNet opening no longer runs: their shapes and
# launches come from FOLDS_RUN
FOLD_KERNELS = ("g1_add", "g1_scalar_mul")
# calls of each opening, in turns, when the two are timed
OPENING_PAIRS = 8


def say(msg):
    print(msg, flush=True)


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


def per_round_phases(torch, engine, how):
    """A quadratic phase (sides of 2^18 and 2^12 rows, a nonzero add_term,
    one round past the longer side) and a DOT_PROD phase 1 ((K, M) =
    (2^16, 2^9)) on card tensors made from a fixed seed, run by `run_all`
    or per round (`round(prev_r)`, then `receive` at the last challenge);
    returns both lists of round messages and the final claims."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    rng = random.Random(24)
    sides = [engine.Side(rand_fe(torch, 1 << nb, gen),
                         rand_fe(torch, 1 << nb, gen), nb) for nb in (18, 12)]
    quad = engine.PhaseEngine(sides, add_term=rng.getrandbits(254))
    cubic = engine.DotProdPhase1(rand_fe(torch, 1 << 9, gen),
                                 rand_fe(torch, 1 << 16, gen),
                                 rand_fe(torch, 1 << 16, gen), 9, 16)
    out = []
    for phase, R in ((quad, 19), (cubic, 16)):
        rs = [rng.getrandbits(254) for _ in range(R)]
        if how == "round":
            out.append([phase.round(rs[j - 1] if j else None)
                        for j in range(R)])
            phase.receive(rs[-1])
        else:
            out.append(phase.run_all(rs))
    claims = [quad.final_claim_dev(0, 18), quad.final_claim_dev(1, 12),
              *cubic.finalize_dev()]
    return out, torch.stack(claims)


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


def table_bound(shape):
    """(bound_ms, bound_by) of g1_msm_table at (N, nwin), counted as
    g1_bound counts: the chain 2^t P, t < 4 nwin, is 4 nwin - 1 doublings
    of 7 products a base and holds the digits 1, 2, 4 and 8 of every
    window; the other 11 digits are one addition of 11 products (a Z = 1
    entry) each.  Or the bytes of the bases in and the table out."""
    N, nwin = shape
    products = N * (DOUBLE_PRODUCTS * (4 * nwin - 1)
                    + MIXED_ADD_PRODUCTS * 11 * nwin)
    nbytes = N * POINT_BYTES * (1 + 15 * nwin)
    by_bytes = nbytes / MEM_BYTES_S * 1e3
    by_ops = products * FP_MULS / INT32_MULS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def fp_checks(torch, curve, FP, rng, smi):
    """The curve kernels' Fp product (zk_fp_mul) against Python integers
    on edge values (all pairs) and 10^5 random pairs, and the latency of
    one thread's dependent products, which it prints; raises on a
    mismatch."""
    import numpy as np
    lib = curve.g1_lib()
    rinv = pow(1 << 384, -1, FP_P)
    top = FP_P >> 352
    edge = [0, 1, 2, FP_P - 1, FP_P - 2, (1 << 384) % FP_P,
            (top << 352) - 1, (1 << 352) - 1, (1 << 380) - 1]
    xs = [a for a in edge for _ in edge] + \
        [rng.randrange(FP_P) for _ in range(100000)]
    ys = edge * len(edge) + [rng.randrange(FP_P) for _ in range(100000)]

    def pack(vals):
        return torch.from_numpy(np.stack(
            [FP.words_host(v) for v in vals])).to("cuda")

    def product(a, b, n, chain):
        out = torch.empty_like(a[:n])
        curve.launch(lib.zk_fp_mul, a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), n, chain, curve.stream_of(a.device))
        return out

    A, B = pack(xs), pack(ys)
    got = [FP.int_host(w) for w in product(A, B, len(xs), 0).cpu().numpy()]
    wrong = sum(g != x * y * rinv % FP_P for g, x, y in zip(got, xs, ys))
    if wrong:
        raise AssertionError(f"the device Fp product differs from Python "
                             f"integers at {wrong} of {len(xs)} pairs")
    times = {}
    for chain in (2000, 20000):
        times[chain] = time_ms(
            torch, lambda: product(A[-1:], B[-1:], 1, chain), 3)
    x = FP.int_host(product(A[-1:], B[-1:], 1, 20000).cpu().numpy()[0])
    if x != xs[-1] * pow(ys[-1] * rinv, 20000, FP_P) % FP_P:
        raise AssertionError("a chain of 20000 device Fp products differs "
                             "from Python integers")
    ns = (times[20000] - times[2000]) / 18000 * 1e6
    say(f"device Fp product equals Python integers on {len(edge)}^2 edge "
        f"pairs (0, 1, p - 1, R mod p, words of 0xffffffff below p, ...) "
        f"and 10^5 random pairs, and over a chain of 20000; one thread's "
        f"dependent product {ns:.1f} ns ({smi})")


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


def ipa_scalars_inputs(torch, ipa, shape, gen, rng, fill=rand_fe):
    """Operands of kernel ipa_scalars at (L, n) on the card (b, the
    weights and the Q column from `fill`), as round log2(L / n) of an
    opening lays them out (a previous challenge, p - 1 with pm1_fe,
    unless n = L): (the kernel call, the plain call)."""
    L, n = shape
    b, s, q = fill(torch, n, gen), fill(torch, L, gen), fill(torch, 2, gen)
    prev = None
    if n < L:
        c = FR_P - 1 if fill is pm1_fe else rng.randrange(1, FR_P)
        prev = (c, pow(c, -1, FR_P))
    args = (b, s, prev, q[0], q[1])
    return (lambda: ipa.ipa_scalars(*args)), \
        (lambda: ipa.ipa_scalars_plain(*args))


def ipa_scalars_compare(torch, ipa, shape, gen, rng, fill=rand_fe):
    """ipa_scalars against its plain version at (L, n), word for word;
    raises on a mismatch.  Returns (max_abs_err, kernel_fn, plain_fn)."""
    kern, plain = ipa_scalars_inputs(torch, ipa, shape, gen, rng, fill)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(max_err(torch, g, w) for g, w in zip(got, want))
    if err or any(g.shape != w.shape for g, w in zip(got, want)):
        raise AssertionError(f"ipa_scalars at {shape}: kernel differs from "
                             f"its plain version (max abs err {err})")
    return err, kern, plain


def ipa_scalars_bound(shape):
    """(bound_ms, bound_by) of ipa_scalars at (L, n): b, the weights and
    the Q column read once, the weights and the rows written once,
    against a Montgomery product a term (two past round 0: the weight
    too) of 128 multiplies."""
    L, n = shape
    nbytes = (n + 2 * L + 2 * (L + 1) + 2) * ROW_BYTES
    muls = L * (1 + (n < L)) * FULL_MULS
    by_bytes = nbytes / MEM_BYTES_S * 1e3
    by_ops = muls / INT32_MULS_S * 1e3
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


def capture_opening(hyrax):
    """Wraps hyrax.ipa_prove so that the openings that follow keep their
    inputs: returns the dict the last one fills (b, x, the generators'
    FixedBaseMSM, Q, t and a clone of the tape as the rounds start) and a
    function that undoes the wrap."""
    seen, real = {}, hyrax.ipa_prove

    def run(b, x, gen_msm, Q, t, tape):
        seen.update(b=b.clone(), x=x.clone(), gen_msm=gen_msm, Q=Q.clone(),
                    t=t, tape=tape.clone())
        return real(b, x, gen_msm, Q, t, tape)

    hyrax.ipa_prove = run
    return seen, lambda: setattr(hyrax, "ipa_prove", real)


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
    x, Q and tape:
    ipa_prove_by_folds (its curve launches and shapes counted alone) held
    against ipa_prove, every L_k and R_k as group elements and b0, and
    the tapes after; both timed, a call each in turns, the new one split
    into Q's table, the MSMs on [G; Q], the ipa_scalars launches and the
    rest.  Returns the by-folds run's (launches, shapes)."""
    b, x, gen_msm, Q, t = (seen[k] for k in ("b", "x", "gen_msm", "Q", "t"))
    G = gen_msm.points
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
    # the MSMs and the ipa_scalars launches of one run, each timed again
    # on its own operands (host work included)
    msms, scalars = [], []
    real_msm, real_scalars = msm_mod.FixedBaseMSM.compute, ipa.ipa_scalars

    def keep_msm(self, rows):
        msms.append((self, rows))
        return real_msm(self, rows)

    def keep_scalars(*args):
        scalars.append(args)
        return real_scalars(*args)

    msm_mod.FixedBaseMSM.compute, ipa.ipa_scalars = keep_msm, keep_scalars
    try:
        ipa.ipa_prove(b, x, gen_msm, Q, t, seen["tape"].clone())
    finally:
        msm_mod.FixedBaseMSM.compute = real_msm
        ipa.ipa_scalars = real_scalars
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
        "scalars": sum(time_ms(torch, lambda: real_scalars(*args), 5)
                       for args in scalars),
        "plain_scalars": sum(time_ms(
            torch, lambda: ipa.ipa_scalars_plain(*args), 5)
            for args in scalars)}
    times["rest"] = times["new"] - times["q_table"] - times["msms"] \
        - times["scalars"]
    say(f"{run}: the opening at L = {b.shape[0]} (a call, the device "
        f"finished): on the setup's table {times['new']:.4f} ms = Q's table "
        f"and the join {times['q_table']:.4f} ms + {len(msms)} MSMs on [G; Q] "
        f"{times['msms']:.4f} ms + the scalar prep: {len(scalars)} "
        f"ipa_scalars {times['scalars']:.4f} ms (their plain version "
        f"{times['plain_scalars']:.4f} ms) and the rest (the dots and folds "
        f"of b and x on the plain Fr ops, the tape, b0's fetch) "
        f"{times['rest']:.4f} ms; by folds {times['folds']:.4f} ms (medians "
        f"of {OPENING_PAIRS} calls each in turns; on the table "
        f"{[round(v, 4) for v in turns['new']]}, by folds "
        f"{[round(v, 4) for v in turns['folds']]}) ({smi})")
    return fold_run


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
    libs = cuda_build.build(verbose=True)
    say(f"build: {sorted(p.name for p in libs.values())} in "
        f"{time.time() - t0:.1f}s")
    lap("build")
    from zkcnn_tpu_torch.field import FP, FR, round_kernels as rk
    from zkcnn_tpu_torch.gkr import engine
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

    lap("round kernels at edge sizes")

    # the Fp product and the curve kernels against Python integers and
    # their plain versions
    fp_checks(torch, curve, FP, rng, smi)
    lap("Fp product")
    g1_checks(torch, curve, msm_mod, FR, gen, rng)
    ipa_edge = [(2, 2), (4, 2), (8, 8), (8, 4), (128, 2), (512, 512),
                (512, 256), (512, 2), (1024, 64)]
    for shape in ipa_edge:
        for fill in (rand_fe, pm1_fe):
            ipa_scalars_compare(torch, ipa, shape, gen, rng, fill)
    say(f"ipa_scalars exact (tolerance 0; random rows and rows of p - 1) "
        f"at (L, n) = {ipa_edge}")
    lap("curve kernels' checks")

    from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
    from zkcnn_tpu_torch.nn import models as zoo
    from zkcnn_tpu_torch.nn import params as P
    from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape, FiatShamirTape

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

    # the per-round engines, whose counts cover exactly their two phases
    rk.reset_launches()
    round_polys, round_claims = per_round_phases(torch, engine, "round")
    torch.cuda.synchronize()
    engines_ran = dict(rk.LAUNCHES)
    say(f"per-round engines, wrapper calls that launched: {engines_ran}")
    for name in PER_ROUND:
        if engines_ran[name] <= 0:
            raise AssertionError(f"the per-round engines never launched "
                                 f"{name}")
    if any(engines_ran[k] for k in LADDERS):
        raise AssertionError(f"the per-round engines ran ladders: "
                             f"{engines_ran}")
    all_polys, all_claims = per_round_phases(torch, engine, "run_all")
    if round_polys != all_polys or not torch.equal(round_claims, all_claims):
        raise AssertionError("the per-round engines and run_all give "
                             "different round messages or claims")
    say(f"per-round engines: {len(round_polys[0])} quadratic and "
        f"{len(round_polys[1])} cubic round messages and the final claims "
        f"equal to run_all's")

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
    seen, uncapture = capture_opening(hyrax)
    rk.reset_launches()
    curve.reset_launches()
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--pic-cnt", "1"])
    torch.cuda.synchronize()
    uncapture()
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
    # the opening runs on the setup's table: a round is one ipa_scalars
    # and one g1_msm launch, no fold of G and no table of its own; the
    # tables are the setup's, the tape's generators', Q's in open, Q's
    # opening table, Q's in verify and the verifier's two
    rounds_ipa = len(seen["b"]).bit_length() - 1
    for name in curve.NAMES:
        if name not in FOLD_KERNELS and g1_launches[name] <= 0:
            raise AssertionError(f"lenet never launched kernel {name}")
    for name in FOLD_KERNELS:
        if g1_launches[name]:
            raise AssertionError(f"lenet launched {name} "
                                 f"{g1_launches[name]} times: the opening "
                                 f"should fold no point")
    if g1_launches["g1_msm_table"] > 7 or \
            g1_launches["ipa_scalars"] != rounds_ipa:
        raise AssertionError(f"lenet with the commitment: "
                             f"{g1_launches['g1_msm_table']} tables (at most "
                             f"7), {g1_launches['ipa_scalars']} ipa_scalars "
                             f"launches for {rounds_ipa} rounds")
    if any(g1_plain.values()):
        raise AssertionError(f"curve operations went past the kernels: "
                             f"{g1_plain}")
    for name in LADDERS:
        if rk.LAUNCHES[name] <= 0:
            raise AssertionError(f"lenet with the commitment never launched "
                                 f"kernel {name}")

    lap("lenet with the commitment")

    # the same opening by folds, on its own inputs: the proof must not
    # change; its curve launches and shapes are G1's and G2's run
    fold_run = opening_checks(torch, ipa, curve, msm_mod, seen, smi,
                              LENET_PCS_RUN)
    say(f"{FOLDS_RUN}, curve wrapper calls that launched: {fold_run[0]}")
    for name in FOLD_KERNELS:
        if fold_run[0][name] <= 0:
            raise AssertionError(f"{FOLDS_RUN} never launched kernel {name}")

    lap("the opening against the fold-based opening")

    # LeNet under Fiat-Shamir with the commitment (inner-product opening),
    # built as cli/runner.py builds it; the counts cover exactly the proof
    C, vals = zoo.lenet(32, 32, 1, 1, P.PoolType.MAX).create(
        random_source(17))
    rounds = C.layers[0].bit_length + sum(
        ly.max_bl_u + (ly.max_bl_v if ly.need_phase2 else 0)
        for ly in C.layers[1:])
    p = Prover(C, vals, own_vals=True)
    del vals
    pcs, tape = HyraxPCS(mode="ipa"), FiatShamirTape(b"zkcnn-demo-17")
    v = Verifier(p, C, tape, pcs=pcs)
    # the round loops' seconds: every round call, which ends in its fetch
    round_s = [0.0]

    def timed_round(fn):
        def run(prev_r):
            t = time.perf_counter()
            out = fn(prev_r)
            round_s[0] += time.perf_counter() - t
            return out
        return run

    for m in ("round_quadratic", "round_cubic", "liu_round"):
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
    fs_seen, uncapture = capture_opening(hyrax)
    torch.cuda.synchronize()
    rk.reset_launches()
    engine.FETCHES["rounds"] = 0
    t0 = time.perf_counter()
    ok = v.verify()
    torch.cuda.synchronize()
    fs_wall = time.perf_counter() - t0
    uncapture()
    span = {k: b - a for k, (a, b) in marks.items()}
    span["absorb"] = marks["_verify_per_round"][0] - marks["commit"][1]
    fs = {k: rk.LAUNCHES[k] for k in rk.NAMES}
    fs_fetches = engine.FETCHES["rounds"]
    launches.update({k: fs[k] for k in PER_ROUND})
    shapes.update({k: sorted(rk.SHAPES[k]) for k in PER_ROUND})
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
        f"(device kernels {dict(rk.KERNEL_LAUNCHES)}); {fs_fetches} round "
        f"fetches for {rounds} rounds; round loops {round_s[0]:.4f} s "
        f"({smi})")
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
    # the rounds run no ladder; the output layer's MLE evaluation (v_res,
    # at a point drawn whole before anything is absorbed) is one fold
    # ladder
    if fs["round_ladder"] or fs["cubic_ladder"] or fs["fold_ladder"] != 1:
        raise AssertionError(f"lenet under FiatShamirTape ran ladders: {fs}")
    if fs_fetches != rounds:
        raise AssertionError(f"lenet under FiatShamirTape: {fs_fetches} "
                             f"round fetches for {rounds} rounds")

    # its opening against the fold-based one too: under FiatShamirTape a
    # round's absorb of L_k and R_k waits for the device
    opening_checks(torch, ipa, curve, msm_mod, fs_seen, smi, LENET_FS_RUN)

    lap("lenet under Fiat-Shamir")

    # 6. every entry against its plain version at the shapes of its run,
    # timed; the reported time is at the largest of them
    kernels = []
    for name in rk.NAMES:
        seen = shapes[name]
        say(f"shapes of {name} in its run: {seen}")
        err, times = worst[name], []
        for shape in seen:
            e, kern, _ = compare(torch, rk, name, shape, gen, rng)
            err = max(err, e)
            times.append((shape, time_ms(torch, kern, 20)))
        for shape, ms in times:
            say(f"time {name} {shape}: kernel {ms:.4f} ms ({smi})")
        shape = max(seen)
        run = LENET_FS_RUN if name in PER_ROUND else LENET_RUN
        e, kern, plain = compare(torch, rk, name, shape, gen, rng)
        ms, pms = time_ms(torch, kern, 20), time_ms(torch, plain, 3)
        b_ms, b_by = bound(name, shape)
        say(f"reported time of {name}: the largest shape of its run "
            f"({run}) {shape}: "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.6f} ms "
            f"by {b_by} ({smi})")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": max(err, e), "ms": ms,
                        "plain_ms": pms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        "shape": list(shape), "run": run})
    say("kernels exact (tolerance 0) at every shape of their runs")

    lap("round kernels at their runs' shapes")

    # the curve kernels at every shape of their run (the LeNet run with
    # the commitment; G1 and G2: the fold-based opening of its opening),
    # as group elements: against the plain version on 32-bit scalars (it
    # takes seconds a shape), and at the largest shape on full-size
    # scalars too (one call of the plain version: about a minute);
    # ipa_scalars word for word
    for name in curve.NAMES:
        run, seen_shapes, launched = LENET_PCS_RUN, g1_shapes, g1_launches
        if name in FOLD_KERNELS:
            run, seen_shapes, launched = FOLDS_RUN, fold_run[1], fold_run[0]
        say(f"shapes of {name} in its run ({run}): {seen_shapes[name]}")
        shape = max(seen_shapes[name])
        if name == "ipa_scalars":
            err = 0
            for sh in seen_shapes[name]:
                e, kern, _ = ipa_scalars_compare(torch, ipa, sh, gen, rng)
                err = max(err, e)
                say(f"time {name} {sh}: kernel {time_ms(torch, kern, 20):.4f} "
                    f"ms ({smi})")
            e, kern, plain = ipa_scalars_compare(torch, ipa, shape, gen, rng)
            err = max(err, e)
            ms, pms = time_ms(torch, kern, 20), time_ms(torch, plain, 5)
            b_ms, b_by = ipa_scalars_bound(shape)
            kernels.append({"name": name, "route": "cuda",
                            "source": G1_SOURCE,
                            "replaces": G1_REPLACES[name],
                            "launches": launched[name], "max_abs_err": err,
                            "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None,
                            "shape": list(shape), "run": run})
            say(f"reported time of {name}: the largest shape of its run "
                f"({run}) {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {b_ms:.6f} ms by {b_by} ({smi})")
            continue
        if name == "g1_msm_table":
            table_shapes(torch, curve, msm_mod, seen_shapes[name], gen)
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
        "(tolerance 0 after normalising Z; ipa_scalars word for word) at "
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

    per_ms = time_ms(torch, per_round, 10)
    lad_ms = time_ms(torch, lambda: rk.round_ladder(A, V, rs)[0].cpu(), 10)
    say(f"{R} rounds from {rows} rows, dots fetched: per round "
        f"{per_ms:.4f} ms, one ladder {lad_ms:.4f} ms ({smi})")

    lap("per round against a ladder")
    say(f"seconds by phase: {'; '.join(laps)} ({smi})")

    # 7. results
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
