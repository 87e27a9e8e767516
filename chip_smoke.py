#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zkcnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. start: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from zkcnn_tpu_torch/csrc with nvcc;
  3. each kernel entry (the one-round steps and the multi-round ladders)
     against its plain PyTorch version on the card at edge sizes: 2, 4,
     1554 (folded while the row count is even), 2^12 and 2^18 rows with
     as many rounds as they allow, so that wide rounds with lazily
     reduced dots (from 2^18 rows) and without, the hand-over to the
     one-block tail and tail-only ladders are covered, 2^21 rows, and
     rows of p - 1: exact;
  4. the three tiny models proven and verified on the card: transcript
     digest and proof size equal to their 1-device pins; then the
     per-round engines (PhaseEngine.step, DotProdPhase1.step) driven on
     card tensors at the shapes of LeNet's largest phases, with the
     launch counts reset before and read after: every round message
     equal to run_all's;
  5. LeNet5, pic_cnt=1, through the port's demo_lenet entry
     (--synthetic --seed 17 --no-pcs) on the card, with the kernel launch
     counts reset just before and read just after: it must verify, with
     WS 201734(2^18), PS 45.7188 KB, the pinned digest, every ladder
     launched, and at most one fetch per side per phase;
  6. each entry against its plain version at every shape its run
     launched it at (exact), timed with CUDA events, with the least time
     the card could take for the same work beside it;
  7. one JSON line of kernel results (each entry's launches, shape and
     times belong to the run its `run` key names), the nvidia-smi
     name/power line, and the final JSON status line.
"""

import json
import os
import random
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

SOURCE = "zkcnn_tpu_torch/csrc/round_kernels.cu"
QUAD = "zkcnn_tpu/field/pallas_round2.py:237"       # and pallas_round.py:249
CUBIC = "zkcnn_tpu/field/pallas_round.py:475"
REPLACES = {"round_step": QUAD, "fold": QUAD, "cubic_round_step": CUBIC,
            "round_ladder": QUAD, "fold_ladder": QUAD,
            "cubic_ladder": CUBIC}
STEPS = {"round_step": "round_ladder", "fold": "fold_ladder",
         "cubic_round_step": "cubic_ladder"}      # step -> its ladder
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
# the runs that the `launches`, shapes and times of an entry come from
STEP_RUN = "per-round engines at the shapes of LeNet's largest phases"
LENET_RUN = "lenet"


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
    """A shape is (rows, R) or (K, M, R); a one-round step has R = 1."""
    return shape[-1]


def bound(name: str, shape):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (inputs read once, outputs written once) over the memory rate
    and the 32-bit multiplies it needs (64 for a product that a dot sums
    unreduced, 128 for a fold's or a cubic term's) over the integer
    rate."""
    R = rounds_of(shape)
    if "cubic" in name:
        K, M, _ = shape
        rows_in, rows_out = 2 * K + M + R, 2 * (K >> R) + (M >> R) + 4 * R
        muls = sum(CUBIC_PAIR_MULS * (K >> (j + 1))
                   + FOLD_PAIR_MULS * (M >> (j + 1)) for j in range(R))
    elif "fold" in name:
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
    rs = [rng.getrandbits(254) for _ in range(rounds_of(shape))]
    ch = rs if name.endswith("ladder") else rs[0]
    if "cubic" in name:
        K, M, _ = shape
        args = (fill(torch, M, gen), fill(torch, K, gen),
                fill(torch, K, gen), ch)
    elif "fold" in name:
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
    """Edge shapes per entry: the steps at R = 1, the ladders at every
    round their row counts allow."""
    rows = [2, 4, 1554, 1 << 12, 1 << 18]
    cubic = [(2, 2), (4, 2), (4, 4), (1554, 14), (1 << 11, 1 << 9),
             (1 << 12, 1 << 5), (1 << 12, 1 << 12), (1 << 18, 1 << 11)]
    quad = [(m, even_rounds(m)) for m in rows] + [(1 << 18, 3), (1 << 21, 2)]
    return {
        "round_step": [(m, 1) for m in rows],
        "fold": [(m, 1) for m in rows],
        "cubic_round_step": [(K, M, 1) for K, M in cubic],
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


def per_round_phases(torch, engine, how):
    """A quadratic phase (sides of 2^18 and 2^12 rows, a nonzero add_term,
    one round past the longer side) and a DOT_PROD phase 1 ((K, M) =
    (2^16, 2^9)) on card tensors made from a fixed seed, run by a loop of
    `step` or by `run_all`; returns both lists of round messages."""
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
        out.append([phase.step(r) for r in rs] if how == "step"
                   else phase.run_all(rs))
    return out


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

    # 1. start
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say(f"device: {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    say(f"nvidia-smi: {smi}")

    # 2. build
    from zkcnn_tpu_torch import cuda_build
    t0 = time.time()
    lib_path = cuda_build.build(verbose=True)
    say(f"build: {lib_path.name} in {time.time() - t0:.1f}s")
    from zkcnn_tpu_torch.field import round_kernels as rk
    from zkcnn_tpu_torch.gkr import engine
    rk._lib()

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

    from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
    from zkcnn_tpu_torch.nn import models as zoo
    from zkcnn_tpu_torch.nn import params as P
    from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape

    # 4. tiny models on the card
    for name, build in tiny_models(zoo, NeuralNetwork, P):
        nn = build()
        C, vals = nn.create(random_source(24))   # default: the card
        p = Prover(C, vals)
        tape = Tape(b"dryrun-" + name.encode())
        bl = C.layers[0].bit_length
        tape.fields(1 << (bl - (bl >> 1)))   # the PCS setup's draws
        v = Verifier(p, C, tape)
        if not v.verify():
            raise AssertionError(f"{name}: verification failed on cuda")
        pin = PINNED_1CHIP[name]
        if (v.transcript_digest, p.proof_size) != (pin["digest"],
                                                   pin["proof_size"]):
            raise AssertionError(
                f"{name}: digest {v.transcript_digest} / proof size "
                f"{p.proof_size} differ from the pin {pin}")
        say(f"tiny model {name}: verified, digest and proof size "
            f"{p.proof_size} equal PINNED_1CHIP")

    # the per-round engines, whose counts cover exactly their two phases
    rk.reset_launches()
    step_polys = per_round_phases(torch, engine, "step")
    torch.cuda.synchronize()
    launches = {k: rk.LAUNCHES[k] for k in STEPS}
    shapes = {k: sorted(rk.SHAPES[k]) for k in STEPS}
    ladder_ran = {k: rk.LAUNCHES[k] for k in STEPS.values()}
    say(f"per-round engines, wrapper calls that launched: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the per-round engines never launched "
                                 f"{name}")
    if any(ladder_ran.values()):
        raise AssertionError(f"the per-round engines ran ladders: "
                             f"{ladder_ran}")
    if step_polys != per_round_phases(torch, engine, "run_all"):
        raise AssertionError("a loop of step and run_all give different "
                             "round messages")
    say(f"per-round engines: {len(step_polys[0])} quadratic and "
        f"{len(step_polys[1])} cubic round messages equal to run_all's")

    # 5. LeNet through the demo entry; counts cover exactly this run
    from zkcnn_tpu_torch.cli import demo_lenet
    rk.reset_launches()
    engine.FETCHES["rounds"] = 0
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--no-pcs",
                           "--pic-cnt", "1"])      # no --cpu: the card
    torch.cuda.synchronize()
    lenet = {k: rk.LAUNCHES[k] for k in rk.NAMES}
    launches.update({k: lenet[k] for k in STEPS.values()})
    shapes.update({k: sorted(rk.SHAPES[k]) for k in STEPS.values()})
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
    for name in STEPS.values():
        if lenet[name] <= 0:
            raise AssertionError(f"lenet never launched kernel {name}")
    for name in STEPS:
        if lenet[name]:
            raise AssertionError(f"lenet ran {name} {lenet[name]} times: "
                                 f"its rounds should all run in ladders")
    # a phase fetches once for all its sides
    if fetches > lenet["round_ladder"] + lenet["cubic_ladder"]:
        raise AssertionError(f"{fetches} fetches for "
                             f"{lenet['round_ladder']} sides")

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
        run = STEP_RUN if name in STEPS else LENET_RUN
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

    # what a ladder saves at LeNet's largest side: its rounds one by one,
    # each fetched before the next, against one ladder and one fetch
    rows, R = max(shapes["round_ladder"])
    A, V = rand_fe(torch, rows, gen), rand_fe(torch, rows, gen)
    rs = [rng.getrandbits(254) for _ in range(R)]

    def per_round():
        a, v = A, V
        for r in rs:
            d, a, v = rk.round_step(a, v, r)
            d.cpu()

    per_ms = time_ms(torch, per_round, 10)
    lad_ms = time_ms(torch, lambda: rk.round_ladder(A, V, rs)[0].cpu(), 10)
    say(f"{R} rounds from {rows} rows, dots fetched: per round "
        f"{per_ms:.4f} ms, one ladder {lad_ms:.4f} ms ({smi})")

    # 7. results
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
