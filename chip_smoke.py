#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zkcnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. start: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from zkcnn_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card at edge
     sizes (2, 4, a non-multiple of the block size, 2^18): exact;
  4. the three tiny models proven and verified on the card: transcript
     digest and proof size equal to their 1-device pins;
  5. LeNet5, pic_cnt=1, through the port's demo_lenet entry
     (--synthetic --seed 17 --no-pcs) on the card, with the kernel launch
     counts reset just before and read just after: it must verify, with
     WS 201734(2^18), PS 45.7188 KB, the pinned digest, and every kernel
     launched;
  6. each kernel against its plain version at every shape the LeNet run
     launched it at (exact), timed with CUDA events;
  7. one JSON line of kernel results, the nvidia-smi name/power line, and
     the final JSON status line.
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
REPLACES = {
    "round_step": "zkcnn_tpu/field/pallas_round2.py:171",
    "fold": "zkcnn_tpu/field/pallas_round2.py:171",
    "cubic_round_step": "zkcnn_tpu/field/pallas_round.py:402",
}
P_TOP_WORD = 0x73EDA753     # top 32-bit word of the Fr modulus


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
    w[:, 7] %= P_TOP_WORD
    return (w - ((w >> 31) << 32)).to(torch.int32)


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


def compare(torch, rk, name, shape, gen, rng):
    """Kernel vs plain on the same card tensors; raises on a mismatch.
    Returns (max_abs_err, kernel_fn, plain_fn)."""
    r = rng.getrandbits(254)
    if name == "cubic_round_step":
        K, M = shape
        args = (rand_fe(torch, M, gen), rand_fe(torch, K, gen),
                rand_fe(torch, K, gen), r)
        kern, plain = rk.cubic_round_step, rk.cubic_round_step_plain
    elif name == "round_step":
        (m,) = shape
        args = (rand_fe(torch, m, gen), rand_fe(torch, m, gen), r)
        kern, plain = rk.round_step, rk.round_step_plain
    else:
        (m,) = shape
        args = (rand_fe(torch, m, gen), r)
        kern, plain = rk.fold, rk.fold_plain
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_err(torch, g, w) for g, w in zip(got, want))
    if err or any(g.shape != w.shape for g, w in zip(got, want)):
        raise AssertionError(f"{name} at {shape}: kernel differs from its "
                             f"plain version (max abs err {err})")
    return err, (lambda: kern(*args)), (lambda: plain(*args))


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
    rk._lib()

    # 3. kernels against their plain versions at edge sizes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rng = random.Random(17)
    edge = {"round_step": [(2,), (4,), (1554,), (1 << 18,)],
            "fold": [(2,), (4,), (1554,), (1 << 18,)],
            "cubic_round_step": [(2, 2), (4, 2), (4, 4), (1554, 14),
                                 (1 << 18, 1 << 11)]}
    worst = {k: 0 for k in edge}
    for name, shapes in edge.items():
        for shape in shapes:
            err, _, _ = compare(torch, rk, name, shape, gen, rng)
            worst[name] = max(worst[name], err)
        say(f"edge sizes exact (tolerance 0): {name} at {shapes}")

    from zkcnn_tpu_torch.nn import random_source, NeuralNetwork
    from zkcnn_tpu_torch.nn import models as zoo
    from zkcnn_tpu_torch.nn import params as P
    from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape

    # 4. tiny models on the card
    for name, build in tiny_models(zoo, NeuralNetwork, P):
        nn = build()
        C, vals = nn.create(random_source(24), device="cuda")
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

    # 5. LeNet through the demo entry; counts cover exactly this run
    from zkcnn_tpu_torch.cli import demo_lenet
    rk.reset_launches()
    res = demo_lenet.main(["--synthetic", "--seed", "17", "--no-pcs",
                           "--pic-cnt", "1"])      # cuda: it is available
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
    shapes = {k: sorted(v) for k, v in rk.SHAPES.items()}
    row = res["row"]
    say(f"lenet: Verification pass, WS {row['WS']}, PS {row['PS']} KB, "
        f"PT {row['PT']} s, VT {row['VT']} s, witness "
        f"{res['witness_s']:.2f} s, digest {res['digest']}")
    say(f"lenet row: {res['line']}")
    say(f"lenet launches: {launches}")
    if row["WS"] != PINNED_LENET["WS"] or row["PS"] != PINNED_LENET["PS"]:
        raise AssertionError(f"lenet WS/PS {row['WS']}/{row['PS']} differ "
                             f"from {PINNED_LENET}")
    if res["digest"] != PINNED_LENET["digest"]:
        raise AssertionError(f"lenet digest {res['digest']} differs from "
                             f"the CPU pin {PINNED_LENET['digest']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"lenet never launched kernel {name}")

    # 6. kernels against their plain versions at the LeNet shapes, timed
    kernels = []
    for name, seen in shapes.items():
        say(f"lenet shapes of {name}: {seen}")
        err, times = worst[name], []
        for shape in seen:
            e, kern, plain = compare(torch, rk, name, shape, gen, rng)
            err = max(err, e)
            times.append((shape, time_ms(torch, kern, 20),
                          time_ms(torch, plain, 5)))
        for shape, ms, pms in times:
            say(f"time {name} {shape}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms ({smi})")
        shape, ms, pms = times[-1]          # the largest LeNet shape
        say(f"reported time of {name}: its largest LeNet shape {shape}")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": pms})
    say("kernels exact (tolerance 0) at every LeNet shape")

    # 7. results
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
