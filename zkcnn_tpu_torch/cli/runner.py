"""Experiment harness: drive build -> prove -> verify and emit the
16-column result row (counterpart of `zkcnn_tpu/cli/runner.py`;
reference output_tb, src/global_var.hpp:12-27; columns filled at
verifier.cpp:338-340,365-371, neuralNetwork.cpp:783).
"""

import argparse
import sys
import time

import torch

from .. import resolve_device
from ..circuit import ceil_pow2_bit_length
from ..gkr import Prover, Verifier, Tape
from ..nn import TensorSource, csv_source, random_source
from ..nn import models as model_zoo
from ..nn.debug import check_zero_regions
from ..nn.params import PoolType
from ..pcs import HyraxPCS

OUT_COLS = ["MO_INFO", "PSIZE", "KSIZE", "PCNT", "CONV_TY", "QS", "WS",
            "PT", "VT", "PS", "POLY_PT", "POLY_VT", "POLY_PS",
            "TOT_PT", "TOT_VT", "TOT_PS"]


def base_arg_parser(desc):
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("input_file", nargs="?", help="csv input data "
                    "(reference README.md:34-58 format)")
    ap.add_argument("config_file", nargs="?", help="scale/zero-point "
                    "config (read but unused, like the reference; "
                    "README.md:23-25)")
    ap.add_argument("output_file", nargs="?", help="predictions out")
    ap.add_argument("pic_cnt", nargs="?", type=int, default=1)
    ap.add_argument("--pic-cnt", dest="pic_cnt_kw", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="random input data (the reference demo data "
                    "archive is absent upstream)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--pool", choices=["max", "avg"], default="max")
    ap.add_argument("--no-pcs", action="store_true",
                    help="skip the Hyrax polynomial commitment")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device; "
                    "an error when there is none)")
    ap.add_argument("--log", action="store_true")
    return ap


def finish_args(args):
    args.device = resolve_device("cpu" if args.cpu else None)
    if args.pic_cnt_kw is not None:
        args.pic_cnt = args.pic_cnt_kw
    if not args.synthetic and not args.input_file:
        print("no input file given: falling back to --synthetic",
              file=sys.stderr)
        args.synthetic = True
    return args


def make_source(args) -> TensorSource:
    if args.synthetic:
        return random_source(args.seed)
    return csv_source(args.input_file)


def run(nn, args, mo_info: str, psize: int, ksize: int):
    """Build, prove and verify; prints the result row and returns a
    dict with the row, the verifier's transcript digest, the proof size
    in bytes, the timings, the commitment's POLY_PT, POLY_VT (seconds;
    `poly_commit_s` is the share of POLY_PT spent in the row
    commitments, the rest is the opening; `poly_table_s` is the setup's
    table of the generators, outside POLY_PT) and POLY_PS (KB), and the
    peak device memory in bytes (`peak_bytes`, 0 on the CPU).  Under
    --log the witness's zero regions are checked (a violation raises)
    and every log line carries the seconds since the start."""
    device = args.device
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    start = time.time()
    log = (lambda *a: print(f"[{time.time() - start:9.2f}s]", *a,
                            file=sys.stderr)) if args.log \
        else (lambda *a: None)

    t0 = time.time()
    C, vals = nn.create(make_source(args), device=device)
    if on_cuda:
        torch.cuda.synchronize(device)
    witness_t = time.time() - t0
    log(f"witness: {C.size} layers, input size {C.layers[0].size} "
        f"(2^{ceil_pow2_bit_length(C.layers[0].size)}) in {witness_t:.2f}s")
    if args.log:
        check_zero_regions(C, vals)
        log("zero regions hold")

    preds = nn.infer() if nn.full_conn else None
    if args.output_file and preds is not None:
        with open(args.output_file, "w") as f:
            for k in preds:
                f.write(f"{k}\n")

    p = Prover(C, vals, own_vals=True)   # one proof: free dead layers
    nn.vals = None
    del vals
    pcs = None if args.no_pcs else HyraxPCS()
    v = Verifier(p, C, Tape(b"zkcnn-demo-%d" % args.seed), pcs=pcs, log=log)

    t0 = time.time()
    ok = v.verify()
    total_t = time.time() - t0

    if not ok:
        print("Verification FAILED", file=sys.stderr)
        sys.exit(1)
    print("Verification pass", file=sys.stderr)
    print(f"transcript sha256 {v.transcript_digest}", file=sys.stderr)

    pt = p.prove_time
    # reference VT semantics: the "fast" verifier time (check replay);
    # vt_slow adds the verifier's own beta/predicate table builds
    # (verifier.cpp:133-134,200-204)
    vt = v.vt if v.vt else total_t - pt
    vt_slow = v.vt_slow if v.vt_slow else vt
    ps_kb = p.proof_size / 1024.0
    poly_pt = pcs.pt if pcs else 0.0
    poly_vt = pcs.vt if pcs else 0.0
    poly_ps = (pcs.ps / 1024.0) if pcs else 0.0
    ws_bl = ceil_pow2_bit_length(C.layers[0].size)

    row = {
        "MO_INFO": mo_info,
        "PSIZE": str(psize),
        "KSIZE": str(ksize),
        "PCNT": str(args.pic_cnt),
        "CONV_TY": nn.conv_section[0][0].ty.name if nn.conv_section else "",
        "QS": f"Q{nn.Q}",
        "WS": f"{C.layers[0].size}(2^{ws_bl})",
        "PT": f"{pt:.4f}",
        "VT": f"{vt:.4f}",
        "PS": f"{ps_kb:.4f}",
        "POLY_PT": f"{poly_pt:.4f}",
        "POLY_VT": f"{poly_vt:.4f}",
        "POLY_PS": f"{poly_ps:.4f}",
        "TOT_PT": f"{pt + poly_pt:.4f}",
        "TOT_VT": f"{vt + poly_vt:.4f}",
        "TOT_PS": f"{ps_kb + poly_ps:.4f}",
    }
    line = ", ".join(row[c] for c in OUT_COLS) + ", "
    print(line)
    print(f"witness generation {witness_t:.2f}s, prove {pt:.2f}s, "
          f"verify {vt:.4f}s (slow {vt_slow:.2f}s), "
          f"proof {ps_kb:.1f}KB, commitment prove {poly_pt:.2f}s verify "
          f"{poly_vt:.2f}s {poly_ps:.1f}KB (generator table "
          f"{pcs.table_s if pcs else 0.0:.4f}s) on {device}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    if on_cuda:
        print(f"peak device memory {peak / 2**30:.2f} GiB", file=sys.stderr)
    return {"row": row, "line": line, "digest": v.transcript_digest,
            "proof_size": p.proof_size, "witness_s": witness_t,
            "pt": pt, "vt": vt, "vt_slow": vt_slow,
            "poly_pt": poly_pt, "poly_vt": poly_vt, "poly_ps": poly_ps,
            "poly_commit_s": pcs.commit_s if pcs else 0.0,
            "poly_table_s": pcs.table_s if pcs else 0.0,
            "peak_bytes": peak}


def build_model(name: str, args):
    pool = PoolType.MAX if args.pool == "max" else PoolType.AVG
    if name == "lenet":
        return model_zoo.lenet(32, 32, 1, args.pic_cnt, pool), 32, 5
    if name == "lenet-cifar":
        return model_zoo.lenetCifar(32, 32, 3, args.pic_cnt, pool), 32, 5
    if name == "vgg11":
        return model_zoo.vgg11(32, 32, 3, args.pic_cnt, pool), 32, 3
    if name == "vgg16":
        return model_zoo.vgg16(32, 32, 3, args.pic_cnt, pool), 32, 3
    if name == "ccnn":
        return model_zoo.ccnn(8, 8, args.pic_cnt, 1, pool), 8, 2
    raise ValueError(name)
