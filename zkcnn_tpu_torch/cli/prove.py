"""Big-run proof tool with postmortem capture (counterpart of the JAX
package's tools/prove.py):

  * faulthandler dumps every thread's stack every 10 minutes to stderr
    and on SIGTERM or SIGINT, so that a hang or a kill leaves its place
    behind;
  * every stage (witness build or snapshot load, snapshot save, each
    layer of the proof, the check) logs a line on stderr with the seconds
    since the start, the host RSS high-water and the device's allocated
    and peak memory;
  * --snapshot PATH loads the circuit and witness (C, vals) from PATH if
    it exists, else builds them and saves them there first (to PATH.tmp,
    then renamed), so that a proof can be timed, or restarted, without
    its witness build.  What is saved lies on the host: the circuit holds
    numpy arrays only, and vals go to the host as numpy words; after a
    load they go back to the proof's device.  A snapshot is a pickle:
    load only one this tool wrote.

It proves under the seeded Tape(b"zkcnn-demo-<seed>"), as the JAX tool
does, on the first CUDA device unless --cpu is given (no card: an
error), and prints the result row, the transcript digest and
"Verification pass" on stdout, or "Verification FAILED" and exits 1.

  python -m zkcnn_tpu_torch.cli.prove MODEL [--pic-cnt N] [--pcs]
      [--seed N] [--pool max|avg] [--cpu] [--build-only]
      [--snapshot PATH]
"""

import argparse
import faulthandler
import os
import pickle
import resource
import signal
import sys
import time

import torch

from .. import resolve_device
from ..gkr import Prover, Verifier, Tape
from ..nn import random_source
from ..pcs import HyraxPCS
from .runner import build_model

MODELS = ("lenet", "ccnn", "vgg11", "vgg16")


def save_snapshot(path: str, C, vals) -> int:
    """Writes (C, vals) to path: vals as host numpy words, through
    path + ".tmp" and a rename, so that a cut write leaves no snapshot.
    Returns the bytes written."""
    host = [None if v is None else v.cpu().numpy() for v in vals]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"C": C, "vals": host}, f, protocol=5)
    os.replace(tmp, path)
    return os.path.getsize(path)


def load_snapshot(path: str, device):
    """(C, vals) from a snapshot that save_snapshot wrote, vals on
    `device`."""
    with open(path, "rb") as f:
        snap = pickle.load(f)
    vals = [None if v is None else torch.from_numpy(v).to(device)
            for v in snap["vals"]]
    return snap["C"], vals


class StageLog:
    """Log lines on stderr: seconds since the start, the host RSS
    high-water and, on a card, its allocated and peak memory."""

    def __init__(self, device):
        self.t0 = time.time()
        self.device = device

    def __call__(self, *msg):
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
        dev = ""
        if self.device.type == "cuda":
            mb = (torch.cuda.memory_allocated(self.device) >> 20,
                  torch.cuda.max_memory_allocated(self.device) >> 20)
            dev = f" dev={mb[0]}MB peak={mb[1]}MB"
        print(f"[{time.time() - self.t0:8.1f}s rss={rss}MB{dev}]",
              *msg, file=sys.stderr, flush=True)


def _synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """The tool on argv; returns, for a caller in Python, a dict of the
    run: the snapshot's path, bytes and save or load seconds and the
    witness seconds (a build's, or the load's), and unless --build-only
    the row's values, the transcript digest, the proof size, PT, VT, VT
    slow, POLY_PT, POLY_VT, the commit's and the generators' table's
    seconds and the card's peak memory (0 on the CPU)."""
    ap = argparse.ArgumentParser(description="zkcnn-tpu-torch proof tool")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--pic-cnt", type=int, default=1)
    ap.add_argument("--pcs", action="store_true",
                    help="commit to the input (the inner-product opening)")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--pool", choices=["max", "avg"], default="max")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the first CUDA device; "
                    "an error when there is none)")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the witness build (with --snapshot: "
                    "build and save a snapshot)")
    ap.add_argument("--snapshot", metavar="PATH",
                    help="circuit and witness snapshot: load (C, vals) from "
                    "PATH if it exists, else build them and save them there "
                    "first")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    # the stacks go to the process's own stderr, whatever sys.stderr is
    # now; a caller's faulthandler state is left as it was
    err, enabled = sys.__stderr__, faulthandler.is_enabled()
    if not enabled:
        faulthandler.enable(file=err)
    faulthandler.dump_traceback_later(600, repeat=True, file=err)
    for sig in (signal.SIGTERM, signal.SIGINT):
        faulthandler.register(sig, file=err, chain=True)
    try:
        return _prove(args, device)
    finally:
        faulthandler.cancel_dump_traceback_later()
        for sig in (signal.SIGTERM, signal.SIGINT):
            faulthandler.unregister(sig)
        if not enabled:
            faulthandler.disable()


def _prove(args, device):
    log = StageLog(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log(f"{args.model} pic_cnt={args.pic_cnt} pcs={args.pcs} "
        f"device={device} seed={args.seed}")
    snap = {"path": args.snapshot, "save_s": None, "load_s": None,
            "bytes": None}
    t0 = time.time()
    if args.snapshot and os.path.exists(args.snapshot):
        C, vals = load_snapshot(args.snapshot, device)
        _synced(device)
        snap.update(load_s=time.time() - t0,
                    bytes=os.path.getsize(args.snapshot))
        log(f"snapshot loaded from {args.snapshot} ({snap['bytes']} bytes, "
            f"{snap['load_s']:.1f}s)")
    else:
        nn, _, _ = build_model(args.model, args)
        C, vals = nn.create(random_source(args.seed), device=device)
        del nn
        _synced(device)
        log(f"witness built ({time.time() - t0:.1f}s)")
        if args.snapshot:
            t1 = time.time()
            snap["bytes"] = save_snapshot(args.snapshot, C, vals)
            snap["save_s"] = time.time() - t1
            log(f"snapshot saved to {args.snapshot} ({snap['bytes']} "
                f"bytes, {snap['save_s']:.1f}s)")
    witness_s = time.time() - t0
    size, bl = C.layers[0].size, C.layers[0].bit_length
    log(f"witness {witness_s:.1f}s: {C.size} layers, input size {size} "
        f"(2^{bl})")
    if args.build_only:
        log("build-only: stopping before the proof")
        return {"snapshot": snap, "witness_s": witness_s}

    p = Prover(C, vals, own_vals=True)   # one proof: free dead layers
    del vals
    pcs = HyraxPCS() if args.pcs else None
    v = Verifier(p, C, Tape(b"zkcnn-demo-%d" % args.seed), pcs=pcs,
                 log=log)
    t0 = time.time()
    ok = v.verify()
    _synced(device)
    log(f"verify() -> {ok} in {time.time() - t0:.1f}s")
    pt, vt, vt_slow, ps_kb = p.prove_time, v.vt, v.vt_slow, \
        p.proof_size / 1024.0
    line = (f"{args.model}, pcnt={args.pic_cnt}, WS={size}(2^{bl}), "
            f"PT={pt:.4f}, VT={vt:.4f}, VT_slow={vt_slow:.4f}, "
            f"PS={ps_kb:.4f}KB")
    if pcs is not None:
        line += (f", POLY_PT={pcs.pt:.4f}, POLY_VT={pcs.vt:.4f}, "
                 f"POLY_PS={pcs.ps / 1024.0:.4f}KB")
    print(line, flush=True)
    print(f"transcript sha256 {v.transcript_digest}", flush=True)
    if not ok:
        print("Verification FAILED", flush=True)
        sys.exit(1)
    print("Verification pass", flush=True)
    poly = (pcs.pt, pcs.vt, pcs.ps / 1024.0, pcs.commit_s, pcs.table_s) \
        if pcs is not None else (0.0, 0.0, 0.0, 0.0, 0.0)
    row = {"WS": f"{size}(2^{bl})", "PT": f"{pt:.4f}", "VT": f"{vt:.4f}",
           "PS": f"{ps_kb:.4f}", "POLY_PT": f"{poly[0]:.4f}",
           "POLY_VT": f"{poly[1]:.4f}", "POLY_PS": f"{poly[2]:.4f}"}
    return {"row": row, "line": line, "digest": v.transcript_digest,
            "proof_size": p.proof_size, "witness_s": witness_s,
            "snapshot": snap, "pt": pt, "vt": vt, "vt_slow": vt_slow,
            "poly_pt": poly[0], "poly_vt": poly[1], "poly_ps": poly[2],
            "poly_commit_s": poly[3], "poly_table_s": poly[4],
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0}


if __name__ == "__main__":
    main()
