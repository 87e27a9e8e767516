"""Proofs of zkcnn_tpu_torch with the witness, the gate classes and the
inits' accumulators split over CPU meshes (["cpu"] repeated D times), as
the JAX package's Prover holds them under a mesh, tolerance 0:

  * the three tiny models over 2 and 4 shards (three-pass, the sqrt
    commitment) to the JAX package's one-device pins (`PINNED_1CHIP`),
    with the split seen in the resident-byte account
    (`parallel.context.RESIDENT`): each shard holds exactly its blocks of
    every witness layer that splits (1/D of it; a layer too small to
    split whole on shard 0), the gates of a split init routed to the
    shards that own their scatter rows, and each shard's column
    accumulators hold 1/D of the largest side's rows;
  * a tampered witness (the input layer, read by the inits' indexed
    gathers, the Liu phase and the commitment; an inner layer) rejected
    under the split, three-pass and under FiatShamirTape;
  * (slow) LeNet5 pic_cnt=1 --no-pcs over four CPU shards to the port's
    one-device digest, each shard's resident high-water at most a
    quarter of the one-device run's plus the tables it reads whole.
"""

import pytest
import torch

from __graft_entry__ import PINNED_1CHIP
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape, FiatShamirTape
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.parallel import make_mesh, use_mesh, reset_counts, \
    COUNTS
from zkcnn_tpu_torch.parallel.context import RESIDENT, split_count
from zkcnn_tpu_torch.parallel.dryrun import tiny_models
from zkcnn_tpu_torch.pcs import HyraxPCS

torch.set_num_threads(1)

TINY = dict(tiny_models())
ROW = FR.n * 4                       # bytes of a field element


def _recorded(monkeypatch):
    """The gate classes every init took: (layer, key, class rows, the
    shards its scatter splits over)."""
    seen, real = [], Prover._init_gates

    def init_gates(self, lid, keys, D):
        out = real(self, lid, keys, D)
        for key in keys:
            seen.append((lid, key, self._gate_host(lid)[key].shape[0], D))
        return out

    monkeypatch.setattr(Prover, "_init_gates", init_gates)
    return seen


def _prove(name, D, tape, pcs="sqrt", tamper=None):
    reset_counts()
    with use_mesh(make_mesh(D, devices=["cpu"] * D) if D > 1 else None):
        C, vals = TINY[name]().create(random_source(24), device="cpu")
        sizes = [v.shape[0] for v in vals]
        if tamper is not None:
            vals[tamper] = vals[tamper].clone()
            vals[tamper][1] = FR.add(vals[tamper][1], FR.const(1, "cpu"))
        p = Prover(C, vals)
        # a split layer's blocks each in a storage of their own: none a
        # view that keeps the whole layer alive on its device
        assert all(b.untyped_storage().nbytes() == b.numel() *
                   b.element_size() for blocks in p.val
                   if blocks is not None and len(blocks) > 1
                   for b in blocks), name
        v = Verifier(p, C, tape, pcs=HyraxPCS(mode=pcs) if pcs else None)
        ok = v.verify()
    high = {s: dict(h) for s, h in RESIDENT["high"].items()}
    return ok, p, v, sizes, high


def test_tiny_models_split_over_2_and_4_shards_hold_the_one_device_pins(
        monkeypatch):
    seen = _recorded(monkeypatch)
    for name, pin in PINNED_1CHIP.items():
        for D in (2, 4):
            seen.clear()
            ok, p, v, sizes, high = _prove(name, D, Tape(b"dryrun-" +
                                                     name.encode()))
            assert ok and (v.transcript_digest, p.proof_size) == (
                pin["digest"], pin["proof_size"]), (name, D)
            assert COUNTS["splits"] == COUNTS["gathers"] > 0
            assert COUNTS["takes"] > 0
            mesh = make_mesh(D, devices=["cpu"] * D)
            want = [0] * D
            for n in sizes:
                if split_count(n, mesh) == D:
                    want = [w + n // D * ROW for w in want]
                else:
                    want[0] += n * ROW
            assert [high[s]["val"] for s in range(D)] == want, (name, D)
            assert any(d == D for *_, d in seen)
            assert COUNTS["routes"] > 0
            # a shard's largest accumulator: 1/D of the largest side's
            # rows (the Liu phase's, 2^bl of the input layer, or an
            # inner side's), the spare row apart
            C = p.C
            most = max([C.layers[0].bit_length] + [
                b for ly in C.layers[1:] for b in ly.bit_length_u +
                ly.bit_length_v])
            for s in range(D):
                assert high[s]["acc"] == ((1 << most) // D + 1) * 128, \
                    (name, s, high[s]["acc"])


def test_a_tampered_witness_is_rejected_under_the_split():
    for tamper in (0, 2):
        for tape in (Tape(b"dryrun-sconv_muladd"),
                     FiatShamirTape(b"dryrun-sconv_muladd")):
            ok, *_ = _prove("sconv_muladd", 4, tape, tamper=tamper)
            assert not ok, (tamper, type(tape).__name__)
    ok, *_ = _prove("tiny_fc_fft", 4, Tape(b"dryrun-tiny_fc_fft"), None,
                    tamper=3)
    assert not ok


@pytest.mark.slow
def test_lenet_no_pcs_split_over_four_cpu_shards(monkeypatch):
    from zkcnn_tpu_torch.cli import demo_lenet
    from zkcnn_tpu_torch.gkr import kernels
    from tests.test_torch_fs_gkr import PINNED_LENET_DIGEST
    seen = _recorded(monkeypatch)
    argv = ["--synthetic", "--seed", "17", "--pic-cnt", "1", "--no-pcs",
            "--cpu"]
    highs = {}
    for D in (1, 4):
        reset_counts()
        with use_mesh(make_mesh(D, devices=["cpu"] * D) if D > 1 else None):
            res = demo_lenet.main(argv)
        assert res["digest"] == PINNED_LENET_DIGEST
        highs[D] = {s: dict(h) for s, h in RESIDENT["high"].items()}
    one = highs[1][0]["split"]
    for s, h in highs[4].items():
        assert h["split"] <= one // 4 + h["replicated"], (s, h, one)
    for lid, key, rows, D in seen:
        if rows > kernels.GATE_CHUNK:
            assert D == 4, (lid, key, rows)
