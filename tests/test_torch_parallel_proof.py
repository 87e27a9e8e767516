"""Complete proofs of zkcnn_tpu_torch split over CPU meshes (["cpu"]
repeated D times) hold the one-device transcripts (tolerance 0: digests,
tape states and byte counts):

  * `dryrun_multichip(4, ["cpu"] * 4)`: the three tiny models with the
    sqrt commitment, each digest and proof size equal to the JAX
    package's one-device pins (`__graft_entry__.PINNED_1CHIP`);
  * under FiatShamirTape with the commitment, meshes of 2 and 4:
    sconv_muladd (inner-product commitment) and tiny_fc_fft (sqrt) end in
    the JAX package's one-device tape state and counter (PINNED_FS_TINY
    of tests/test_torch_fs_paths.py), tiny_fc_fft with the inner-product
    commitment in the one-device port's (TINY_FC_FS_IPA), and
    tiny_fc_fft without a commitment in the JAX package's run
    (TINY_FC_FS_PIN of tests/test_torch_fs_gkr.py);
  * a tampered witness is rejected under the mesh on the three-pass and
    the Fiat-Shamir paths, and the split path is seen to run: ladders on
    the shards' rows and on the gathered tails, every split operand
    gathered once, the Fiat-Shamir phases with a split side on the host
    tape and those whose operands stayed whole in their phase call;
  * (slow) LeNet5 pic_cnt=1 --no-pcs over four CPU shards proves to the
    port's one-device digest.
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import PINNED_1CHIP
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape, FiatShamirTape
from zkcnn_tpu_torch.gkr import engine
from zkcnn_tpu_torch.parallel import sharding
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.parallel import COUNTS, make_mesh, use_mesh, \
    reset_counts
from zkcnn_tpu_torch.parallel.dryrun import dryrun_multichip, tiny_models
from zkcnn_tpu_torch.pcs import HyraxPCS
from tests.test_torch_fs_gkr import TINY_FC_FS_PIN
from tests.test_torch_fs_paths import PINNED_FS_TINY

TINY = dict(tiny_models())

# tiny_fc_fft, random_source(24), FiatShamirTape(b"dryrun-tiny_fc_fft"),
# the inner-product commitment: the final tape state and counter of the
# port's one-device run on the CPU
TINY_FC_FS_IPA = (
    "91394f30c46c411d88edb6c6624c9a3b4c6ae359ce611e5bc8137c4f05aca317"
    "07503a53cad3e60919fdeae9c8613560ce46138d2b3c631889ae5515951b8168",
    133)


def _prove(name, D, tape, mode, tamper=False):
    with use_mesh(make_mesh(D, devices=["cpu"] * D)):
        C, vals = TINY[name]().create(random_source(24), device="cpu")
        if tamper:
            vals[-1] = vals[-1].clone()
            vals[-1][0] = FR.add(vals[-1][0], FR.const(1, "cpu"))
        p = Prover(C, vals)
        v = Verifier(p, C, tape, pcs=HyraxPCS(mode=mode) if mode else None)
        return v.verify(), p, v


def test_dryrun_multichip_holds_the_jax_one_device_pins():
    out = dryrun_multichip(4, ["cpu"] * 4, log=lambda *a: None)
    assert out == {name: (pin["proof_size"], pin["digest"])
                   for name, pin in PINNED_1CHIP.items()}


def test_fiat_shamir_over_meshes_of_2_and_4_ends_in_the_one_device_tape():
    for D in (2, 4):
        for name, mode, seed, pin in (
                ("sconv_muladd", "ipa", b"dryrun-sconv_muladd",
                 PINNED_FS_TINY[("sconv_muladd", "ipa")]),
                ("tiny_fc_fft", "sqrt", b"dryrun-tiny_fc_fft",
                 PINNED_FS_TINY[("tiny_fc_fft", "sqrt")]),
                ("tiny_fc_fft", "ipa", b"dryrun-tiny_fc_fft",
                 TINY_FC_FS_IPA)):
            tape = FiatShamirTape(seed)
            ok, p, _ = _prove(name, D, tape, mode)
            assert ok and (tape.state.hex(), tape.counter) == pin, (name, D)
            assert p.proof_size == PINNED_1CHIP[name]["proof_size"]
    tape = FiatShamirTape(b"fs-tiny_fc_fft")
    ok, p, v = _prove("tiny_fc_fft", 4, tape, None)
    assert ok and {"proof_size": p.proof_size, "eval_in": v.eval_in,
                   "state": tape.state.hex(), "counter": tape.counter} \
        == TINY_FC_FS_PIN


def test_tampered_witness_rejected_and_the_split_path_ran(monkeypatch):
    D = 4
    ladders, real = [], sharding.round_ladder

    def recorded(A, V, rs):
        ladders.append((A.shape[0], len(rs)))
        return real(A, V, rs)

    monkeypatch.setattr(sharding, "round_ladder", recorded)
    reset_counts()
    ok, p, v = _prove("sconv_muladd", D, Tape(b"dryrun-sconv_muladd"),
                      "sqrt")
    assert ok and v.transcript_digest == \
        PINNED_1CHIP["sconv_muladd"]["digest"]
    # a side of 2^k >= 2D rows runs one ladder a shard on its 2^k / D
    # rows down to one row, then the D gathered rows the last log2(D)
    # rounds: D ladders of one shape (L, log2 L), L >= 2, and (D, 2)
    assert (D, 2) in ladders
    assert any(ladders.count((L, R)) >= D for L, R in set(ladders)
               if L >= 2 and L == 1 << R), ladders
    assert COUNTS["splits"] == COUNTS["gathers"] > 0 \
        and COUNTS["partials"] > 0 and COUNTS["host_tape_phases"] == 0
    assert not _prove("sconv_muladd", D, Tape(b"dryrun-sconv_muladd"),
                      "sqrt", tamper=True)[0]
    reset_counts()
    assert not _prove("sconv_muladd", D,
                      FiatShamirTape(b"dryrun-sconv_muladd"), "sqrt",
                      tamper=True)[0]
    assert COUNTS["host_tape_phases"] > 0 and COUNTS["gathers"] > 0
    # a phase under the mesh whose sides stay whole (fewer than 2D rows)
    # makes its phase call, and gives what the host tape gives
    rng = np.random.default_rng(3)
    ops = [torch.from_numpy(FR.pack_mont_host(
        [int(x) for x in rng.integers(0, 1 << 62, 1 << nb)]))
        for nb in (2, 2, 1, 1)]
    calls, phase_call = [], engine.fold_round_phase

    def recorded_phase(sides, n, *args):
        calls.append((n, [s[0].shape[0] for s in sides]))
        return phase_call(sides, n, *args)

    monkeypatch.setattr(engine, "fold_round_phase", recorded_phase)
    got = {}
    for d in (1, D):
        reset_counts()
        with use_mesh(make_mesh(d, devices=["cpu"] * d)):
            phase = engine.PhaseEngine([engine.Side(ops[0], ops[1], 2),
                                        engine.Side(ops[2], ops[3], 1)], 5)
            tape = FiatShamirTape(b"whole")
            got[d] = phase.run_fs(3, tape.state, tape.counter)
    assert calls == [(3, [4, 2])] * 2 and got[1] == got[D]
    assert COUNTS["device_tape_phases"] == 1 \
        and COUNTS["host_tape_phases"] == 0


@pytest.mark.slow
def test_lenet_no_pcs_over_four_cpu_shards_holds_its_digest():
    from zkcnn_tpu_torch.cli import demo_lenet
    from tests.test_torch_fs_gkr import PINNED_LENET_DIGEST
    reset_counts()
    with use_mesh(make_mesh(4, devices=["cpu"] * 4)):
        res = demo_lenet.main(["--synthetic", "--seed", "17", "--pic-cnt",
                               "1", "--no-pcs", "--cpu"])
    assert res["digest"] == PINNED_LENET_DIGEST
    assert (res["row"]["WS"], res["row"]["PS"]) == ("201734(2^18)",
                                                    "45.7188")
    assert COUNTS["splits"] == COUNTS["gathers"] > 0
    assert COUNTS["transposes"] > 0
