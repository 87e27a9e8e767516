"""The Fiat-Shamir phase call on the CPU: the engines' `run_fs` (the
plain version of `fold_round_phase` / `fold_cubic_round_phase`) against
the per-round loop (`round(prev_r)`, then `receive`) under the host
FiatShamirTape, and singleConv proven through it against the JAX
package.  Tolerance 0: messages, challenges and claims are integers,
tape states bytes.  Inputs come from np.random.default_rng(seed).
"""

import numpy as np
import torch

from zkcnn_tpu.gkr import Prover as JProver, Verifier as JVerifier
from zkcnn_tpu.gkr.tape import FiatShamirTape as JFiatShamirTape
from zkcnn_tpu.nn import random_source as j_random_source
from zkcnn_tpu.nn.models import singleConv as j_singleConv
from zkcnn_tpu.nn.params import ConvType as JConvType
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field import round_kernels as rk
from zkcnn_tpu_torch.gkr import Prover, Verifier, FiatShamirTape
from zkcnn_tpu_torch.gkr.engine import Side, PhaseEngine, DotProdPhase1
from zkcnn_tpu_torch.nn import random_source
from zkcnn_tpu_torch.nn.models import singleConv
from zkcnn_tpu_torch.nn.params import ConvType


def _rand(rng, m):
    return torch.from_numpy(FR.pack_mont_host(
        [int.from_bytes(rng.bytes(32), "little") % FR_P for _ in range(m)]))


def _per_round(engine, n, tape):
    """The per-round loop as the verifier drives it: -> (polys, rs)."""
    polys, rs, prev = [], [], None
    for _ in range(n):
        polys.append(engine.round(prev))
        tape.absorb(*polys[-1])
        prev = tape.field()
        rs.append(prev)
    engine.receive(prev)
    return polys, rs


def _host(x):
    return FR.unpack_mont_host(x.numpy())


def test_quadratic_phase_equals_the_per_round_loop():
    """Sides of different nb (one exhausts mid-phase), a side of two rows,
    one of one row, add_term as a host int and as a tensor, and Liu's
    phase (include_add_term False): messages, challenges, the tape's
    state and counter, add_term and the final claims."""
    rng = np.random.default_rng(5)
    for nbs, n, include, dev_add in [((6, 3), 6, True, False),
                                     ((2, 4), 4, True, True),
                                     ((1, None), 3, True, False),
                                     ((0, 3), 3, True, True),
                                     ((None, 5), 5, False, False)]:
        ops = [None if nb is None else (_rand(rng, 1 << nb),
                                        _rand(rng, 1 << nb)) for nb in nbs]
        add = int.from_bytes(rng.bytes(32), "little") % FR_P

        def engine():
            term = FR.const(add, "cpu") if dev_add else add
            return PhaseEngine([None if o is None else Side(*o, nb)
                                for o, nb in zip(ops, nbs)],
                               add_term=term, include_add_term=include)

        loop, tape = engine(), FiatShamirTape(b"phase")
        want = _per_round(loop, n, tape)
        whole, start = engine(), FiatShamirTape(b"phase")
        polys, rs, state, counter = whole.run_fs(n, start.state,
                                                 start.counter)
        assert (polys, rs) == want, (nbs, n)
        assert (state, counter) == (tape.state, tape.counter)
        assert whole.received and whole.add_term == loop._add_host()
        for b, nb in enumerate(nbs):
            if nb is not None:
                assert _host(whole.final_claim_dev(b, nb)[None]) == \
                    _host(loop.final_claim_dev(b, nb)[None])
                assert _host(whole.sides[b].A[:1]) == \
                    _host(loop.sides[b].A[:1])


def test_cubic_phase_equals_the_per_round_loop():
    """DOT_PROD phase 1 with m collapsing to one row mid-phase, m as wide
    as V, and m of one row from the start: messages (c3 = 0 once m has
    one row, absorbed all the same), challenges, the tape's state and
    counter, and finalize_dev's claims."""
    rng = np.random.default_rng(6)
    for M, n in [(4, 5), (8, 3), (1, 3)]:
        m, V0, V1 = _rand(rng, M), _rand(rng, 1 << n), _rand(rng, 1 << n)
        loop, tape = DotProdPhase1(m, V0, V1, M.bit_length() - 1, n), \
            FiatShamirTape(b"cubic")
        want = _per_round(loop, n, tape)
        whole, start = DotProdPhase1(m, V0, V1, M.bit_length() - 1, n), \
            FiatShamirTape(b"cubic")
        polys, rs, state, counter = whole.run_fs(n, start.state,
                                                 start.counter)
        assert (polys, rs) == want, (M, n)
        assert (state, counter) == (tape.state, tape.counter)
        assert any(p[3] == 0 for p in polys) == (M < 1 << n)
        assert _host(torch.stack(whole.finalize_dev())) == \
            _host(torch.stack(loop.finalize_dev()))


def test_single_conv_through_the_phase_call_matches_jax():
    """singleConv NAIVE_FAST, seed 33, FiatShamirTape(b"fs"): every phase
    through the phase call (no round call), and the absorbed sequence,
    proof size, input claim and final tape state equal the JAX
    package's."""
    def recording(base):
        class Recording(base):
            def __init__(self, seed):
                super().__init__(seed)
                self.absorbed = []

            def absorb(self, *values):
                self.absorbed.append(tuple(int(v) % FR_P for v in values))
                super().absorb(*values)
        return Recording

    Cj, vj = j_singleConv(6, 1, 1, 3, 2, JConvType.NAIVE_FAST).create(
        j_random_source(33))
    jt = recording(JFiatShamirTape)(b"fs")
    jp = JProver(Cj, vj)
    jv = JVerifier(jp, Cj, jt)
    assert jv.verify()

    C, vals = singleConv(6, 1, 1, 3, 2, ConvType.NAIVE_FAST).create(
        random_source(33), device="cpu")
    t = recording(FiatShamirTape)(b"fs")
    p = Prover(C, vals)
    calls = {"phase": 0, "round": 0}

    def counted(fn, kind):
        def run(*args):
            calls[kind] += 1
            return fn(*args)
        return run

    for name in ("phase_quadratic", "phase_cubic", "liu_phase"):
        setattr(p, name, counted(getattr(p, name), "phase"))
    for name in ("round_quadratic", "round_cubic", "liu_round"):
        setattr(p, name, counted(getattr(p, name), "round"))
    rk.reset_launches()
    v = Verifier(p, C, t)
    assert v.verify()
    assert calls["phase"] > 0 and calls["round"] == 0
    assert t.absorbed == jt.absorbed
    assert (p.proof_size, v.eval_in) == (jp.proof_size, jv.eval_in)
    assert (t.state, t.counter) == (jt.state, jt.counter)
    assert all(n == 0 for n in rk.LAUNCHES.values())     # on the CPU
