"""The multi-round ladders of the round kernels on the CPU, tolerance 0
(field elements are integers).

The ladders' plain versions against the JAX package's XLA reference
looped over the rounds (`coeffs_quadratic_dots` + `fold`,
`engine._cubic_terms` + `fold`; never the Pallas kernels in interpret
mode, never the fused ladder programs), and the phase engines' `run_all`
against their per-round form (a loop of `round(prev_r)`, then
`receive`) and against a Python-int oracle.
"""

import numpy as np
import torch

import jax.numpy as jnp

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.mle import fold as j_fold, coeffs_quadratic_dots as j_dots
from zkcnn_tpu.gkr.engine import _cubic_terms as j_cubic_terms
from zkcnn_tpu_torch.field import FR, FR_P
from zkcnn_tpu_torch.field import round_kernels as rk
from zkcnn_tpu_torch.gkr.engine import Side, PhaseEngine, DotProdPhase1
from zkcnn_tpu_torch.interop import limbs16_to_words, vals_from_jax

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(31), "little") % FR_P for _ in range(n)]


def _rand_mont(rng, m):
    """The same residues as JAX limbs and as port words."""
    J = jnp.asarray(JFR.pack_mont_host(_ints(rng, m)))
    return J, vals_from_jax([J])[0]


def _w(j):
    return limbs16_to_words(np.asarray(j))


def _t(xs):
    return torch.from_numpy(FR.pack_mont_host(xs))


def test_round_and_fold_ladders_plain_match_xla_loop():
    """m = 1024 (three wide rounds on a card) and m = 16 run down to one
    row (under the tail threshold from the start)."""
    for m, R in ((1024, 3), (16, 4)):
        rng = np.random.default_rng(m)
        JA, A = _rand_mont(rng, m)
        JV, V = _rand_mont(rng, m)
        rs = _ints(rng, R)
        dots, A_R, V_R = rk.round_ladder(A, V, rs)      # CPU: plain
        X_R = rk.fold_ladder(A, rs)
        assert dots.shape == (R, 4, 8) and A_R.shape == (m >> R, 8)
        for j, r in enumerate(rs):
            np.testing.assert_array_equal(dots[j].numpy(), _w(j_dots(JA, JV)))
            rp = jnp.asarray(JFR.to_mont_host(r))
            JA, JV = j_fold(JA, rp), j_fold(JV, rp)
        np.testing.assert_array_equal(A_R.numpy(), _w(JA))
        np.testing.assert_array_equal(V_R.numpy(), _w(JV))
        np.testing.assert_array_equal(X_R.numpy(), _w(JA))


def test_cubic_ladder_plain_matches_xla_loop():
    """M < K (m indexed modulo M/2), m running down to one row while V
    still has four."""
    K, M, R = 16, 4, 2
    rng = np.random.default_rng(K * 100 + M)
    Jm, m = _rand_mont(rng, M)
    JV0, V0 = _rand_mont(rng, K)
    JV1, V1 = _rand_mont(rng, K)
    rs = _ints(rng, R)
    coeffs, m_R, V0_R, V1_R = rk.cubic_ladder(m, V0, V1, rs)
    assert coeffs.shape == (R, 4, 8) and m_R.shape == (1, 8)
    for j, r in enumerate(rs):
        want = np.stack([_w(x) for x in j_cubic_terms(Jm, JV1, JV0)])
        np.testing.assert_array_equal(coeffs[j].numpy(), want)
        rp = jnp.asarray(JFR.to_mont_host(r))
        Jm, JV0, JV1 = j_fold(Jm, rp), j_fold(JV0, rp), j_fold(JV1, rp)
    np.testing.assert_array_equal(m_R.numpy(), _w(Jm))
    np.testing.assert_array_equal(V0_R.numpy(), _w(JV0))
    np.testing.assert_array_equal(V1_R.numpy(), _w(JV1))


def _fold_ints(xs, r):
    return [(xs[2 * i] + r * (xs[2 * i + 1] - xs[2 * i])) % FR_P
            for i in range(len(xs) // 2)]


def _phase_oracle(sides, add_term, include, rs):
    """The round polys of a quadratic phase on Python ints; sides is a
    list of (A, V) int lists of power-of-two length."""
    sides = [[list(A), list(V), False] for A, V in sides]
    polys = []
    for r in rs:
        c = [0, 0, 0]
        for s in sides:
            A, V, collapsed = s
            if len(A) == 1:
                if not collapsed:
                    add_term = (add_term + A[0] * V[0]) % FR_P
                    s[2] = True
                continue
            for i in range(len(A) // 2):
                a0, da = A[2 * i], A[2 * i + 1] - A[2 * i]
                v0, dv = V[2 * i], V[2 * i + 1] - V[2 * i]
                c[0] += a0 * v0
                c[1] += a0 * dv + da * v0
                c[2] += da * dv
            s[0], s[1] = _fold_ints(A, r), _fold_ints(V, r)
        if include:
            c[0] += add_term
            c[1] -= add_term
            add_term = add_term * (1 - r) % FR_P
        polys.append(tuple(x % FR_P for x in c))
    return polys, add_term


def _cubic_oracle(m, V0, V1, rs):
    polys = []
    for r in rs:
        c = [0, 0, 0, 0]
        if len(m) > 1:
            half = len(m) // 2
            for i in range(len(V0) // 2):
                j = i % half
                f = (m[2 * j], m[2 * j + 1] - m[2 * j])
                g = (V1[2 * i], V1[2 * i + 1] - V1[2 * i])
                h = (V0[2 * i], V0[2 * i + 1] - V0[2 * i])
                for x in range(2):
                    for y in range(2):
                        for z in range(2):
                            c[x + y + z] += f[x] * g[y] * h[z]
            m = _fold_ints(m, r)
        else:
            for i in range(len(V0) // 2):
                g = (V1[2 * i], V1[2 * i + 1] - V1[2 * i])
                h = (V0[2 * i], V0[2 * i + 1] - V0[2 * i])
                for y in range(2):
                    for z in range(2):
                        c[y + z] += m[0] * g[y] * h[z]
        V0, V1 = _fold_ints(V0, r), _fold_ints(V1, r)
        polys.append(tuple(x % FR_P for x in c))
    return polys, m, V0, V1


def _per_round(engine, rs):
    """The per-round (Fiat-Shamir) form of a phase: round j folds at
    r_(j-1), then forms its message; receive makes the last fold."""
    polys = [engine.round(rs[j - 1] if j else None) for j in range(len(rs))]
    engine.receive(rs[-1])
    return polys


def test_run_all_equals_loop_of_step_and_oracle():
    """Two sides of unequal nb (3 and 1) over 5 rounds, so both exhaust
    mid-phase (the short one as a two-row side folded in the round it
    runs out) and join a nonzero add_term; both values of
    include_add_term; run_all whole, split in two calls, and the
    per-round form.  Then the cubic phase with m reaching one row before
    V (the switch to the quadratic form on (V1, V0) scaled by m[0])."""
    rng = np.random.default_rng(5)
    a0, v0, a1, v1 = (_ints(rng, n) for n in (8, 8, 2, 2))
    rs = _ints(rng, 5)
    add = 123456789
    for include in (True, False):
        def engine():
            return PhaseEngine([Side(_t(a0), _t(v0), 3),
                                Side(_t(a1), _t(v1), 1)], add, include)
        want, want_add = _phase_oracle([(a0, v0), (a1, v1)], add, include,
                                       rs)
        whole, split, steps = engine(), engine(), engine()
        assert whole.run_all(rs) == want
        assert split.run_all(rs[:2]) + split.run_all(rs[2:]) == want
        assert _per_round(steps, rs) == want
        for e in (whole, split, steps):
            assert e.add_term == want_add
            assert all(s.collapsed and s.folds == s.nb for s in e.sides)
            assert torch.equal(e.final_claim_dev(0, 3), whole.sides[0].V[0])

    m, V0, V1 = _ints(rng, 4), _ints(rng, 16), _ints(rng, 16)
    rs = _ints(rng, 4)
    want, m_f, V0_f, V1_f = _cubic_oracle(m, V0, V1, rs)

    def cubic():
        return DotProdPhase1(_t(m), _t(V0), _t(V1), 2, 4)
    whole, steps = cubic(), cubic()
    assert whole.run_all(rs) == want
    assert _per_round(steps, rs) == want
    for e in (whole, steps):
        claim, v_u1 = e.finalize_dev()
        assert FR.unpack_mont_host(claim.numpy()) == V1_f
        assert FR.unpack_mont_host(v_u1.numpy()) == [V1_f[0] * m_f[0] % FR_P]
        assert FR.unpack_mont_host(e.V0.numpy()) == V0_f
