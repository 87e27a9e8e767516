"""GKR verifier: runs the protocol and evaluates the predicates itself
(counterpart of `zkcnn_tpu/gkr/verifier.py`).

Mirrors the reference verifier (src/verifier.cpp) step for step: the
verifier owns all randomness (a seeded Tape), drives the prover layer
by layer top-down, checks every sumcheck round message against the
previous claim, and rebuilds each layer's wiring-predicate evaluations
itself (betaInitPhase1/2 + predicatePhase1/2, verifier.cpp:36-116), so
the prover is never trusted.

With a precomputable tape (the seeded `Tape`) the draws do not depend
on absorbed messages, so every challenge is known up front and the
protocol runs in three passes:

  pass 1 (prover, = reference PT): every sumcheck init, round and
      finalize; round polys come back per round, claims stay tensors
      until ONE batched fetch that also computes the transcript digest.
  pass 2 (predicates, = the reference's "slow" verifier work,
      verifier.cpp:133-134,200-204): beta/phi table builds and gate
      predicate contractions for every layer, one batched fetch.
  pass 3 (checks, = reference "fast" VT): host replay of every round
      equality, final-value and Liu consistency check.

Any other tape (`FiatShamirTape`, whose draws hash every absorbed
message) takes the per-round path, `verify_inner_layers` then
`verify_first_layer`: the verifier absorbs each round message and, when
the tape is `interleaved`, draws r_j only after absorbing round j's
message (the reference's draw order otherwise); it builds each layer's
predicates right after the layer.  Under a `FiatShamirTape` the prover
runs each sumcheck phase whole, the tape's absorbs and draws made on the
card from the state and counter the verifier hands it (`phase_*`), and
the verifier then absorbs, draws and checks every round itself and
raises if a challenge, the final state or the counter differs from the
card's.  Any other tape drives the prover one round at a time.  There
is no transcript digest on this path: the absorbed messages are the
transcript.

With a polynomial commitment (`pcs`, a `pcs.HyraxPCS`) the verifier sets
its generators up from the tape before anything else, the prover commits
to the input layer (on the per-round path the tape then absorbs the
sha256 of the commitment's canonical encoding), and the input claim of
the Liu phase is opened and verified at the end
(verifier.cpp:119-128,359-373).
"""

import hashlib
import time
from typing import List, Optional

import torch

from ..field import FR
from ..field.params import FR_P
from ..circuit import Circuit, LayerType
from ..circuit.eval import two_mul_table
from ..mle import beta_table, beta_table_2pt, phi_table
from ..pcs import curve
from ..parallel.context import shard_rows
from .engine import _fetch_ints
from .kernels import pred_uni, pred_bin, zero_region_scale, \
    mul_outer_flat, gr_term
from .prover import Prover
from .tape import Tape, FiatShamirTape


def _eval_poly(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR_P
    return acc


class Verifier:
    def __init__(self, p: Prover, C: Circuit, tape: Optional[Tape] = None,
                 pcs=None, log=lambda *a: None):
        self.p = p
        self.C = C
        self.device = p.device
        self.tape = tape or Tape()
        self.pcs = pcs
        self.log = log
        n = C.size
        self.final_claim_u0 = [0] * (n + 2)
        self.final_claim_v0 = [0] * (n + 2)
        self.r_u: List[Optional[List[int]]] = [None] * (n + 2)
        self.r_v: List[Optional[List[int]]] = [None] * (n + 2)
        self.tm = two_mul_table(self.device)
        self.uni_value = [0, 0]
        self.bin_value = [0, 0, 0]
        self.vt = 0.0       # fast-path verifier time
        self.vt_slow = 0.0  # including predicate table builds
        self.transcript_digest = None

    def _beta(self, r, init=1):
        return beta_table(r, init, self.device)

    # ------------------------------------------------------------------
    # predicate evaluation (verifier.cpp:25-116)

    def _get_final_value(self, cu0, cu1, cv0, cv1) -> int:
        return (self.bin_value[0] * (cu0 * cv0 % FR_P)
                + self.bin_value[1] * (cu1 * cv1 % FR_P)
                + self.bin_value[2] * (cu1 * cv0 % FR_P)
                + self.uni_value[0] * cu0
                + self.uni_value[1] * cu1) % FR_P

    def _beta_init_phase1(self, depth, alpha, beta, r_0, r_1, relu_rou):
        cur = self.C.layers[depth]
        bl = cur.bit_length
        fft_bl = cur.fft_bit_length
        fblh = fft_bl - 1

        if cur.ty in (LayerType.FFT, LayerType.IFFT):
            self.beta_gs = phi_table(r_0, cur.scale, fft_bl,
                                     cur.ty == LayerType.IFFT, self.device)
            self.beta_u = self._beta(self.r_u[depth][:cur.max_bl_u])
            return
        if cur.ty == LayerType.PADDING:
            cnt = beta_table_2pt(
                self.r_u[depth + 2][fft_bl:fft_bl + bl - fblh],
                self.r_v[depth + 2][:bl - fblh]
                if self.r_v[depth + 2] else None, alpha, beta, self.device)
            eqf = self._beta(r_0[:fblh])
            self.beta_g = mul_outer_flat(cnt, eqf)
            self.beta_u = self._beta(self.r_u[depth][:cur.max_bl_u])
            return
        if cur.ty == LayerType.DOT_PROD:
            cnt_bl = bl - fft_bl
            cnt_bl2 = cur.max_bl_u - fft_bl
            self.beta_g = self._beta(
                self.r_u[depth + 2][fblh:fblh + cnt_bl], alpha)
            bu = self._beta(self.r_u[depth][fft_bl:fft_bl + cnt_bl2])
            # scalar eq over the shared fft coordinates
            s = 1
            for j in range(fft_bl):
                a, b = r_0[j], self.r_u[depth][j]
                s = s * (a * b + (1 - a) * (1 - b)) % FR_P
            self.beta_u = FR.mul(bu, FR.const(s, self.device))
            return
        a = alpha * cur.scale % FR_P
        b = beta * cur.scale % FR_P
        bg = beta_table_2pt(r_0[:bl], r_1[:bl] if r_1 else None, a, b,
                            self.device)
        if cur.zero_start_id < cur.size:
            bg = zero_region_scale(bg, relu_rou, cur.zero_start_id)
        self.beta_g = bg
        self.beta_u = self._beta(self.r_u[depth][:cur.max_bl_u])

    def _predicate_phase1_dev(self, depth):
        """uni_value as [8] tensors (or int 0)."""
        cur = self.C.layers[depth]
        host = self.p._gate_host(depth)
        self.uni_value = [0, 0]
        self.bin_value = [0, 0, 0]
        if cur.ty in (LayerType.FFT, LayerType.IFFT):
            self.uni_value[1] = FR.dot_mont(self.beta_gs, self.beta_u)
            return
        for b, key in ((0, "uni0"), (1, "uni1")):
            if host[key].shape[0]:
                self.uni_value[b] = pred_uni(self.beta_g, self.beta_u,
                                             self.tm,
                                             self.p._sum_gates(depth, key))

    def _predicate_phase1(self, depth):
        """_predicate_phase1_dev with host ints (per-round path)."""
        self._predicate_phase1_dev(depth)
        self._values_to_host()

    def _values_to_host(self):
        """uni_value and bin_value as host ints: one transfer."""
        vals = self.uni_value + self.bin_value
        ints = iter(_fetch_ints([v for v in vals if torch.is_tensor(v)]))
        vals = [next(ints) if torch.is_tensor(v) else v for v in vals]
        self.uni_value, self.bin_value = vals[:2], vals[2:]

    def _predicate_phase2_dev(self, depth):
        cur = self.C.layers[depth]
        host = self.p._gate_host(depth)
        beta_v = self._beta(self.r_v[depth][:cur.max_bl_v])
        self.uni_value = [
            0 if isinstance(v, int) and v == 0 else
            FR.mul(FR.const(v, self.device) if isinstance(v, int) else v,
                   beta_v[0])
            for v in self.uni_value]
        use_tm = cur.ty != LayerType.DOT_PROD
        for ub in (0, 1):
            for vb in (0, 1):
                if not host[f"bin{ub}{vb}"].shape[0]:
                    continue
                for l in (0, 1, 2, 3):
                    key = f"bin{ub}{vb}_l{l}"
                    if key not in host:
                        continue
                    t = pred_bin(use_tm, self.beta_g, self.beta_u, beta_v,
                                 self.tm, self.p._sum_gates(depth, key))
                    old = self.bin_value[l]
                    self.bin_value[l] = t if isinstance(old, int) \
                        else FR.add(old, t)

    def _predicate_phase2(self, depth):
        """_predicate_phase2_dev with host ints (per-round path)."""
        self._predicate_phase2_dev(depth)
        self._values_to_host()

    def _gr(self, sig_u, sig_v):
        """The Liu phase's subset predicate at the bound points, summed
        over every layer side (verifier.cpp:307-333), as an [8] tensor
        (None without a side).  With the input layer split, the beta table
        over r_u[0] is split as it is and each side's subset ids by the
        shard of their rows (`Prover._liu_blocks`): one partial a shard."""
        C, p = self.C, self.p
        beta_g = self._beta(self.r_u[0])
        split = len(p.val[0]) > 1
        if split:
            beta_g = shard_rows(beta_g, mesh=p.mesh, count=False)
        gr = None
        for i in range(1, C.size):
            ly = C.layers[i]
            for bl, ori, rr, sig in (
                    (ly.bit_length_u[0], "ori_u", self.r_u[i], sig_u[i - 1]),
                    (ly.bit_length_v[0], "ori_v", self.r_v[i],
                     sig_v[i - 1])):
                if bl < 0:
                    continue
                ids = p._liu_blocks(i, ori) if split else p._ori_dev(i)[ori]
                t = gr_term(beta_g, ids, self._beta(rr[:bl], sig))
                gr = t if gr is None else FR.add(gr, t)
        return gr

    # ------------------------------------------------------------------

    def _check_rounds(self, polys, rs, previous_sum: int, what: str):
        """Replay the per-round consistency checks (verifier.cpp:
        177-194) host-side from a phase's coefficient list."""
        for j, poly in enumerate(polys):
            self.tape.absorb(*poly)
            if (_eval_poly(poly, 0) + _eval_poly(poly, 1)) % FR_P \
                    != previous_sum:
                self.log(f"FAIL {what} bit {j}")
                return False, previous_sum
            previous_sum = _eval_poly(poly, rs[j])
        return True, previous_sum

    def verify(self) -> bool:
        if self.pcs is not None:
            # gens are set up from the verifier tape before anything
            # else (reference verifier.cpp:119-128), then the prover
            # commits.  A tape that is not precomputable absorbs the
            # commitment's canonical (affine) encoding: Jacobian words are
            # malleable by Z-scaling.
            self.pcs.setup(self.C.layers[0].bit_length, self.tape,
                           self.device)
            self.log("pcs setup done")
            self.commitment = self.pcs.commit(self.p.val[0])
            self.log("pcs commit done")
            if not self.tape.precomputable:
                enc = curve.encode_points_host(self.commitment)
                self.tape.absorb(int.from_bytes(
                    hashlib.sha256(enc).digest(), "little"))
        if self.tape.precomputable:
            ok = self._verify_precomputed()
        else:
            ok = self._verify_per_round()
        return ok and self.verify_input()

    def verify_input(self) -> bool:
        """Polynomial-commitment opening (verifier.cpp:359-373)."""
        if self.pcs is None:
            return True
        ok = self.pcs.open_and_verify(self.commitment, self.p.val[0],
                                      self.r_u[0], self.eval_in, self.tape)
        if not ok:
            self.log("FAIL pcs opening")
        return ok

    # ------------------------------------------------------------------
    # per-round path (see module docstring)

    def _verify_per_round(self) -> bool:
        """verify_inner_layers then verify_first_layer; vt is the wall
        time they take less the prover's share (prove_time)."""
        pt0 = self.p.prove_time
        t0 = time.perf_counter()
        ok = self.verify_inner_layers() and self.verify_first_layer()
        self.vt = time.perf_counter() - t0 - (self.p.prove_time - pt0)
        self.vt_slow = self.vt
        return ok

    def _sumcheck(self, step, phase, rs: List[int], n: int,
                  previous_sum: int, what: str):
        """n rounds of one phase, message by message: prove, absorb, draw
        r_j after the absorb when the tape is interleaved (else rs holds
        the challenges already), check.  Under a FiatShamirTape the prover
        runs the phase whole (`phase`), then every round is absorbed,
        drawn and checked here.  -> (ok, claim at the point)."""
        if isinstance(self.tape, FiatShamirTape):
            return self._sumcheck_phase(phase, rs, n, previous_sum, what)
        prev_r = None
        for j in range(n):
            poly = step(prev_r)
            self.tape.absorb(*poly)
            if self.tape.interleaved:
                rs.append(self.tape.field())
            if (_eval_poly(poly, 0) + _eval_poly(poly, 1)) % FR_P \
                    != previous_sum:
                self.log(f"FAIL {what} bit {j}")
                return False, previous_sum
            prev_r = rs[j]
            previous_sum = _eval_poly(poly, prev_r)
        return True, previous_sum

    def _sumcheck_phase(self, phase, rs: List[int], n: int,
                        previous_sum: int, what: str):
        """The rounds of a phase that the prover ran whole under the
        tape's state and counter: each message absorbed, r_j drawn after
        it and held against the card's draw, the round checked; at the
        end the tape's state and counter held against the card's."""
        if n == 0:
            return True, previous_sum
        polys, drawn, state, counter = phase(n, self.tape.state,
                                             self.tape.counter)
        for j, poly in enumerate(polys):
            self.tape.absorb(*poly)
            rs.append(self.tape.field())
            if rs[j] != drawn[j]:
                raise RuntimeError(f"{what} bit {j}: the prover's tape drew "
                                   f"another challenge than the verifier's")
            if (_eval_poly(poly, 0) + _eval_poly(poly, 1)) % FR_P \
                    != previous_sum:
                self.log(f"FAIL {what} bit {j}")
                return False, previous_sum
            previous_sum = _eval_poly(poly, rs[j])
        if (state, counter) != (self.tape.state, self.tape.counter):
            raise RuntimeError(f"{what}: the prover's tape ends in another "
                               f"state than the verifier's")
        return True, previous_sum

    def verify_inner_layers(self) -> bool:
        C, p = self.C, self.p
        alpha, beta = 1, 0
        last = C.layers[C.size - 1]
        self.r_u[C.size] = self.tape.fields(last.bit_length)
        r_0 = self.r_u[C.size]
        r_1 = None

        previous_sum = p.v_res(r_0)
        self.tape.absorb(previous_sum)
        p.sumcheck_init_all(r_0)

        for i in range(C.size - 1, 0, -1):
            cur = C.layers[i]
            p.sumcheck_init(alpha, beta)
            if self.tape.interleaved:
                # r_j is drawn only after round poly j is absorbed;
                # relu_rou parameterizes the init, so it comes first
                relu_rou = self.tape.field() \
                    if cur.zero_start_id < cur.size else 1
                self.r_u[i] = []
            else:
                # reference draw order (verifier.cpp:156-160)
                self.r_u[i] = self.tape.fields(cur.max_bl_u)
                relu_rou = self.tape.field() \
                    if cur.zero_start_id < cur.size else 1

            if cur.ty == LayerType.DOT_PROD:
                p.sumcheck_dotprod_init_phase1()
                step, phase = p.round_cubic, p.phase_cubic
            else:
                p.sumcheck_init_phase1(relu_rou)
                step, phase = p.round_quadratic, p.phase_quadratic
            ok, previous_sum = self._sumcheck(
                step, phase, self.r_u[i], cur.max_bl_u, previous_sum,
                f"phase1 layer {i}")
            if not ok:
                return False

            if cur.ty == LayerType.DOT_PROD:
                final_claim_u1 = p.dotprod_finalize1(self.r_u[i])
                self.final_claim_u0[i] = 0
            else:
                self.final_claim_u0[i], final_claim_u1 = \
                    p.finalize1(self.r_u[i])
            self.tape.absorb(self.final_claim_u0[i], final_claim_u1)

            self._beta_init_phase1(i, alpha, beta, r_0, r_1, relu_rou)
            self._predicate_phase1(i)

            final_claim_v1 = 0
            if cur.need_phase2:
                self.r_v[i] = [] if self.tape.interleaved \
                    else self.tape.fields(cur.max_bl_v)
                p.sumcheck_init_phase2()
                ok, previous_sum = self._sumcheck(
                    p.round_quadratic, p.phase_quadratic, self.r_v[i],
                    cur.max_bl_v, previous_sum, f"phase2 layer {i}")
                if not ok:
                    return False
                self.final_claim_v0[i], final_claim_v1 = \
                    p.finalize2(self.r_v[i])
                self.tape.absorb(self.final_claim_v0[i], final_claim_v1)
                self._predicate_phase2(i)

            test_value = self._get_final_value(
                self.final_claim_u0[i], final_claim_u1,
                self.final_claim_v0[i], final_claim_v1)
            if test_value != previous_sum:
                self.log(f"FAIL semifinal layer {i} ({cur.ty})")
                return False

            # claim linkage to the next layer down (verifier.cpp:245-255)
            if cur.ty in (LayerType.FFT, LayerType.IFFT):
                previous_sum = final_claim_u1
            else:
                alpha = self.tape.field() if cur.bit_length_u[1] >= 0 else 0
                beta = self.tape.field() if cur.bit_length_v[1] >= 0 else 0
                previous_sum = (alpha * final_claim_u1
                                + beta * final_claim_v1) % FR_P
            r_0 = self.r_u[i]
            r_1 = self.r_v[i]
            p.release_gates(i)
            p.release_val(i)
            self.log(f"layer {i:3d} {cur.ty.name:9s} bl={cur.bit_length} "
                     f"ok")
        return True

    def verify_first_layer(self) -> bool:
        """Liu input-consolidation sumcheck (verifier.cpp:268-357)."""
        C, p = self.C, self.p
        cur = C.layers[0]
        sig_u = self.tape.fields(C.size - 1)
        sig_v = self.tape.fields(C.size - 1)
        self.r_u[0] = [] if self.tape.interleaved \
            else self.tape.fields(cur.bit_length)

        previous_sum = 0
        for i in range(1, C.size):
            if C.layers[i].bit_length_u[0] >= 0:
                previous_sum += sig_u[i - 1] * self.final_claim_u0[i]
            if C.layers[i].bit_length_v[0] >= 0:
                previous_sum += sig_v[i - 1] * self.final_claim_v0[i]
        previous_sum %= FR_P

        p.sumcheck_liu_init(sig_u, sig_v)
        ok, previous_sum = self._sumcheck(p.liu_round, p.liu_phase,
                                          self.r_u[0], cur.bit_length,
                                          previous_sum, "liu")
        if not ok:
            return False

        self.eval_in = p.liu_finalize(self.r_u[0])
        self.tape.absorb(self.eval_in)

        # gr = sum over layers of the subset predicate at the bound points
        gr = self._gr(sig_u, sig_v)
        gr = _fetch_ints([gr])[0] if gr is not None else 0

        if self.eval_in * gr % FR_P != previous_sum:
            self.log("FAIL liu semifinal")
            return False
        self.log("first layer (Liu) ok")
        return True

    # ------------------------------------------------------------------
    # precomputable-tape path: three passes (see module docstring)

    def _verify_precomputed(self) -> bool:
        p = self.p
        t0 = time.perf_counter()
        recs = self._prover_pass()
        self._fetch_transcript(recs)
        # PT = wall clock of the prover pass + the transcript fetch
        # (reference prove_timer semantics)
        p.prove_time = time.perf_counter() - t0

        t1 = time.perf_counter()
        self._predicate_pass(recs)
        t2 = time.perf_counter()
        ok = self._replay(recs)
        t3 = time.perf_counter()
        self.vt = t3 - t2                      # reference "fast" VT
        self.vt_slow = (t2 - t1) + self.vt     # + predicate builds
        return ok

    def _prover_pass(self):
        """Drive every prover phase; return the transcript (round polys
        as host ints, claims as tensors) plus the host-side draws."""
        C, p = self.C, self.p
        alpha, beta = 1, 0
        last = C.layers[C.size - 1]
        self.r_u[C.size] = self.tape.fields(last.bit_length)
        recs = {"vres": p.v_res_dev(self.r_u[C.size]), "layers": []}
        p.sumcheck_init_all(self.r_u[C.size])

        for i in range(C.size - 1, 0, -1):
            cur = C.layers[i]
            p.sumcheck_init(alpha, beta)
            self.r_u[i] = self.tape.fields(cur.max_bl_u)
            relu_rou = self.tape.field() \
                if cur.zero_start_id < cur.size else 1
            rec = {"i": i, "alpha": alpha, "beta": beta,
                   "relu_rou": relu_rou}
            if cur.ty == LayerType.DOT_PROD:
                p.sumcheck_dotprod_init_phase1()
                rec["polys1"] = p.run_rounds_cubic(self.r_u[i])
                rec["cu0"] = 0
                rec["cu1"], _ = p.dotprod_finalize1_dev(self.r_u[i])
            else:
                p.sumcheck_init_phase1(relu_rou)
                rec["polys1"] = p.run_rounds_quad(self.r_u[i])
                rec["cu0"], rec["cu1"] = p.finalize1_dev(self.r_u[i])
            if cur.need_phase2:
                self.r_v[i] = self.tape.fields(cur.max_bl_v)
                p.sumcheck_init_phase2()
                rec["polys2"] = p.run_rounds_quad(self.r_v[i])
                rec["cv0"], rec["cv1"] = p.finalize2_dev(self.r_v[i])
            # claim linkage draws (verifier.cpp:245-255)
            if cur.ty not in (LayerType.FFT, LayerType.IFFT):
                alpha = self.tape.field() \
                    if cur.bit_length_u[1] >= 0 else 0
                beta = self.tape.field() \
                    if cur.bit_length_v[1] >= 0 else 0
                rec["next_alpha"], rec["next_beta"] = alpha, beta
            recs["layers"].append(rec)
            p.evict_gates(i)
            p.release_val(i)
            self.log(f"prove layer {i:3d} {cur.ty.name:9s} "
                     f"bl={cur.bit_length}")

        # Liu input-consolidation phase (verifier.cpp:268-305)
        sig_u = self.tape.fields(C.size - 1)
        sig_v = self.tape.fields(C.size - 1)
        self.r_u[0] = self.tape.fields(C.layers[0].bit_length)
        recs["sig_u"], recs["sig_v"] = sig_u, sig_v
        p.sumcheck_liu_init(sig_u, sig_v)
        recs["liu_polys"] = p.run_rounds_quad(self.r_u[0])
        recs["eval_in"] = p.liu_finalize_dev(self.r_u[0])
        return recs

    @staticmethod
    def _tx_slots(recs):
        """The transcript's (container, key) slots in fetch order."""
        slots = [(recs, "vres")]
        for rec in recs["layers"]:
            slots += [(rec, "polys1"), (rec, "cu0"), (rec, "cu1")]
            if "polys2" in rec:
                slots += [(rec, "polys2"), (rec, "cv0"), (rec, "cv1")]
        slots += [(recs, "liu_polys"), (recs, "eval_in")]
        return slots

    def _fetch_transcript(self, recs):
        """One batched fetch of every claim tensor, converted to host
        ints in place, and the transcript digest: sha256 over every
        transcript element (round-poly coefficients and claims) in
        slot order, each as 32 little-endian bytes -- the JAX
        package's step-path digest."""
        slots = self._tx_slots(recs)
        tensors = [obj[key] for obj, key in slots
                   if torch.is_tensor(obj[key])]
        fetched = iter(_fetch_ints(tensors))
        h = hashlib.sha256()
        for obj, key in slots:
            v = obj[key]
            if isinstance(v, int):              # a claim that is not sent
                continue
            if isinstance(v, list):             # round polys
                for poly in v:
                    for c in poly:
                        h.update(c.to_bytes(32, "little"))
            else:
                obj[key] = next(fetched)
                h.update(obj[key].to_bytes(32, "little"))
        self.transcript_digest = h.hexdigest()

    def _predicate_pass(self, recs):
        """The verifier's own beta/phi table builds and gate predicate
        contractions for every layer, then one batched fetch."""
        for rec in recs["layers"]:
            i = rec["i"]
            self._beta_init_phase1(i, rec["alpha"], rec["beta"],
                                   self.r_u[i + 1], self.r_v[i + 1],
                                   rec["relu_rou"])
            self._predicate_phase1_dev(i)
            if "polys2" in rec:
                self._predicate_phase2_dev(i)
            rec["uni"] = list(self.uni_value)
            rec["bin"] = list(self.bin_value)
            self.p.release_gates(i)

        # Liu gr = subset predicate at the bound points (verifier.cpp:
        # 307-333)
        gr = self._gr(recs["sig_u"], recs["sig_v"])

        slots = [(lst, j, v) for rec in recs["layers"]
                 for lst in (rec["uni"], rec["bin"])
                 for j, v in enumerate(lst) if not isinstance(v, int)]
        ints = _fetch_ints([v for _, _, v in slots]
                           + ([gr] if gr is not None else []))
        for k, (lst, j, _) in enumerate(slots):
            lst[j] = ints[k]
        recs["gr"] = ints[len(slots)] if gr is not None else 0

    def _replay(self, recs) -> bool:
        """Host replay of every protocol check (reference 'fast' VT)."""
        C, p = self.C, self.p
        previous_sum = recs["vres"]
        self.tape.absorb(previous_sum)
        for rec in recs["layers"]:
            i = rec["i"]
            cur = C.layers[i]
            polys1 = rec["polys1"]
            if cur.ty == LayerType.DOT_PROD:
                p.account_cubic(polys1)
            ok, previous_sum = self._check_rounds(
                polys1, self.r_u[i], previous_sum, f"phase1 layer {i}")
            if not ok:
                return False
            self.final_claim_u0[i] = rec["cu0"]
            cu1 = rec["cu1"]
            cv1 = 0
            self.tape.absorb(rec["cu0"], cu1)
            if "polys2" in rec:
                ok, previous_sum = self._check_rounds(
                    rec["polys2"], self.r_v[i], previous_sum,
                    f"phase2 layer {i}")
                if not ok:
                    return False
                self.final_claim_v0[i] = rec["cv0"]
                cv1 = rec["cv1"]
                self.tape.absorb(rec["cv0"], cv1)
            self.uni_value = rec["uni"]
            self.bin_value = rec["bin"]
            test_value = self._get_final_value(
                rec["cu0"], cu1, self.final_claim_v0[i], cv1)
            if test_value != previous_sum:
                self.log(f"FAIL semifinal layer {i} ({cur.ty})")
                return False
            if cur.ty in (LayerType.FFT, LayerType.IFFT):
                previous_sum = cu1
            else:
                previous_sum = (rec["next_alpha"] * cu1
                                + rec["next_beta"] * cv1) % FR_P
            self.log(f"layer {i:3d} {cur.ty.name:9s} "
                     f"bl={cur.bit_length} ok")

        # Liu phase checks (verifier.cpp:283-333)
        previous_sum = 0
        for i in range(1, C.size):
            if C.layers[i].bit_length_u[0] >= 0:
                previous_sum += recs["sig_u"][i - 1] \
                    * self.final_claim_u0[i]
            if C.layers[i].bit_length_v[0] >= 0:
                previous_sum += recs["sig_v"][i - 1] \
                    * self.final_claim_v0[i]
        previous_sum %= FR_P
        ok, previous_sum = self._check_rounds(
            recs["liu_polys"], self.r_u[0], previous_sum, "liu")
        if not ok:
            return False
        self.eval_in = recs["eval_in"]
        self.tape.absorb(self.eval_in)
        if self.eval_in * recs["gr"] % FR_P != previous_sum:
            self.log("FAIL liu semifinal")
            return False
        self.log("first layer (Liu) ok")
        return True
