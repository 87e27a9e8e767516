"""GKR prover: per-layer sumcheck state machine over tensors
(counterpart of `zkcnn_tpu/gkr/prover.py`).

Mirrors the reference prover (src/prover.cpp) math exactly, with the
scalar per-gate loops replaced by gathers + exact modular segment sums
and the per-round halving by the round kernels (see engine.py).

Stateful dataflow preserved from the reference:
  * `self.beta_g` persists across layers: the IFFT layer's phase-1 init
    writes the count-variable beta table that the following DOT_PROD
    layer's phase-1/2 read (prover.cpp:90,190-197,288), and the FFT
    layer's table is likewise read by PADDING (prover.cpp:214-219);
  * `V_u0`/`V_u1` flow from phase-1 finalize into phase-2 init
    (prover.cpp:298-304);
  * subset claims accumulate per layer for the Liu input-consolidation
    phase (prover.cpp:312-358).

The prover runs on the device its witness tensors live on.

Three ways to drive it: `run_rounds_*` and the `_dev` finalizes run a
whole phase at challenges known beforehand (the seeded tape's
three-pass verifier); for a verifier that draws each challenge only
after the round's message, `phase_quadratic`, `phase_cubic` and
`liu_phase` run a whole phase under the Fiat-Shamir tape on the card
(the engines' `run_fs`), and `round_quadratic(prev_r)`,
`round_cubic(prev_r)` and `liu_round(prev_r)` one round at a time as
the JAX package does (any other tape that is not precomputable); the
host-int finalizes `finalize1`, `dotprod_finalize1`, `finalize2` and
`liu_finalize` follow either, and all of them accumulate `prove_time`.
"""

import time
from functools import wraps
from typing import List, Optional

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..field.ops import segment_sum_field
from ..circuit import Circuit, Layer, LayerType
from ..circuit.eval import two_mul_table
from ..circuit.ir import UNI_LU, UNI_SC, BIN_SC, BIN_L
from ..mle import beta_table, beta_table_2pt, phi_table
from ..mle.fold import mle_eval_dev
from .engine import Side, PhaseEngine, DotProdPhase1, _host, _fetch_ints
from .kernels import (p1_mult, p2_mult, p2_uni_add_term, gather_pad,
                      zero_region_scale, mul_outer_flat, contract_counts,
                      dotprod_p1_V0_gates, dotprod_p2_mult)

F_BYTE_SIZE = 32


def _timed(fn):
    """Accumulate wall time into prove_time (reference prove_timer,
    src/prover.cpp:33-35 etc.).  On the per-round path every round and
    finalize ends in a fetch, so the device work it queued is inside."""
    @wraps(fn)
    def wrap(self, *a, **k):
        t0 = time.perf_counter()
        r = fn(self, *a, **k)
        self.prove_time += time.perf_counter() - t0
        return r
    return wrap


class Prover:
    def __init__(self, C: Circuit, vals: List, own_vals: bool = False):
        self.C = C
        self.val = list(vals)
        self.device = vals[0].device
        # own_vals: the caller relinquishes the layer values, letting the
        # proof free each layer's tensor once its sumcheck consumed it
        self.own_vals = own_vals
        self.proof_size = 0
        self.prove_time = 0.0
        self.r_u: List[Optional[List[int]]] = [None] * (C.size + 1)
        self.r_v: List[Optional[List[int]]] = [None] * (C.size + 1)
        self.beta_g = None            # persistent cross-layer table
        self.V_u0 = 0
        self.V_u1 = 0
        self.tm = two_mul_table(self.device)
        self.sumcheck_id = C.size
        self._gates = {}              # layer id -> device gate split
        self._ori = {}                # layer id -> device subset maps

    def _beta(self, r, init=1):
        return beta_table(r, init, self.device)

    # ------------------------------------------------------------------

    @_timed
    def v_res(self, r_0: List[int]) -> int:
        """v_res_dev as a host int."""
        return _host(self.v_res_dev(r_0))

    def v_res_dev(self, r_0: List[int]):
        """Fold the output layer's MLE at the verifier's point
        (reference Vres, prover.cpp:434-457); [8] tensor."""
        self.proof_size += F_BYTE_SIZE
        return mle_eval_dev(self.val[self.C.size - 1], r_0)

    def sumcheck_init_all(self, r_0: List[int]):
        self.sumcheck_id = self.C.size
        self.r_u[self.C.size] = list(r_0)

    def sumcheck_init(self, alpha: int, beta: int):
        self.alpha, self.beta = alpha % FR_P, beta % FR_P
        self.r_0 = self.r_u[self.sumcheck_id]
        self.r_1 = self.r_v[self.sumcheck_id]
        self.sumcheck_id -= 1

    # ------------------------------------------------------------------
    # gate tensors

    @staticmethod
    def _gate_host(layer: Layer):
        """Host-side gate split by source class, computed once per
        layer: uni by input/previous source, bin by (u, v) source and,
        for the verifier's predicates, by source-layer code l."""
        uni, bi = layer.uni, layer.bin
        cache = {}

        def put(key, arr):
            cache[key] = np.ascontiguousarray(arr, np.int64)
            cache[key + "_n"] = arr.shape[0]

        put("uni0", uni[uni[:, UNI_LU] == 0])
        put("uni1", uni[uni[:, UNI_LU] != 0])
        u_in = bi[:, BIN_L] == 0
        v_in = (bi[:, BIN_L] & 1) == 0
        for ub in (0, 1):
            for vb in (0, 1):
                m = (u_in if ub == 0 else ~u_in) & \
                    (v_in if vb == 0 else ~v_in)
                sub = bi[m]
                put(f"bin{ub}{vb}", sub)
                cache[f"bin{ub}{vb}_sc0"] = bool((sub[:, BIN_SC] == 0).all())
                for lv in np.unique(sub[:, BIN_L]):
                    put(f"bin{ub}{vb}_l{int(lv)}", sub[sub[:, BIN_L] == lv])
        cache["uni0_sc0"] = bool((uni[uni[:, UNI_LU] == 0][:, UNI_SC]
                                  == 0).all())
        cache["uni1_sc0"] = bool((uni[uni[:, UNI_LU] != 0][:, UNI_SC]
                                  == 0).all())
        return cache

    def _ori_dev(self, lid: int):
        """Device ori_id_u/ori_id_v subset maps, kept for the whole proof
        (the Liu phase and the predicates read them after the layer)."""
        if lid not in self._ori:
            layer = self.C.layers[lid]
            self._ori[lid] = {
                k: torch.as_tensor(getattr(layer, a), dtype=torch.int64,
                                   device=self.device)
                if getattr(layer, a) is not None else None
                for k, a in (("ori_u", "ori_id_u"), ("ori_v", "ori_id_v"))}
        return self._ori[lid]

    def _gate_dev(self, lid: int):
        """Device copies of the layer's gate split (built on demand)."""
        if lid not in self._gates:
            cache = {}
            for key, arr in self._gate_host(self.C.layers[lid]).items():
                cache[key] = torch.as_tensor(arr, device=self.device) \
                    if isinstance(arr, np.ndarray) else arr
            cache.update(self._ori_dev(lid))
            self._gates[lid] = cache
        return self._gates[lid]

    def release_val(self, lid: int):
        """Drop layer lid's value tensor once its sumcheck has run when
        the prover owns the values (val[0] lives for the whole proof)."""
        if self.own_vals and lid > 0:
            self.val[lid] = None

    def release_gates(self, lid: int):
        """Drop a layer's device gate tensors once its prover and
        predicate work is done (rebuilt on demand)."""
        self._gates.pop(lid, None)

    # ------------------------------------------------------------------
    # phase 1 inits

    @_timed
    def sumcheck_init_phase1(self, relu_rou: int):
        lid = self.sumcheck_id
        cur = self.C.layers[lid]
        cache = self._gate_dev(lid)

        if cur.ty in (LayerType.FFT, LayerType.IFFT):
            fft_bl = cur.fft_bit_length
            fblh = fft_bl - 1
            if cur.ty == LayerType.FFT:
                cnt_bl = cur.bit_length - fft_bl
                cnt_len = cur.size >> fft_bl
                bg = beta_table_2pt(
                    self.r_0[fft_bl:fft_bl + cnt_bl],
                    self.r_1[:cnt_bl] if self.r_1 else None,
                    self.alpha, self.beta, self.device)
            else:
                cnt_bl = cur.bit_length - fblh
                cnt_len = cur.size >> fblh
                bg = self._beta(self.r_0[fblh:fblh + cnt_bl], self.alpha)
            self.beta_g = bg
            mbu = cur.max_bl_u
            prev = self.val[lid - 1][: cnt_len << mbu].reshape(
                cnt_len, 1 << mbu, FR.n)
            V1 = contract_counts(prev, bg[:cnt_len])
            mult1 = phi_table(self.r_0, cur.scale, fft_bl,
                              cur.ty == LayerType.IFFT, self.device)
            self.phase = PhaseEngine([None, Side(mult1, V1, mbu)])
            return

        # beta_g over the output hypercube
        if cur.ty == LayerType.PADDING:
            fblh = cur.fft_bit_length - 1
            eqf = self._beta(self.r_0[:fblh], 1)
            cnt = self.beta_g                     # stale table from FFT
            n_cnt = 1 << (cur.bit_length - fblh)
            bg = mul_outer_flat(cnt[:n_cnt], eqf)
        else:
            a = self.alpha * cur.scale % FR_P
            b = self.beta * cur.scale % FR_P
            bg = beta_table_2pt(self.r_0[:cur.bit_length],
                                self.r_1[:cur.bit_length] if self.r_1
                                else None, a, b, self.device)
        if cur.zero_start_id < cur.size:
            bg = zero_region_scale(bg, relu_rou, cur.zero_start_id)
        self.beta_g = bg

        val0 = self.val[0]
        prev = self.val[lid - 1]
        sides: List[Optional[Side]] = [None, None]
        for b in (0, 1):
            bl = cur.bit_length_u[b]
            if bl < 0:
                continue
            total = 1 << bl
            flags = (cache[f"uni{b}_sc0"], cache[f"bin{b}0_sc0"],
                     cache[f"bin{b}1_sc0"])
            mult = p1_mult(total, flags, bg, self.tm, cache[f"uni{b}"],
                           cache[f"bin{b}0"], cache[f"bin{b}1"],
                           cache["ori_v"], val0, prev)
            if b == 0:
                V = gather_pad(total, cache["ori_u"], val0)
            else:
                V = prev[:total]
            sides[b] = Side(mult, V, bl)
        self.phase = PhaseEngine(sides)

    @_timed
    def sumcheck_dotprod_init_phase1(self):
        lid = self.sumcheck_id
        cur = self.C.layers[lid]
        fft_bl = cur.fft_bit_length
        L = 1 << fft_bl
        nb1 = cur.bit_length_u[1]
        beta_gs = self._beta(self.r_0[:fft_bl], 1)
        prev = self.val[lid - 1]

        dp = getattr(cur, "dp_dims", None)
        if dp is not None:
            # structural path: V0[(p,ci),t] = sum_co beta[(p,co)] *
            # W[(co,ci),t] is one field matmul
            from ..field.matmul import field_matmul
            pic, co_n, ci_n = dp
            A = self.beta_g[: pic * co_n].reshape(pic, co_n, FR.n)
            W = prev[pic * ci_n * L: (pic + co_n) * ci_n * L].reshape(
                co_n, ci_n * L, FR.n)
            V0 = field_matmul(A, W).reshape(pic * ci_n * L, FR.n)
            pad = (1 << nb1) - V0.shape[0]
            if pad:
                V0 = torch.cat([V0, FR.zeros(pad, self.device)])
        else:
            gates = self._gate_dev(lid)["bin11"]   # DOT_PROD gates: l=1
            rows = prev[: (1 << nb1)].reshape(-1, L, FR.n)
            V0 = dotprod_p1_V0_gates(self.beta_g, rows, gates, 1 << nb1)
        V1 = prev[: 1 << nb1]
        self.phase = DotProdPhase1(beta_gs, V0, V1, fft_bl, nb1)

    # ------------------------------------------------------------------
    # rounds

    def run_rounds_quad(self, rs: List[int]):
        """All round polys of the current quadratic phase at the known
        challenges rs: a list of host-int 3-tuples."""
        polys = self.phase.run_all(rs)
        self.proof_size += F_BYTE_SIZE * 3 * len(rs)
        return polys

    def run_rounds_cubic(self, rs: List[int]):
        """As run_rounds_quad, 4-tuples.  The reference omits a zero
        cubic coefficient from the proof size (prover.cpp:137); that
        accounting is applied by account_cubic."""
        polys = self.phase.run_all(rs)
        self.proof_size += F_BYTE_SIZE * 3 * len(rs)
        return polys

    def account_cubic(self, polys_host: List[tuple]):
        """+1 field element per cubic round whose top coefficient is
        nonzero."""
        for p4 in polys_host:
            self.proof_size += F_BYTE_SIZE * (p4[3] != 0)

    @_timed
    def round_quadratic(self, prev_r: Optional[int]):
        """One round of the current quadratic phase: fold at the previous
        round's challenge (None in round 1), then the message."""
        poly = self.phase.round(prev_r)
        self.proof_size += F_BYTE_SIZE * 3
        return poly

    @_timed
    def round_cubic(self, prev_r: Optional[int]):
        """As round_quadratic, a 4-tuple; its top coefficient counts only
        when it is nonzero (reference prover.cpp:137)."""
        poly = self.phase.round(prev_r)
        self.proof_size += F_BYTE_SIZE * (3 + (poly[3] != 0))
        return poly

    @_timed
    def phase_quadratic(self, n: int, state: bytes, counter: int):
        """The current quadratic phase's n rounds under the Fiat-Shamir
        tape (state, counter) on the card, and its last fold: -> (round
        polys, the challenges drawn, the tape's state and counter after
        them), one fetch."""
        out = self.phase.run_fs(n, state, counter)
        self.proof_size += F_BYTE_SIZE * 3 * n
        return out

    @_timed
    def phase_cubic(self, n: int, state: bytes, counter: int):
        """As phase_quadratic, 4-tuples; a top coefficient counts only
        when it is nonzero (reference prover.cpp:137)."""
        out = self.phase.run_fs(n, state, counter)
        self.proof_size += F_BYTE_SIZE * sum(3 + (p[3] != 0)
                                             for p in out[0])
        return out

    # ------------------------------------------------------------------
    # finalizes

    def _last_fold(self, r_all: List[int]):
        """The per-round path's fold at the phase's last challenge, unless
        the phase ran whole (run_fs) and made it."""
        if r_all and not self.phase.received:
            self.phase.receive(r_all[-1])

    @_timed
    def finalize1(self, r_all: List[int]):
        """Host-int claims of phase 1 (per-round path); V_u0/V_u1 stay on
        the device as finalize1_dev leaves them."""
        self._last_fold(r_all)
        return tuple(_fetch_ints(self.finalize1_dev(r_all)))

    @_timed
    def dotprod_finalize1(self, r_all: List[int]) -> int:
        self._last_fold(r_all)
        return _fetch_ints(self.dotprod_finalize1_dev(r_all)[:1])[0]

    @_timed
    def finalize2(self, r_all: List[int]):
        self._last_fold(r_all)
        return tuple(_fetch_ints(self.finalize2_dev(r_all)))

    def finalize1_dev(self, r_all: List[int]):
        """[8] claims; V_u0/V_u1 stay on the device for the phase-2 init
        (reference prover.cpp:298-304)."""
        lid = self.sumcheck_id
        cur = self.C.layers[lid]
        self.r_u[lid] = list(r_all)
        claim_0 = self.phase.final_claim_dev(0, cur.bit_length_u[0])
        claim_1 = self.phase.final_claim_dev(1, cur.bit_length_u[1])
        self.V_u0, self.V_u1 = claim_0, claim_1
        self.proof_size += F_BYTE_SIZE * 2
        return claim_0, claim_1

    def dotprod_finalize1_dev(self, r_all: List[int]):
        """-> (claim_1 [8], V_u1 [8])."""
        self.r_u[self.sumcheck_id] = list(r_all)
        claim_1, v_u1 = self.phase.finalize_dev()
        self.V_u1 = v_u1
        self.proof_size += F_BYTE_SIZE
        return claim_1, v_u1

    def finalize2_dev(self, r_all: List[int]):
        lid = self.sumcheck_id
        cur = self.C.layers[lid]
        self.r_v[lid] = list(r_all)
        claim_0 = self.phase.final_claim_dev(0, cur.bit_length_v[0])
        claim_1 = self.phase.final_claim_dev(1, cur.bit_length_v[1])
        self.proof_size += F_BYTE_SIZE * 2
        return claim_0, claim_1

    # ------------------------------------------------------------------
    # phase 2 inits

    @_timed
    def sumcheck_init_phase2(self):
        lid = self.sumcheck_id
        cur = self.C.layers[lid]
        cache = self._gate_dev(lid)
        r_u = self.r_u[lid]

        if cur.ty == LayerType.DOT_PROD:
            fft_bl = cur.fft_bit_length
            L = 1 << fft_bl
            cnt_bl = cur.max_bl_v
            beta_u = self._beta(r_u[fft_bl:fft_bl + cnt_bl], 1)
            beta_gs = self._beta(r_u[:fft_bl], 1)
            nb1 = cur.bit_length_v[1]
            prev = self.val[lid - 1][: 1 << cur.bit_length_u[1]].reshape(
                -1, L, FR.n)
            mult1, V1 = dotprod_p2_mult(self.beta_g, beta_u, self.V_u1,
                                        cache["bin11"], 1 << nb1, prev,
                                        beta_gs)
            self.phase = PhaseEngine([None, Side(mult1, V1[: 1 << nb1],
                                                 nb1)])
            return

        beta_u = self._beta(r_u[:cur.max_bl_u], 1)
        add_term = 0
        # uni gates: beta_g[g]*beta_u[u]*V_u*tm[sc] summed into add_term
        vus = (self.V_u0, self.V_u1)
        for b, key in ((0, "uni0"), (1, "uni1")):
            uni = cache[key]
            if uni.shape[0]:
                t = p2_uni_add_term(self.beta_g, beta_u, self.tm, uni,
                                    vus[b])
                add_term = t if isinstance(add_term, int) \
                    else FR.add(add_term, t)

        val0 = self.val[0]
        prev = self.val[lid - 1]
        sides: List[Optional[Side]] = [None, None]
        for vb in (0, 1):
            bl = cur.bit_length_v[vb]
            if bl < 0:
                continue
            total = 1 << bl
            flags = (cache[f"bin0{vb}_sc0"], cache[f"bin1{vb}_sc0"])
            mult = p2_mult(total, flags, self.beta_g, beta_u, self.tm,
                           cache[f"bin0{vb}"], cache[f"bin1{vb}"],
                           vus[0], vus[1])
            if vb == 0:
                V = gather_pad(total, cache["ori_v"], val0)
            else:
                V = prev[:total]
            sides[vb] = Side(mult, V, bl)
        self.phase = PhaseEngine(sides, add_term=add_term)

    # ------------------------------------------------------------------
    # Liu input-consolidation phase (reference prover.cpp:312-358)

    def _liu_parts(self, sig_u: List[int], sig_v: List[int]):
        """(beta part, subset ids) per layer side: the beta table over
        the side's 2^bl subset slots, cut to the slots that exist."""
        for i in range(1, self.C.size):
            ly = self.C.layers[i]
            cache = self._ori_dev(i)
            for bl, key, rr, sig in (
                    (ly.bit_length_u[0], "ori_u", self.r_u[i],
                     sig_u[i - 1]),
                    (ly.bit_length_v[0], "ori_v", self.r_v[i],
                     sig_v[i - 1])):
                if bl < 0:
                    continue
                ori = cache[key]
                yield self._beta(rr[:bl], sig)[: ori.shape[0]], ori

    @_timed
    def sumcheck_liu_init(self, sig_u: List[int], sig_v: List[int]):
        self.sumcheck_id = 0
        c0 = self.C.layers[0]
        total = 1 << c0.bit_length
        pieces = list(self._liu_parts(sig_u, sig_v))
        mult = segment_sum_field(torch.cat([p for p, _ in pieces]),
                                 torch.cat([s for _, s in pieces]), total)
        V = self.val[0][:total]
        self.phase = PhaseEngine([None, Side(mult, V, c0.bit_length)],
                                 include_add_term=False)

    @_timed
    def liu_round(self, prev_r: Optional[int]):
        poly = self.phase.round(prev_r)
        self.proof_size += F_BYTE_SIZE * 3
        return poly

    liu_phase = phase_quadratic

    @_timed
    def liu_finalize(self, r_all: List[int]) -> int:
        self._last_fold(r_all)
        return _fetch_ints([self.liu_finalize_dev(r_all)])[0]

    def liu_finalize_dev(self, r_all: List[int]):
        self.r_u[0] = list(r_all)
        self.proof_size += F_BYTE_SIZE
        return self.phase.final_claim_dev(1, self.C.layers[0].bit_length)
