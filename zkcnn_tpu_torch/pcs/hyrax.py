"""Hyrax polynomial commitment, square-root matrix form (counterpart of
`zkcnn_tpu/pcs/hyrax.py`).

  * gens are |cols| = 2^(logn - logn//2) G1 points: tape-drawn s_i*G in
    the interactive model, where the prover cannot grind the verifier's
    randomness, but hash-to-curve points with unknown discrete logs for
    a Fiat-Shamir tape, where tape-derived scalars would be known to
    the prover and break binding;
  * the prover arranges the padded input MLE as a rows x cols matrix
    and Pedersen-commits every row (one MSM a row, batched);
  * opening at point r: the verifier folds the row commitments with
    eq(row, r_hi) into a single commitment T'; the prover sends the
    equally-folded scalar row b (or an IPA compressing it); the
    verifier checks <b, gens> == T' and <b, eq(r_lo)> == eval.

Prover/verifier split: open() produces a self-contained SqrtProof /
IpaProof from the witness; verify() consumes ONLY public data (the
commitment, the point, the claimed eval, the proof).

This is the transparent non-ZK variant.  Everything runs on the device
given to `setup`; the timings `pt` and `vt` are read after the device
has finished its work.  `setup` builds the generators' fixed-base table
(`FixedBaseMSM`), as the JAX package does, outside `pt`; its seconds
are `table_s`.  The inner-product opening reuses that table (it adds
Q's); every table the opening and the verifier build for their own
bases is inside `pt` or `vt`.
"""

import time
from typing import List

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from ..mle import beta_table
from . import curve
from .ipa import ipa_prove, ipa_verify
from .msm import FixedBaseMSM, points_equal

F_BYTE_SIZE = 32
G_BYTE_SIZE = 48


class SqrtProof:
    """The folded matrix row b ([n_cols, 8] Montgomery words, numpy)."""

    def __init__(self, b):
        self.b = b


class HyraxPCS:
    """mode="ipa" (default): Bulletproofs-style log-round inner-product
    argument (2 log2(cols) G1 points + 1 scalar) -- logarithmic POLY_PS.
    mode="sqrt": prover sends the folded row b directly (sqrt-size
    proof, cheapest verify)."""

    def __init__(self, mode: str = "ipa"):
        assert mode in ("sqrt", "ipa")
        self.mode = mode
        self.pt = 0.0   # prover seconds
        self.commit_s = 0.0   # the share of pt spent in commit()
        self.table_s = 0.0   # setup's table of the generators, not in pt
        self.vt = 0.0   # verifier seconds
        self.ps = 0     # proof bytes

    def _clock(self) -> float:
        """The host clock once the device has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def setup(self, bit_length: int, tape, device):
        """Generators: tape-drawn in the interactive model; hash-to-curve
        (unknown discrete logs) for Fiat-Shamir tapes -- see module
        docstring."""
        self.device = torch.device(device)
        self.logn = bit_length
        self.l_col = bit_length - (bit_length >> 1)
        self.n_cols = 1 << self.l_col
        self.n_rows = 1 << (bit_length >> 1)
        if tape.precomputable:
            self.gens = self._tape_gens(tape.fields(self.n_cols))
        else:
            pts = [curve.hash_to_group_host(b"zkcnn-hyrax-gen", i)
                   for i in range(self.n_cols)]
            self.gens = torch.from_numpy(curve.affine_pack(pts)).to(
                self.device)
        t0 = self._clock()
        self.gen_msm = FixedBaseMSM(self.gens)
        self.table_s = self._clock() - t0

    def _matrix(self, val0):
        if val0.shape[0] < self.n_rows * self.n_cols:
            raise ValueError(f"the committed layer holds {val0.shape[0]} "
                             f"values, fewer than 2^{self.logn}")
        return val0[: self.n_rows * self.n_cols].reshape(
            self.n_rows, self.n_cols, FR.n)

    def commit(self, val0):
        """Pedersen-commit each matrix row: [n_rows] G1 points."""
        t0 = self._clock()
        self.row_commits = self.gen_msm.compute(self._matrix(val0))
        dt = self._clock() - t0
        self.commit_s += dt
        self.pt += dt
        self.ps += self.n_rows * G_BYTE_SIZE
        return self.row_commits

    # ------------------------------------------------------------------
    # prover side

    def open(self, val0, r: List[int], eval_in: int, tape):
        """Produce the opening proof at point r from the witness."""
        t0 = self._clock()
        eq_hi = beta_table(r[self.l_col:], 1, self.device)   # [n_rows, 8]
        b = FR.dot_mont(self._matrix(val0), eq_hi[:, None, :], axis=0)
        self.pt += self._clock() - t0
        if self.mode == "sqrt":
            self.ps += self.n_cols * F_BYTE_SIZE
            return SqrtProof(b.cpu().numpy())
        Q = self._aux_gen(tape)
        eq_lo = beta_table(r[: self.l_col], 1, self.device)
        t0 = self._clock()
        proof = ipa_prove(b, eq_lo, self.gen_msm, Q, eval_in, tape)
        self.pt += self._clock() - t0
        self.ps += len(proof.Ls) * 2 * G_BYTE_SIZE + F_BYTE_SIZE
        return proof

    def _tape_gens(self, scalars):
        """s_i*G for tape-drawn scalars: one scalar multiplication over
        all of them (on a CUDA device one kernel launch; on the CPU
        Python integers on the host, which give the same POINTS with
        Z = 1 -- encodings and points_equal do not depend on the
        representation, so transcripts do not change)."""
        plain = torch.from_numpy(np.stack(
            [FR.words_host(s) for s in scalars])).to(self.device)
        return curve.scalar_mul(curve.base_point(self.device), plain)

    def _aux_gen(self, tape):
        """The IPA's auxiliary generator Q: tape-drawn (interactive) or
        hash-to-curve (Fiat-Shamir), same rationale as setup()."""
        if tape.precomputable:
            return self._tape_gens([tape.field()])[0]
        P = curve.hash_to_group_host(b"zkcnn-hyrax-gen-Q", 0)
        return torch.from_numpy(curve.affine_pack([P])[0]).to(self.device)

    # ------------------------------------------------------------------
    # verifier side (public data only: commitment, r, eval, proof)

    def verify(self, commitment, r: List[int], eval_in: int, proof,
               tape) -> bool:
        eq_lo = beta_table(r[: self.l_col], 1, self.device)
        eq_hi = beta_table(r[self.l_col:], 1, self.device)
        if self.mode == "sqrt":
            t0 = self._clock()
            b = torch.from_numpy(np.asarray(proof.b)).to(self.device)
            eval_got = FR.from_mont_host(
                FR.dot_mont(b, eq_lo).cpu().numpy())
            if eval_got != eval_in % FR_P:
                return False
            t_fold = FixedBaseMSM(commitment).compute(eq_hi[None])[0]
            lhs = self.gen_msm.compute(b[None])[0]
            ok = bool(points_equal(lhs, t_fold).cpu())
            self.vt += self._clock() - t0
            return ok
        Q = self._aux_gen(tape)
        t0 = self._clock()
        P = FixedBaseMSM(commitment).compute(eq_hi[None])[0]
        ok = ipa_verify(proof, eq_lo, self.gen_msm, Q, P, eval_in, tape)
        self.vt += self._clock() - t0
        return ok

    def open_and_verify(self, commitment, val0, r: List[int],
                        eval_in: int, tape) -> bool:
        """Prove + verify with prover and verifier consuming identical
        challenge sequences (verifier replays a tape snapshot)."""
        vtape = tape.clone()
        proof = self.open(val0, r, eval_in, tape)
        return self.verify(commitment, r, eval_in, proof, vtape)
