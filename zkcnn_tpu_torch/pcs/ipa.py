"""Log-round inner-product argument (Bulletproofs-style, non-ZK;
counterpart of `zkcnn_tpu/pcs/ipa.py`).

Compresses the Hyrax opening from sqrt-size to 2*log2(cols) G1 points
plus one scalar.

Statement: P = <b, G>, public x, claimed t = <b, x>.  With a
tape-derived auxiliary generator Q, set P* = P + t*Q and run the
standard halving rounds:

    L_k = <b_lo, G_hi> + <b_lo, x_hi> * Q
    R_k = <b_hi, G_lo> + <b_hi, x_lo> * Q
    c   = tape challenge
    b' = c*b_lo + c^-1*b_hi,  G' = c^-1*G_lo + c*G_hi,
    x' = c^-1*x_lo + c*x_hi,  P*' = c^2*L_k + P* + c^-2*R_k

ending with one scalar b0 and the check
    b0*G_final + (b0 * x_final)*Q == P*_final.

Same round messages (as group elements), same tape draws in the same
order and the same b0 as the JAX package.  What differs is how the
curve work is grouped, because on a CUDA device a launch of one term
and a launch of 512 take the same time (one thread's chain of
doublings): a round's L_k and R_k, Q terms included, are ONE two-row
MSM over the bases [G_hi, Q, G_lo, Q] with zeros where a row does not
reach; a fold of G is one scalar multiplication with a scalar a point;
and the verifier's P*_final and its final left-hand side are one MSM
each.  The prover's rounds fetch nothing from the device.
"""

from typing import List

import numpy as np
import torch

from ..field import FR
from ..field.params import FR_P
from . import curve
from .msm import FixedBaseMSM, points_equal


def _msm_small(points, scalars_mont):
    """<scalars, points> for Montgomery scalars [L, 8]."""
    return FixedBaseMSM(points).compute(scalars_mont[None])[0]


def _fold_scalars(v, c: int, cinv: int):
    """c*v_lo + c^-1*v_hi (Montgomery word vectors)."""
    n = v.shape[0] // 2
    return FR.lincomb2_scalar(v[:n], v[n:], FR.const(c, v.device),
                              FR.const(cinv, v.device))


def _fold_points(G, c: int, cinv: int):
    """c^-1*G_lo + c*G_hi."""
    n = G.shape[0] // 2
    sc = np.stack([FR.words_host(cinv)] * n + [FR.words_host(c)] * n)
    t = curve.scalar_mul(G, torch.from_numpy(sc).to(G.device))
    return curve.padd(t[:n], t[n:])


class IpaProof:
    def __init__(self):
        self.Ls: List = []
        self.Rs: List = []
        self.b0: int = 0


def _absorb_lr(tape, Lk, Rk):
    """Bind the round challenge to the round message (the standard
    Bulletproofs Fiat-Shamir requirement: challenges independent of
    L_k/R_k admit forgery).  Canonical affine encoding -- Jacobian
    words are malleable via Z-scaling.  Skipped for precomputable
    (interactive) tapes, whose absorb is a no-op by definition."""
    if not tape.precomputable:
        enc = curve.encode_points_host(torch.stack([Lk, Rk]))
        tape.absorb(int.from_bytes(enc, "little"))


def _round_messages(b, x, G, Q):
    """(L_k, R_k) of one round: row 0 is <b_lo, G_hi> + <b_lo, x_hi> Q,
    row 1 is <b_hi, G_lo> + <b_hi, x_lo> Q."""
    n = b.shape[0] // 2
    cl = FR.dot_mont(b[:n], x[n:])
    cr = FR.dot_mont(b[n:], x[:n])
    zeros = FR.zeros(n + 1, b.device)
    bases = torch.cat([G[n:], Q[None], G[:n], Q[None]])
    rows = torch.stack([torch.cat([b[:n], cl[None], zeros]),
                        torch.cat([zeros, b[n:], cr[None]])])
    return FixedBaseMSM(bases).compute(rows)


def ipa_prove(b, x, G, Q, t: int, tape) -> IpaProof:
    """b, x: [L, 8] Montgomery; G: [L, 3, 12]; Q: [3, 12]."""
    proof = IpaProof()
    while b.shape[0] > 1:
        Lk, Rk = _round_messages(b, x, G, Q)
        proof.Ls.append(Lk)
        proof.Rs.append(Rk)
        _absorb_lr(tape, Lk, Rk)
        c = tape.field()
        cinv = pow(c, FR_P - 2, FR_P)
        b = _fold_scalars(b, c, cinv)
        x = _fold_scalars(x, cinv, c)     # x folds with inverse roles
        G = _fold_points(G, c, cinv)
    proof.b0 = FR.from_mont_host(b[0].cpu().numpy())
    tape.absorb(proof.b0)
    return proof


def ipa_verify(proof: IpaProof, x, G, Q, P, t: int, tape) -> bool:
    """Recompute challenges from the same tape and check the final
    relation.  x: [L, 8]; G: [L, 3, 12]; P: commitment point to <b,G>."""
    L = x.shape[0]
    logn = L.bit_length() - 1
    assert len(proof.Ls) == logn
    dev = x.device
    chals = []
    for k in range(logn):
        _absorb_lr(tape, proof.Ls[k], proof.Rs[k])
        c = tape.field()
        chals.append((c, pow(c, FR_P - 2, FR_P)))
    tape.absorb(proof.b0)     # mirror the prover's transcript
    # P*_final = P + t Q + sum_k (c_k^2 L_k + c_k^-2 R_k)
    weights = [c * c % FR_P for c, _ in chals] \
        + [ci * ci % FR_P for _, ci in chals] + [t % FR_P, 1]
    P_star = _msm_small(
        torch.stack(proof.Ls + proof.Rs + [Q, P]),
        torch.from_numpy(FR.pack_mont_host(weights)).to(dev))
    # s_i = prod over rounds of (c_k if bit else c_k^-1); round k splits
    # on index bit (logn-1-k) from the top; the lo half takes the
    # inverse role.  G and x fold with the SAME orientation, so one
    # weight vector serves both.
    s = [1] * L
    for k, (c, cinv) in enumerate(chals):
        bit = 1 << (logn - 1 - k)
        for i in range(L):
            s[i] = s[i] * (c if (i & bit) else cinv) % FR_P
    # b0 G_final + (b0 x_final) Q with G_final = <s, G>, x_final = <s, x>
    sb = torch.from_numpy(FR.pack_mont_host(
        [si * proof.b0 % FR_P for si in s])).to(dev)
    lhs = _msm_small(torch.cat([G, Q[None]]),
                     torch.cat([sb, FR.dot_mont(sb, x)[None]]))
    return bool(points_equal(lhs, P_star).cpu())
