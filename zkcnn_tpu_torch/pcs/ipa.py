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
and a launch of 512 take about the same time (one thread's chain of
doublings: the table chain of a base, or a windowed scalar
multiplication).  The JAX package folds G by a scalar multiplication
every round; the port never folds G.  After k rounds generator i is a
combination of the original ones,

    G^(k)_i = sum over m = i (mod n_k) of s^(k)_m G_m,
    s^(k)_m = prod over j < k of (c_j if bit (logn-1-j) of m else c_j^-1),

the prefix of the verifier's own weight vector, so round k's L_k and
R_k, Q terms included, are ONE two-row MSM over the original generators
and Q: row 0 holds b[(m mod n_k) - n_k/2] s_m on the bases m whose bit
(logn-1-k) is set, row 1 b[(m mod n_k) + n_k/2] s_m on the others, and
the Q column (<b_lo, x_hi>, <b_hi, x_lo>).  The generators' table is the
setup's (`HyraxPCS.gen_msm`); the opening builds Q's table once and
joins it (`FixedBaseMSM.extend`), so no round runs a chain of
doublings.  The rest of a round is one launch of kernel `ipa_round`
(csrc/g1_kernels.cu): it folds b and x at c_(k-1), forms the Q column
<b_lo, x_hi>, <b_hi, x_lo> of the folded vectors, multiplies the weights
s (which stay on the device) by c_(k-1) or c_(k-1)^-1 by index bit and
writes the two rows.  Its plain version `ipa_round_plain` (`_fold_scalars`
twice, `FR.dot_mont` twice and the rows' gathers: about a thousand small
launches on the card) runs on the CPU.  The host draws c_k from the tape
(under a Fiat-Shamir tape after absorbing L_k and R_k, which waits for
the MSM); b0 is the fold of the last round's two words, made on the
host after the opening's one fetch.  `ipa_prove_by_folds` is the
fold-based prover (a round's table of [G_hi, Q, G_lo, Q], a fold of G by
scalar multiplication), kept as the reference that the opening is held
against.  The verifier's final check is one MSM on the generators' table
(the setup's) and one over [L_k, R_k, Q, P].
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


def _reweigh(s, n: int, c: int, cinv: int):
    """The weights after round k (of n_k = n terms) from those before it:
    times c where the bit n/2 of the index is set, c^-1 elsewhere --
    ipa_verify's orientation."""
    dev = s.device
    m = torch.arange(s.shape[0], device=dev)
    hi = ((m & (n >> 1)) != 0)[:, None]
    return FR.mul(s, torch.where(hi, FR.const(c, dev), FR.const(cinv, dev)))


def ipa_round_plain(b, x, s, prev):
    """Round k of the opening in plain PyTorch: (rows, s, b, x), the two
    MSM rows over [G; Q] (the original generators, then Q) [2, L + 1, 8],
    the weights s^(k) [L, 8] and the folded b, x [n_k, 8], all
    Montgomery.  prev: the round before's (c, c^-1) as integers, and then
    b, x hold 2 n_k words that fold first and s is s^(k-1); None in round
    0 (no fold; s is s^(0)).  Base m takes b at its partner index
    (m mod n_k) XOR n_k/2, times s_m, in row 0 where its bit (logn-1-k)
    (the bit n_k/2) is set, else in row 1; the Q column is
    (<b_lo, x_hi>, <b_hi, x_lo>)."""
    curve.PLAIN_CALLS["ipa_round"] += 1
    if prev is not None:
        c, cinv = prev
        b = _fold_scalars(b, c, cinv)
        x = _fold_scalars(x, cinv, c)     # x folds with inverse roles
        s = _reweigh(s, 2 * b.shape[0], c, cinv)
    n, L = b.shape[0], s.shape[0]
    h = n // 2
    cl = FR.dot_mont(b[:h], x[h:])
    cr = FR.dot_mont(b[h:], x[:h])
    m = torch.arange(L, device=b.device)
    hi = ((m & h) != 0)[:, None]
    w = FR.mul(b[(m & (n - 1)) ^ h], s)
    zero = torch.zeros_like(w)
    rows = torch.stack([
        torch.cat([torch.where(hi, w, zero), cl[None]]),
        torch.cat([torch.where(hi, zero, w), cr[None]])])
    return rows, s, b, x


def ipa_round(b, x, s, prev):
    """`ipa_round_plain`'s function: on a CUDA device one launch of
    kernel ipa_round (csrc/g1_kernels.cu), whose one block takes at most
    `zk_ipa_max_l()` generators; on the CPU the plain version."""
    m, L = b.shape[0], s.shape[0]
    for t, shape in ((b, (m, FR.n)), (x, (m, FR.n)), (s, (L, FR.n))):
        if t.dtype != torch.int32 or t.shape != shape \
                or t.device != b.device:
            raise ValueError(f"ipa_round: expected int32 {shape} words "
                             f"on {b.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    n = m // 2 if prev is not None else m
    if n < 2 or n > L or m & (m - 1) or L & (L - 1):
        raise ValueError(f"ipa_round: {m} terms of {L} generators "
                         f"({'a fold' if prev else 'no fold'})")
    if b.device.type != "cuda":
        return ipa_round_plain(b, x, s, prev)
    lib = curve.g1_lib()
    if L > lib.zk_ipa_max_l():
        raise ValueError(f"ipa_round: {L} generators; the kernel takes at "
                         f"most {lib.zk_ipa_max_l()}")
    rows = torch.empty((2, L + 1, FR.n), dtype=torch.int32, device=b.device)
    b, x, s = b.contiguous(), x.contiguous(), s.contiguous()
    chal, (s_out, b_out, x_out) = None, (s, b, x)   # round 0: rows alone
    if prev is not None:
        chal = FR.pack_mont_host(prev)     # read by value at the launch
        s_out, b_out, x_out = (torch.empty_like(s), torch.empty_like(b[:n]),
                               torch.empty_like(x[:n]))
    curve.launch(b.device, lib.zk_ipa_round, b.data_ptr(), x.data_ptr(),
                 s.data_ptr(), s_out.data_ptr(),
                 None if chal is None else chal.ctypes.data, b_out.data_ptr(),
                 x_out.data_ptr(), rows.data_ptr(), L, n,
                 curve.stream_of(b.device))
    curve.count_launch("ipa_round", (L, n))
    return rows, s_out, b_out, x_out


def ipa_prove(b, x, gen_msm: FixedBaseMSM, Q, t: int, tape) -> IpaProof:
    """b, x: [L, 8] Montgomery; gen_msm: the setup's FixedBaseMSM over
    the L generators; Q: [3, 12].  A round is one ipa_round and one MSM
    on [G; Q]; the one fetch is the last round's b."""
    proof = IpaProof()
    L, prev = b.shape[0], None
    if L == 1:
        proof.b0 = FR.from_mont_host(b[0].cpu().numpy())
    else:
        msm = gen_msm.extend(Q[None])
        s = FR.const(1, b.device).expand(L, FR.n).contiguous()
        for _ in range(L.bit_length() - 1):
            rows, s, b, x = ipa_round(b, x, s, prev)
            Lk, Rk = msm.compute(rows)
            proof.Ls.append(Lk)
            proof.Rs.append(Rk)
            _absorb_lr(tape, Lk, Rk)
            c = tape.field()
            prev = (c, pow(c, FR_P - 2, FR_P))
        lo, hi = FR.unpack_mont_host(b.cpu().numpy())
        proof.b0 = (prev[0] * lo + prev[1] * hi) % FR_P
    tape.absorb(proof.b0)
    return proof


def ipa_prove_by_folds(b, x, G, Q, t: int, tape) -> IpaProof:
    """The fold-based prover, the reference `ipa_prove` is held against:
    G: [L, 3, 12], folded every round; the same proof."""
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


def weights_host(chals, L: int) -> List[int]:
    """The weight vector after the rounds of challenges (c, c^-1):
    s_i = prod over rounds of (c_k if bit else c_k^-1); round k splits
    on index bit (logn-1-k) from the top; the lo half takes the inverse
    role.  G and x fold with the SAME orientation, so one weight vector
    serves both."""
    logn = L.bit_length() - 1
    s = [1] * L
    for k, (c, cinv) in enumerate(chals):
        bit = 1 << (logn - 1 - k)
        for i in range(L):
            s[i] = s[i] * (c if (i & bit) else cinv) % FR_P
    return s


def ipa_verify(proof: IpaProof, x, G, Q, P, t: int, tape) -> bool:
    """Recompute challenges from the same tape and check the final
    relation.  x: [L, 8]; G: the generators, [L, 3, 12] or a
    FixedBaseMSM over them (the setup's, whose table is public); P:
    commitment point to <b,G>."""
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
    s = weights_host(chals, L)
    # The check b0 G_final + (b0 x_final) Q == P*_final, with G_final =
    # <s, G>, x_final = <s, x> and P*_final = P + t Q + sum_k (c_k^2 L_k +
    # c_k^-2 R_k), as <b0 s, G> == P + (t - b0 x_final) Q + sum_k (...):
    # the left side on the generators' table, the right side one MSM.
    sb = torch.from_numpy(FR.pack_mont_host(
        [si * proof.b0 % FR_P for si in s])).to(dev)
    weights = torch.from_numpy(FR.pack_mont_host(
        [c * c % FR_P for c, _ in chals]
        + [ci * ci % FR_P for _, ci in chals] + [t % FR_P, 1])).to(dev)
    weights[-2] = FR.sub(weights[-2], FR.dot_mont(sb, x))
    rhs = _msm_small(torch.stack(proof.Ls + proof.Rs + [Q, P]), weights)
    gen_msm = G if isinstance(G, FixedBaseMSM) else FixedBaseMSM(G)
    lhs = gen_msm.compute(sb[None])[0]
    return bool(points_equal(lhs, rhs).cpu())
