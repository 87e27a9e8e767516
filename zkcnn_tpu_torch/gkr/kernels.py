"""Per-layer sumcheck inits and the verifier's predicate evaluations
(counterpart of `zkcnn_tpu/gkr/kernels.py`).

Each function is one logical step as gathers, batched field muls and an
exact segment sum or dot.  Gate tensors are used at their exact size:
the JAX package pads them to power-of-two buckets with sentinel rows to
share compiled programs, which an eager port does not need, so no
sentinel index ever reaches a gather here.  The Liu phase's subset maps
are the one place where a table is longer than its index list; that
table is cut to the list (see prover._liu_parts).

The gate-chunk contract (the JAX package's `*_chunked` forms): the
inits, the predicates and `gr_term` take their gate tensors GATE_CHUNK
rows at a time, so that the gathers and the `FR.mul` temporaries (about
1 KB a row) stay bounded at vgg scale, where a gate list reaches 2^25
rows.  Each chunk adds its exact int64 limb columns into one
accumulator (`segment_add`, or the column sum of a dot) and one modular
finish closes the sum: the columns are exact and integer addition is
associative, so the result is word for word the unchunked one at any
chunk size.  A layer that fits in one chunk runs as one piece.
"""

import torch

from ..field import FR
from ..field.limbs import limbs16, words, N_LIMBS
from ..field.ops import segment_cols, segment_add, segment_finish, \
    segment_sum_field
from ..circuit.ir import UNI_G, UNI_U, UNI_SC, BIN_G, BIN_U, BIN_V, BIN_SC

GATE_CHUNK = 1 << 19   # gate rows a step at a time (read at call time)


def _chunks(gates):
    """Windows of GATE_CHUNK rows of a [G, k] gate tensor."""
    step = GATE_CHUNK
    for s in range(0, gates.shape[0], step):
        yield gates[s:s + step]


def _cols(device):
    """A [16] int64 column accumulator of a modular sum."""
    return torch.zeros(N_LIMBS, dtype=torch.int64, device=device)


def _add_cols(cols, x):
    """cols += the limb columns of the rows of x [n, 8], in place."""
    return cols.add_(limbs16(x).sum(dim=-1))


def _finish_cols(cols):
    """The canonical [8] Montgomery sum the columns hold (the finish of
    `FR.sum` and `FR.dot_mont`)."""
    return words(FR.mont_sum_cols(cols))


def p1_mult(total: int, sc0_flags, bg, tm, uni, bin_v0, bin_v1, ori_v,
            val0, prev):
    """Phase-1 mult_array for one u-side (reference prover.cpp:224-233):
    mult[u] += beta_g[g]*two_mul[sc] (uni) and += beta_g[g]*V_v*tm[sc]
    (bin), one exact modular segment sum over every gate chunk (JAX
    `p1_mult`, `p1_mult_chunked`).  sc0_flags: (uni_sc0, b_v0_sc0,
    b_v1_sc0) -- a class whose constants are all two_mul[0] = 1 skips
    the multiply."""
    acc = segment_cols(total, bg.device)
    for ch in _chunks(uni):
        c = bg[ch[:, UNI_G]]
        if not sc0_flags[0]:
            c = FR.mul(c, tm[ch[:, UNI_SC]])
        segment_add(acc, c, ch[:, UNI_U])
    for vb, gates in ((0, bin_v0), (1, bin_v1)):
        for ch in _chunks(gates):
            if vb == 0:
                vals = val0[ori_v[ch[:, BIN_V]]]
            else:
                vals = prev[ch[:, BIN_V]]
            c = FR.mul(vals, bg[ch[:, BIN_G]])
            if not sc0_flags[1 + vb]:
                c = FR.mul(c, tm[ch[:, BIN_SC]])
            segment_add(acc, c, ch[:, BIN_U])
    return segment_finish(acc)


def p2_mult(total: int, sc0_flags, bg, beta_u, tm, bin_u0, bin_u1, vu0,
            vu1):
    """Phase-2 mult_array for one v-side (reference prover.cpp:286-305):
    mult[v] += beta_g[g]*beta_u[u]*V_u[ub]*tm[sc], over every gate chunk
    (JAX `p2_mult`, `p2_mult_chunked`)."""
    acc = segment_cols(total, bg.device)
    for ub, gates, vu in ((0, bin_u0, vu0), (1, bin_u1, vu1)):
        for ch in _chunks(gates):
            c = FR.mul(bg[ch[:, BIN_G]], beta_u[ch[:, BIN_U]])
            if not sc0_flags[ub]:
                c = FR.mul(c, tm[ch[:, BIN_SC]])
            segment_add(acc, FR.mul(c, vu), ch[:, BIN_V])
    return segment_finish(acc)


def p2_uni_add_term(bg, beta_u, tm, uni, vu):
    """Phase-2 uni-gate contribution to add_term (prover.cpp:286-291):
    sum_g beta_g[g]*beta_u[u]*tm[sc]*V_u, over every gate chunk (JAX
    `p2_uni_add_term`, `p2_uni_add_term_chunked`)."""
    cols = _cols(bg.device)
    for ch in _chunks(uni):
        c = FR.mul(bg[ch[:, UNI_G]], beta_u[ch[:, UNI_U]])
        c = FR.mul(c, tm[ch[:, UNI_SC]])
        _add_cols(cols, FR.mul(c, vu))
    return _finish_cols(cols)


def gather_pad(total: int, ori, val0):
    """V-operand for an input-subset side: val0[ori], zero-padded to
    total rows (reference getCirValue at lu==0, prover.cpp:499-501)."""
    V = val0[ori[:total]]
    if V.shape[0] < total:
        V = torch.cat([V, FR.zeros(total - V.shape[0], V.device)])
    return V


def zero_region_scale(bg, relu_rou: int, zero_start: int):
    """Scale the >= zero_start region by relu_rou (prover.cpp:221-222,
    verifier.cpp:76-78)."""
    head = bg[:zero_start]
    tail = FR.mul(bg[zero_start:], FR.const(relu_rou, bg.device))
    return torch.cat([head, tail])


def mul_outer_flat(a, b):
    """[A, 8] x [B, 8] -> [A*B, 8] products (PADDING beta cross table,
    prover.cpp:214-219 / verifier.cpp:81-88)."""
    return FR.mul(a[:, None, :], b[None, :, :]).reshape(
        a.shape[0] * b.shape[0], FR.n)


def contract_counts(prev, bg):
    """FFT/IFFT phase-1 V: contract count dims (prover.cpp:185-197):
    prev [cnt, L, 8] dot bg [cnt, 8] over cnt -> [L, 8]."""
    return FR.dot_mont(prev, bg[:, None, :], axis=0)


def pred_uni(bg, beta_u, tm, uni):
    """Verifier predicatePhase1 uni term (verifier.cpp:89-102):
    sum beta_g[g]*tm[sc]*beta_u[u], over every gate chunk (JAX
    `pred_uni`, `pred_uni_chunked`)."""
    cols = _cols(bg.device)
    for ch in _chunks(uni):
        c = FR.mul(bg[ch[:, UNI_G]], tm[ch[:, UNI_SC]])
        _add_cols(cols, FR.mul(c, beta_u[ch[:, UNI_U]]))
    return _finish_cols(cols)


def pred_bin(use_tm: bool, bg, beta_u, beta_v, tm, gates):
    """Verifier predicatePhase2 bin term for one (ub, vb, l) gate group
    (verifier.cpp:104-116): sum beta_g[g]*beta_u[u]*tm[sc]*beta_v[v],
    over every gate chunk (JAX `pred_bin`, `pred_bin_chunked`)."""
    cols = _cols(bg.device)
    for ch in _chunks(gates):
        c = FR.mul(bg[ch[:, BIN_G]], beta_u[ch[:, BIN_U]])
        if use_tm:
            c = FR.mul(c, tm[ch[:, BIN_SC]])
        _add_cols(cols, FR.mul(c, beta_v[ch[:, BIN_V]]))
    return _finish_cols(cols)


def gr_term(beta_g, ori, bu):
    """Liu-phase subset predicate term (verifier.cpp:307-333):
    sum_j beta_g[ori[j]] * bu[j] over the subset, GATE_CHUNK ids at a
    time."""
    cols = _cols(beta_g.device)
    step = GATE_CHUNK
    for s in range(0, ori.shape[0], step):
        ids = ori[s:s + step]
        _add_cols(cols, FR.mul(beta_g[ids], bu[s:s + ids.shape[0]]))
    return _finish_cols(cols)


def dotprod_p1_V0_gates(bg, prev_rows, gates, total_rows: int):
    """DOT_PROD phase-1 per-gate V0 build (prover.cpp:57-101, for
    circuits without structural dims): V0[u*L+t] += beta_g[g] *
    prev[v*L+t]."""
    L = prev_rows.shape[1]
    coef = bg[gates[:, BIN_G]]
    rows = prev_rows[gates[:, BIN_V]]
    contrib = FR.mul(coef[:, None, :], rows)
    seg = gates[:, BIN_U][:, None] * L + torch.arange(L, device=bg.device)
    return segment_sum_field(contrib.reshape(-1, FR.n), seg.reshape(-1),
                             total_rows)


def dotprod_p2_mult(bg, beta_u, vu1, gates, total: int, prev, beta_gs):
    """DOT_PROD phase-2 (prover.cpp:272-305): V1 = contract prev rows
    with the fft beta table; mult1[v] += beta_g[g]*beta_u[u]*V_u1."""
    V1 = FR.dot_mont(prev, beta_gs[None, :, :], axis=1)
    c = FR.mul(FR.mul(bg[gates[:, BIN_G]], beta_u[gates[:, BIN_U]]), vu1)
    mult1 = segment_sum_field(c, gates[:, BIN_V], total)
    return mult1, V1
