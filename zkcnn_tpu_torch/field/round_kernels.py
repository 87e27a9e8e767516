"""The sumcheck round kernels: CUDA wrappers and plain versions.

Counterparts of the JAX package's Pallas kernels (the CUDA source
`csrc/round_kernels.cu` says which kernel each replaces and why it is
shaped as it is).  A ladder runs R rounds at R challenges known
beforehand, with nothing returning to the host in between:

  * `round_ladder(A, V, rs) -> (dots [R, 4, 8], A_R, V_R)`: R quadratic
    sumcheck rounds.  Row j of dots is
    dots[j, 2x + y] = sum_i mont(A_j[2i+x], V_j[2i+y]), the value
    `FR.dot_mont` gives on the operands of round j, and each round folds
    X'_i = (1-r) X[2i] + r X[2i+1].
  * `fold_ladder(X, rs) -> X_R`: the same kernels with the dots compiled
    out.
  * `cubic_ladder(m, V0, V1, rs) -> (coeffs [R, 4, 8], m_R, V0_R,
    V1_R)`: R DOT_PROD phase-1 rounds (m is indexed modulo its row
    count and folds with the operands).
  * `fold(X, r)`: one fold alone (the fold ladder's R = 1 case).

A Fiat-Shamir sumcheck learns r_j only after round j's message, so its
rounds run in the other order, "fold at r_(j-1), then round j", one
launch a round:

  * `fold_round(A, V, r_prev) -> (dots [4, 8], A', V')`: A and V folded
    at r_prev, then the four pair dots of the folded rows; with
    r_prev=None (round 1) the dots of A and V as given, which come back
    unchanged.
  * `fold_cubic_round(m, V0, V1, r_prev) -> (coeffs [4, 8], m', V0',
    V1')`: m (while it has more than one row), V0 and V1 folded at
    r_prev, then c0..c3 of the folded operands.  When m' has one row,
    c3 = 0 and c0..c2 are m'[0] times the quadratic coefficients of
    (V1', V0').

Under Fiat-Shamir a whole phase runs as one launch sequence that the
host enqueues without waiting, the tape on the device (csrc/fs_tape.cuh):

  * `fold_round_phase(sides, n, add_term, include_add_term, state,
    counter) -> (buf, fin, keep)`: a quadratic phase of n rounds on up to
    two (A, V) sides of 2^nb rows (nb <= n), with the engine's add_term
    bookkeeping (PhaseEngine): round j's message is formed, absorbed and
    r_j drawn on the card, where the next launch folds at it; the phase
    ends with the fold at r_(n-1).  buf [HEAD_ROWS + 4 n, 8] is the phase
    buffer (`read_phase`: the tape's state and counter after the phase,
    add_term, r_0..r_(n-1), the messages); fin [2, 2, 8] each side's last
    A and V rows; keep the launches' scratch, which must live until buf
    is fetched.
  * `fold_cubic_round_phase(m, V0, V1, n, state, counter) -> (buf, fin,
    keep)`: a DOT_PROD phase 1 (V of 2^n rows) the same way, messages of
    four values; fin [3, 8] the last rows of m, V0, V1.

A phase call counts as one call of `fold_round` / `fold_cubic_round` in
`LAUNCHES`, its kernels in `KERNEL_LAUNCHES`, and its shape goes to
`PHASE_SHAPES` ((nb0, nb1, n, include) with nb = -1 for no
side; (K, M, n)).  Their plain versions are loops of the one-round plain
versions and the host's FiatShamirTape.

Outside a phase, challenges are host ints (the verifier's).  The device
tape's check entry `fs_tape_check` (not on any path) holds its absorb,
draw and reduction against the host.  A wrapper runs its plain
PyTorch version for a tensor on the CPU and launches the CUDA kernels
for a tensor on a CUDA device: there is no fallback from one to the
other.  Sizes go down to one pair; every output is a canonical residue,
equal bit for bit to the JAX package.

Counts, all set to 0 by `reset_launches`: `LAUNCHES` is the number of
calls of each wrapper that launched, `KERNEL_LAUNCHES` the device
kernels those calls launched, and `SHAPES` the shapes they launched at
((rows, R), or (K, M, R) for the cubic ones; R = 1 for `fold` and, for
the one-round entries, R = 1 with a fold and 0 without).
"""

import ctypes

import numpy as np
import torch

from .limbs import FR, N_WORDS
from .params import FR_P

NAMES = ("fold_round", "fold", "fold_cubic_round",
         "round_ladder", "fold_ladder", "cubic_ladder")
LAUNCHES = {k: 0 for k in NAMES}
KERNEL_LAUNCHES = {k: 0 for k in NAMES}
SHAPES = {k: set() for k in NAMES}
PHASE_SHAPES = {"fold_round": set(), "fold_cubic_round": set()}

# rows of a phase buffer's head (csrc/fs_tape.cuh): the tape's 64-byte
# state (two rows), its counter (row 2, words 0 and 1), add_term (row 3)
HEAD_ROWS = 4

_LIB = None


def reset_launches():
    for k in NAMES:
        LAUNCHES[k] = KERNEL_LAUNCHES[k] = 0
        SHAPES[k].clear()
    for shapes in PHASE_SHAPES.values():
        shapes.clear()


def _count(name: str, shape, kernels: int):
    """One wrapper call that launched `kernels` device kernels; shape:
    the one-round entries' and ladders' shape, None for a phase."""
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[name] += kernels
    if shape is not None:
        SHAPES[name].add(shape)


def _lib():
    global _LIB
    if _LIB is None:
        from ..cuda_build import load
        _LIB = load("round")
        if _LIB.zk_phase_head_words() != HEAD_ROWS * N_WORDS:
            raise RuntimeError("round kernels: the phase buffer's head "
                               "differs from HEAD_ROWS")
    return _LIB


# ---------------------------------------------------------------------
# the phase buffer


def phase_rows(n: int, k: int) -> int:
    """Rows of the buffer of a phase of n rounds, k values a message."""
    return HEAD_ROWS + n + k * n


def phase_head(state: bytes, counter: int, add_term: int) -> np.ndarray:
    """[HEAD_ROWS, 8] int32 words: the tape's state and counter, add_term
    in Montgomery form."""
    head = np.zeros((HEAD_ROWS, N_WORDS), np.uint32)
    head[:2] = np.frombuffer(state, "<u4").reshape(2, N_WORDS)
    head[2, :2] = counter & 0xFFFFFFFF, counter >> 32
    head[3] = FR.pack_mont_host([add_term])[0].view(np.uint32)
    return head.view(np.int32)


def read_phase(buf, n: int, k: int):
    """A fetched phase buffer -> (state bytes, counter, add_term, [r_j],
    [message tuples]) as host values."""
    words = np.ascontiguousarray(np.asarray(buf)).view(np.uint32)
    state = words[:2].astype("<u4").tobytes()
    counter = int(words[2, 0]) | int(words[2, 1]) << 32
    vals = FR.unpack_mont_host(words[3:].view(np.int32))
    rs = vals[1:1 + n]
    msgs = [tuple(vals[1 + n + k * j:1 + n + k * (j + 1)])
            for j in range(n)]
    return state, counter, vals[0], rs, msgs


def _host_tape(state: bytes, counter: int):
    from ..gkr.tape import FiatShamirTape
    tape = FiatShamirTape()
    tape.state, tape.counter = state, counter
    return tape


def _phase_buf(dev, tape, add_term, rs, msgs):
    head = phase_head(tape.state, tape.counter, add_term)
    body = FR.pack_mont_host(list(rs) + [c for m in msgs for c in m])
    return torch.from_numpy(np.concatenate([head, body])).to(dev)


# ---------------------------------------------------------------------
# plain versions


def fold_plain(X, r: int):
    """[2m, 8] -> [m, 8]: X'_i = (1-r) X_{2i} + r X_{2i+1}."""
    dev = X.device
    return FR.lincomb2_scalar(X[0::2], X[1::2], FR.const(1 - r, dev),
                              FR.const(r, dev))


def quad_dots_plain(A, V):
    """The four pair dots [4, 8]: D_xy = sum_i mont(A[2i+x], V[2i+y])."""
    a0, a1 = A[0::2], A[1::2]
    v0, v1 = V[0::2], V[1::2]
    return FR.dot_mont(torch.stack([a0, a0, a1, a1]),
                       torch.stack([v0, v1, v0, v1]))


def cubic_terms_plain(m, V1, V0):
    """The four cubic coefficients (c0..c3) [4, 8] of
    h(x) = sum_i (m0 + x dm)[i mod M/2] (a + x da)_i (b + x db)_i."""
    m0, dm = m[0::2], FR.sub(m[1::2], m[0::2])
    a, da = V1[0::2], FR.sub(V1[1::2], V1[0::2])
    b, db = V0[0::2], FR.sub(V0[1::2], V0[0::2])
    reps = a.shape[0] // m0.shape[0]
    m0t, dmt = m0.repeat(reps, 1), dm.repeat(reps, 1)
    e0 = FR.mul(a, b)
    e1 = FR.add(FR.mul(da, b), FR.mul(a, db))
    e2 = FR.mul(da, db)
    c0 = FR.dot_mont(m0t, e0)
    c1 = FR.add(FR.dot_mont(dmt, e0), FR.dot_mont(m0t, e1))
    c2 = FR.add(FR.dot_mont(dmt, e1), FR.dot_mont(m0t, e2))
    c3 = FR.dot_mont(dmt, e2)
    return torch.stack([c0, c1, c2, c3])


def fold_round_plain(A, V, r_prev):
    if r_prev is not None:
        A, V = fold_plain(A, r_prev), fold_plain(V, r_prev)
    return quad_dots_plain(A, V), A, V


def fold_cubic_round_plain(m, V0, V1, r_prev):
    if r_prev is not None:
        if m.shape[0] > 1:
            m = fold_plain(m, r_prev)
        V0, V1 = fold_plain(V0, r_prev), fold_plain(V1, r_prev)
    # one row of m: the pair (m0, m0) has dm = 0
    mm = m if m.shape[0] > 1 else torch.cat([m, m])
    return cubic_terms_plain(mm, V1, V0), m, V0, V1


def _host_ints(x) -> list:
    return FR.unpack_mont_host(np.asarray(x.cpu()))


def fold_round_phase_plain(sides, n: int, add_term, include_add_term: bool,
                           state: bytes, counter: int):
    """fold_round_phase's plain version: the rounds one at a time
    (fold_round_plain) with the engine's bookkeeping and the host tape."""
    dev = next(s[0].device for s in sides if s is not None)
    tape = _host_tape(state, counter)
    add = add_term if isinstance(add_term, int) else _host_ints(add_term)[0]
    cur = [None if s is None else (s[0], s[1], s[0].shape[0].bit_length() - 1)
           for s in sides]
    fin = FR.zeros(4, dev).reshape(2, 2, N_WORDS)
    rs, msgs = [], []
    for j in range(n):
        r_prev = rs[-1] if j else None
        if r_prev is not None and include_add_term:
            add = add * (1 - r_prev) % FR_P
        c = [0, 0, 0]
        for k, side in enumerate(cur):
            if side is None:
                continue
            A, V, nb = side
            if j < nb:
                dots, A, V = fold_round_plain(A, V, r_prev)
                cur[k] = (A, V, nb)
                d00, d01, d10, d11 = _host_ints(dots)
                c = [c[0] + d00, c[1] + d01 + d10 - 2 * d00,
                     c[2] + d11 - d01 - d10 + d00]
            else:                       # exhausted: joins add_term
                if r_prev is not None:
                    A, V = fold_plain(A, r_prev), fold_plain(V, r_prev)
                fin[k, 0], fin[k, 1] = A[0], V[0]
                a0, v0 = _host_ints(torch.stack([A[0], V[0]]))
                add = (add + a0 * v0) % FR_P
                cur[k] = None
        c0, c1, c2 = (x % FR_P for x in c)
        if include_add_term:
            c0, c1 = (c0 + add) % FR_P, (c1 - add) % FR_P
        msgs.append((c0, c1, c2))
        tape.absorb(c0, c1, c2)
        rs.append(tape.field())
    if include_add_term:
        add = add * (1 - rs[-1]) % FR_P
    for k, side in enumerate(cur):
        if side is not None:
            fin[k, 0] = fold_plain(side[0], rs[-1])[0]
            fin[k, 1] = fold_plain(side[1], rs[-1])[0]
    return _phase_buf(dev, tape, add, rs, msgs), fin, None


def fold_cubic_round_phase_plain(m, V0, V1, n: int, state: bytes,
                                 counter: int):
    """fold_cubic_round_phase's plain version: the rounds one at a time
    (fold_cubic_round_plain) with the host tape."""
    tape = _host_tape(state, counter)
    rs, msgs = [], []
    for j in range(n):
        c, m, V0, V1 = fold_cubic_round_plain(m, V0, V1,
                                              rs[-1] if j else None)
        msgs.append(tuple(_host_ints(c)))
        tape.absorb(*msgs[-1])
        rs.append(tape.field())
    if m.shape[0] > 1:
        m = fold_plain(m, rs[-1])
    V0, V1 = fold_plain(V0, rs[-1]), fold_plain(V1, rs[-1])
    fin = torch.cat([m[:1], V0[:1], V1[:1]])
    return _phase_buf(m.device, tape, 0, rs, msgs), fin, None


def fs_tape_check_plain(states, vals, counters, digests):
    """fs_tape_check's plain version, the host's FiatShamirTape: case i
    absorbs vals[i] ([k, 8] Montgomery) into states[i] ([16] words of the
    64-byte state), draws at counters[i] ([2] words, low first) and
    reduces digests[i] ([16] words of 64 bytes, a little-endian integer)
    mod p.  -> (states', r, counters', reduced)."""
    def words(x):
        return np.asarray(x.cpu()).view(np.uint32)

    st, vs, ctr, dg = (words(x) for x in (states, vals, counters, digests))
    out_st, out_r, out_ctr, out_red = [], [], [], []
    for i in range(st.shape[0]):
        tape = _host_tape(st[i].astype("<u4").tobytes(),
                          int(ctr[i, 0]) | int(ctr[i, 1]) << 32)
        tape.absorb(*FR.unpack_mont_host(vs[i].view(np.int32)))
        out_st.append(np.frombuffer(tape.state, "<u4"))
        out_r.append(tape.field())
        out_ctr.append([tape.counter & 0xFFFFFFFF, tape.counter >> 32])
        out_red.append(int.from_bytes(dg[i].astype("<u4").tobytes(),
                                      "little") % FR_P)
    dev = states.device

    def back(rows):
        return torch.from_numpy(
            np.asarray(rows, np.uint32).view(np.int32)).to(dev)

    return (back(out_st), torch.from_numpy(FR.pack_mont_host(out_r)).to(dev),
            back(out_ctr), torch.from_numpy(FR.pack_mont_host(out_red)).to(dev))


def round_ladder_plain(A, V, rs):
    dots = []
    for r in rs:
        dots.append(quad_dots_plain(A, V))
        A, V = fold_plain(A, r), fold_plain(V, r)
    return torch.stack(dots), A, V


def fold_ladder_plain(X, rs):
    for r in rs:
        X = fold_plain(X, r)
    return X


def cubic_ladder_plain(m, V0, V1, rs):
    coeffs = []
    for r in rs:
        coeffs.append(cubic_terms_plain(m, V1, V0))
        m, V0, V1 = fold_plain(m, r), fold_plain(V0, r), fold_plain(V1, r)
    return torch.stack(coeffs), m, V0, V1


# ---------------------------------------------------------------------
# CUDA wrappers


def _check_words(name, *xs):
    """Validates [rows, 8] int32 field words, contiguous, on one device;
    True when they lie on a CUDA device."""
    for x in xs:
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != N_WORDS:
            raise ValueError(f"{name}: expected [rows, 8] int32 field "
                             f"words, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operand must be contiguous")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: operands on different devices")
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _check(name, R, *xs):
    """Validates the operands of R halvings; True when they lie on a CUDA
    device."""
    if R < 1:
        raise ValueError(f"{name}: needs at least one round")
    on_cuda = _check_words(name, *xs)
    for x in xs:
        if x.shape[0] < (1 << R) or x.shape[0] % (1 << R):
            raise ValueError(f"{name}: the row count must be even and >= 2 "
                             f"in each of {R} halving(s), a positive "
                             f"multiple of {1 << R}; got {x.shape[0]}")
    return on_cuda


def _check_quad(name, R, A, V):
    on_cuda = _check(name, R, A, V)
    if A.shape != V.shape:
        raise ValueError(f"{name}: A {tuple(A.shape)} and V "
                         f"{tuple(V.shape)} differ")
    return on_cuda


def _check_cubic(name, R, m, V0, V1):
    on_cuda = _check(name, R, m, V0, V1)
    if V0.shape != V1.shape:
        raise ValueError(f"{name}: V0 {tuple(V0.shape)} and V1 "
                         f"{tuple(V1.shape)} differ")
    _check_m(name, m, V0)
    return on_cuda


def _check_m(name, m, V0, fold: bool = False):
    M, K = m.shape[0], V0.shape[0]
    if M > K or K % M:
        raise ValueError(f"{name}: need M | K and M <= K; got M={M}, K={K}")
    # m (folded when it has more than one row) must pair up or be one row
    Mf = M // 2 if fold and M > 1 else M
    if (fold and M > 1 and M % 2) or (Mf > 1 and Mf % 2):
        raise ValueError(f"{name}: m of {M} rows does not pair up")


def _check_fold_cubic(name, fold, m, V0, V1):
    on_cuda = _check_words(name, m, V0, V1)
    _check(name, 1 + fold, V0, V1)
    if V0.shape != V1.shape:
        raise ValueError(f"{name}: V0 {tuple(V0.shape)} and V1 "
                         f"{tuple(V1.shape)} differ")
    _check_m(name, m, V0, fold)
    return on_cuda


def _launch(fn, *args):
    rc = fn(*args)
    if rc:
        raise RuntimeError("CUDA launch failed: "
                           + _lib().zk_error_string(rc).decode())


def _rs_host(rs):
    """The challenges as one [R, 8] Montgomery array (one conversion) and
    its address; the C entries copy them into the kernels' parameters."""
    arr = FR.pack_mont_host(rs)
    return arr, arr.ctypes.data


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _empty(dev, *shape):
    return torch.empty(shape + (N_WORDS,), dtype=torch.int32, device=dev)


def _scratch(dev, nbytes):
    """A launch's device scratch of nbytes (None when it needs none: a
    ladder that is one tail launch, a round of one block) and its
    address."""
    if not nbytes:
        return None, None
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return buf, buf.data_ptr()


def _quad_ladder(name, A, V, rs):
    """R rounds on (A, V), or R folds of A alone when V is None."""
    R, dev, rows = len(rs), A.device, A.shape[0]
    lib = _lib()
    with_dots = V is not None
    out = _empty(dev, 1 + with_dots, rows >> R)
    dots = _empty(dev, R, 4) if with_dots else None
    rs_h, rs_ptr = _rs_host(rs)
    scratch, scratch_ptr = _scratch(
        dev, lib.zk_ladder_scratch_bytes(rows, 0, 1 + with_dots, R))
    n = ctypes.c_int(0)
    _launch(lib.zk_round_ladder, A.data_ptr(),
            V.data_ptr() if with_dots else None, out[0].data_ptr(),
            out[1].data_ptr() if with_dots else None,
            dots.data_ptr() if with_dots else None, rs_ptr,
            scratch_ptr, rows, R, int(with_dots), _stream(dev),
            ctypes.byref(n))
    _count(name, (rows, R), n.value)
    return dots, out[0], (out[1] if with_dots else None)


def _cubic_ladder(name, m, V0, V1, rs):
    R, dev = len(rs), m.device
    M, K = m.shape[0], V0.shape[0]
    lib = _lib()
    Vout = _empty(dev, 2, K >> R)
    m_out = _empty(dev, M >> R)
    coeffs = _empty(dev, R, 4)
    rs_h, rs_ptr = _rs_host(rs)
    scratch, scratch_ptr = _scratch(
        dev, lib.zk_ladder_scratch_bytes(K, M, 3, R))
    n = ctypes.c_int(0)
    _launch(lib.zk_cubic_ladder, m.data_ptr(), V0.data_ptr(), V1.data_ptr(),
            m_out.data_ptr(), Vout[0].data_ptr(), Vout[1].data_ptr(),
            coeffs.data_ptr(), rs_ptr, scratch_ptr, K, M, R, _stream(dev),
            ctypes.byref(n))
    _count(name, (K, M, R), n.value)
    return coeffs, m_out, Vout[0], Vout[1]


def round_ladder(A, V, rs):
    """R = len(rs) quadratic rounds: (dots [R, 4, 8], A_R, V_R)."""
    if not _check_quad("round_ladder", len(rs), A, V):
        return round_ladder_plain(A, V, rs)
    return _quad_ladder("round_ladder", A, V, rs)


def fold_ladder(X, rs):
    """R = len(rs) folds alone: [2^R m, 8] -> [m, 8]."""
    if not _check("fold_ladder", len(rs), X):
        return fold_ladder_plain(X, rs)
    return _quad_ladder("fold_ladder", X, None, rs)[1]


def cubic_ladder(m, V0, V1, rs):
    """R = len(rs) DOT_PROD phase-1 rounds:
    (coeffs [R, 4, 8], m_R, V0_R, V1_R)."""
    if not _check_cubic("cubic_ladder", len(rs), m, V0, V1):
        return cubic_ladder_plain(m, V0, V1, rs)
    return _cubic_ladder("cubic_ladder", m, V0, V1, rs)


def fold(X, r: int):
    """The fold alone: [2m, 8] -> [m, 8]."""
    if not _check("fold", 1, X):
        return fold_plain(X, r)
    return _quad_ladder("fold", X, None, [r])[1]


def fold_round(A, V, r_prev):
    """One Fiat-Shamir quadratic round, one launch: A and V folded at the
    previous round's challenge r_prev (None in round 1: no fold), then the
    four pair dots of the folded rows.  -> (dots [4, 8], A', V')."""
    with_fold = r_prev is not None
    if not _check_quad("fold_round", 1 + with_fold, A, V):
        return fold_round_plain(A, V, r_prev)
    dev, rows = A.device, A.shape[0]
    lib = _lib()
    dots = _empty(dev, 4)
    out = _empty(dev, 2, rows // 2) if with_fold else (A, V)
    r_h, r_ptr = _rs_host([r_prev]) if with_fold else (None, None)
    scratch, scratch_ptr = _scratch(
        dev, lib.zk_round_scratch_bytes(rows, int(with_fold)))
    n = ctypes.c_int(0)
    _launch(lib.zk_fold_round, A.data_ptr(), V.data_ptr(),
            out[0].data_ptr() if with_fold else None,
            out[1].data_ptr() if with_fold else None, dots.data_ptr(),
            r_ptr, scratch_ptr, rows, _stream(dev), ctypes.byref(n))
    _count("fold_round", (rows, int(with_fold)), n.value)
    return dots, out[0], out[1]


def fold_cubic_round(m, V0, V1, r_prev):
    """One Fiat-Shamir DOT_PROD phase-1 round, one launch: m (while it has
    more than one row), V0 and V1 folded at r_prev (None in round 1: no
    fold), then c0..c3 of the folded operands.
    -> (coeffs [4, 8], m', V0', V1')."""
    with_fold = r_prev is not None
    if not _check_fold_cubic("fold_cubic_round", with_fold, m, V0, V1):
        return fold_cubic_round_plain(m, V0, V1, r_prev)
    dev, M, K = m.device, m.shape[0], V0.shape[0]
    fold_m = with_fold and M > 1
    lib = _lib()
    coeffs = _empty(dev, 4)
    Vout = _empty(dev, 2, K // 2) if with_fold else (V0, V1)
    m_out = _empty(dev, M // 2) if fold_m else m
    r_h, r_ptr = _rs_host([r_prev]) if with_fold else (None, None)
    scratch, scratch_ptr = _scratch(
        dev, lib.zk_round_scratch_bytes(K, int(with_fold)))
    n = ctypes.c_int(0)
    _launch(lib.zk_fold_cubic_round, m.data_ptr(), V0.data_ptr(),
            V1.data_ptr(), m_out.data_ptr() if fold_m else None,
            Vout[0].data_ptr() if with_fold else None,
            Vout[1].data_ptr() if with_fold else None, coeffs.data_ptr(),
            r_ptr, scratch_ptr, K, M, _stream(dev), ctypes.byref(n))
    _count("fold_cubic_round", (K, M, int(with_fold)), n.value)
    return coeffs, m_out, Vout[0], Vout[1]


def _phase_sides(sides, n):
    """Validates a quadratic phase's sides: up to two (A, V) pairs or
    None, each of 2^nb rows with nb <= n; -> (the two sides, their nb, -1
    for none, and True when they lie on a CUDA device)."""
    sides = list(sides) + [None] * (2 - len(sides))
    if len(sides) != 2 or all(s is None for s in sides) or n < 1:
        raise ValueError("fold_round_phase: one or two sides and at least "
                         "one round")
    nbs = []
    for s in sides:
        if s is None:
            nbs.append(-1)
            continue
        rows = s[0].shape[0]
        if rows & (rows - 1) or rows.bit_length() - 1 > n \
                or s[1].shape != s[0].shape:
            raise ValueError(f"fold_round_phase: a side of {rows} rows for "
                             f"{n} rounds")
        nbs.append(rows.bit_length() - 1)
    ops = [x for s in sides if s is not None for x in s]
    return sides, nbs, _check_words("fold_round_phase", *ops)


def fold_round_phase(sides, n: int, add_term, include_add_term: bool,
                     state: bytes, counter: int):
    """A quadratic sumcheck phase of n rounds under the Fiat-Shamir tape
    (state, counter), one launch sequence with no host wait: one launch a
    round on more than TAIL_ROWS rows, then one tail.  add_term: a host
    int or an [8] Montgomery tensor on the card.  -> (buf, fin, keep), as
    the module docstring says."""
    sides, nbs, on_cuda = _phase_sides(sides, n)
    if not on_cuda:
        return fold_round_phase_plain(sides, n, add_term, include_add_term,
                                      state, counter)
    dev = next(s[0].device for s in sides if s is not None)
    lib = _lib()
    add_dev = None if isinstance(add_term, int) else add_term.contiguous()
    head = phase_head(state, counter, add_term if add_dev is None else 0)
    buf = _empty(dev, phase_rows(n, 3))
    fin = FR.zeros(4, dev).reshape(2, 2, N_WORDS)
    nb = (ctypes.c_int * 2)(*nbs)
    ops = (ctypes.c_void_p * 4)(*[None if s is None else x.data_ptr()
                                  for s in sides for x in s or (0, 0)])
    scratch, scratch_ptr = _scratch(dev, lib.zk_fold_round_phase_scratch(
        nb, n))
    k = ctypes.c_int(0)
    _launch(lib.zk_fold_round_phase, ops, nb, fin.data_ptr(),
            buf.data_ptr(), head.ctypes.data,
            add_dev.data_ptr() if add_dev is not None else None,
            scratch_ptr, n, int(include_add_term), _stream(dev),
            ctypes.byref(k))
    _count("fold_round", None, k.value)
    PHASE_SHAPES["fold_round"].add((*nbs, n, bool(include_add_term)))
    return buf, fin, (scratch, add_dev)


def fold_cubic_round_phase(m, V0, V1, n: int, state: bytes, counter: int):
    """A DOT_PROD phase 1 of n rounds under the Fiat-Shamir tape, one
    launch sequence: V0, V1 of 2^n rows, m of a power of two rows at most
    that.  -> (buf, fin, keep), as the module docstring says."""
    on_cuda = _check_fold_cubic("fold_cubic_round_phase", False, m, V0, V1)
    K, M = V0.shape[0], m.shape[0]
    if K != 1 << n or M & (M - 1):
        raise ValueError(f"fold_cubic_round_phase: V of {K} rows, m of {M}, "
                         f"for {n} rounds")
    if not on_cuda:
        return fold_cubic_round_phase_plain(m, V0, V1, n, state, counter)
    dev = m.device
    lib = _lib()
    head = phase_head(state, counter, 0)
    buf = _empty(dev, phase_rows(n, 4))
    fin = _empty(dev, 3)
    scratch, scratch_ptr = _scratch(
        dev, lib.zk_fold_cubic_round_phase_scratch(K, M, n))
    k = ctypes.c_int(0)
    _launch(lib.zk_fold_cubic_round_phase, m.data_ptr(), V0.data_ptr(),
            V1.data_ptr(), fin.data_ptr(), buf.data_ptr(), head.ctypes.data,
            scratch_ptr, K, M, n, _stream(dev), ctypes.byref(k))
    _count("fold_cubic_round", None, k.value)
    PHASE_SHAPES["fold_cubic_round"].add((K, M, n))
    return buf, fin, (scratch,)


def fs_tape_check(states, vals, counters, digests):
    """The device tape's check entry (not on any path): as
    fs_tape_check_plain, one thread a case on the card."""
    if not _check_words("fs_tape_check", states.reshape(-1, N_WORDS),
                        vals.reshape(-1, N_WORDS),
                        digests.reshape(-1, N_WORDS)):
        return fs_tape_check_plain(states, vals, counters, digests)
    n, dev = states.shape[0], states.device
    out = (torch.empty_like(states), _empty(dev, n),
           torch.empty_like(counters), _empty(dev, n))
    _launch(_lib().zk_fs_tape_check, states.data_ptr(), vals.data_ptr(),
            vals.shape[1], counters.data_ptr(), digests.data_ptr(),
            *(x.data_ptr() for x in out), n, _stream(dev))
    return out
