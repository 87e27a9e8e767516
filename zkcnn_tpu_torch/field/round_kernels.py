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

Challenges are host ints (the verifier's).  A wrapper runs its plain
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

import torch

from .limbs import FR, N_WORDS

NAMES = ("fold_round", "fold", "fold_cubic_round",
         "round_ladder", "fold_ladder", "cubic_ladder")
LAUNCHES = {k: 0 for k in NAMES}
KERNEL_LAUNCHES = {k: 0 for k in NAMES}
SHAPES = {k: set() for k in NAMES}

_LIB = None


def reset_launches():
    for k in NAMES:
        LAUNCHES[k] = KERNEL_LAUNCHES[k] = 0
        SHAPES[k].clear()


def _count(name: str, shape, kernels: int):
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[name] += kernels
    SHAPES[name].add(shape)


def _lib():
    global _LIB
    if _LIB is None:
        from ..cuda_build import load
        _LIB = load("round")
    return _LIB


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
