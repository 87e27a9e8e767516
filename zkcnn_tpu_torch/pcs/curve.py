"""Batched BLS12-381 G1 arithmetic in Jacobian coordinates
(counterpart of `zkcnn_tpu/pcs/curve.py`).

A point is a `[..., 3, 12]` int32 tensor: X, Y, Z as Montgomery words of
Fp (R = 2^384, the integers the JAX package holds in 24 limbs); Z == 0
is infinity.  `padd`, `pdouble` and `scalar_mul` take tensors on either
device.  For CUDA tensors they launch kernels of `csrc/g1_kernels.cu`
or raise: nothing falls back.  `scalar_mul` with one point shared by
all scalars (the generators, the opening's auxiliary generator) is an
MSM of one base: it builds that point's fixed-base table (`table_kernel`,
kernel `g1_msm_table`) and sums a row a scalar from it
(`table_msm_kernel`, kernel `g1_msm`, which `msm.FixedBaseMSM` also
runs); with a point a thread it is the windowed `g1_scalar_mul` kernel.
`base_mul` is the same MSM for the curve's base point G, whose table
depends on nothing else: it is built once a process and device
(`base_table`, kept in `BASE_TABLES`), so the tape's generator draws of
a proof's setup, opening and verification share it.
Each kernel has a plain PyTorch version (`padd_plain`, `pdouble_plain`,
`scalar_mul_plain`, and in `msm.py` `msm_table_plain` and `msm_plain`:
the JAX formulas on `FP.mul/add/sub` with `torch.where` selects) that
accepts tensors on either device, which is how a kernel is held against
it on the card.  For CPU tensors `padd` and `pdouble` run their plain
versions.  `scalar_mul` (and the MSM of `msm.py`) instead runs
`scalar_mul_host`, Python integers on the host, as the JAX package does
off the TPU (`_tape_gens`, `ZKCNN_TPU_MSM_HOST`), and builds no table: a
255-step double-and-add is about 2 x 10^6 small tensor operations in the
plain version whatever the batch (an inner-product opening of 4 columns
took 20 minutes on a CPU that way), against milliseconds a term in
integers.

A kernel returns the same group element as its plain version, and the
same coordinates where the same formula was applied (`padd`, `pdouble`);
compare points with `msm.points_equal` or `to_affine_host`.

Counts, set to 0 by `reset_launches`: `LAUNCHES[name]` is the number of
wrapper calls that launched kernel `name` (`pdouble` is the `g1_add`
kernel without a second operand and counts there), `KERNEL_LAUNCHES`
the device kernels they launched, `SHAPES` the shapes they launched at
(`g1_scalar_mul`: n, nbits and "scalar" where all threads shared one;
`g1_msm_table`: bases and windows; `g1_msm`: rows and bases;
`ipa_round`, a round of the inner-product opening of `ipa.py` on the
same library: generators and terms left after its fold) and
`PLAIN_CALLS` the calls that did not go to a kernel (the plain and the
host versions).

Pure-Python integer versions (`py_add`, `py_mul`) are included for
cross-checking and for host-side set-up.
"""

import ctypes
import hashlib
import math

import numpy as np
import torch

from ..field.limbs import FP, FR
from ..field.params import FP_P, FR_P

# curve: y^2 = x^3 + 4
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

NAMES = ("g1_add", "g1_scalar_mul", "g1_msm_table", "g1_msm",
         "ipa_round")
# the fixed-base table: 4-bit windows of a 256-bit scalar, 15 digit
# multiples a window (csrc/g1_arith.cuh)
WBITS = 4
NWIN = 64
WTAB = 15
LAUNCHES = {k: 0 for k in NAMES}
KERNEL_LAUNCHES = {k: 0 for k in NAMES}
SHAPES = {k: set() for k in NAMES}
PLAIN_CALLS = {k: 0 for k in NAMES}

_LIB = None
# the base point's fixed-base table on each CUDA device (`base_table`)
BASE_TABLES = {}


def reset_launches():
    for k in NAMES:
        LAUNCHES[k] = KERNEL_LAUNCHES[k] = PLAIN_CALLS[k] = 0
        SHAPES[k].clear()


def count_launch(name: str, shape, kernels: int = 1):
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[name] += kernels
    SHAPES[name].add(shape)


def g1_lib():
    global _LIB
    if _LIB is None:
        from ..cuda_build import load
        _LIB = load("g1")
    return _LIB


def launch(fn, *args):
    rc = fn(*args)
    if rc:
        raise RuntimeError("CUDA launch failed: "
                           + g1_lib().zk_g1_error_string(rc).decode())


def stream_of(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check_points(name, *pts) -> bool:
    """Validates point operands; True when they lie on a CUDA device."""
    for p in pts:
        if p.dtype != torch.int32 or p.dim() < 2 \
                or tuple(p.shape[-2:]) != (3, FP.n):
            raise ValueError(f"{name}: expected [..., 3, {FP.n}] int32 "
                             f"points, got {tuple(p.shape)} {p.dtype}")
        if p.device != pts[0].device:
            raise ValueError(f"{name}: operands on different devices")
    dev = pts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


# ---------------------------------------------------------------------
# host packing


def point_pack(xyz) -> np.ndarray:
    """host (x, y, z) ints -> [3, 12] Montgomery words."""
    return np.stack([FP.to_mont_host(c) for c in xyz])


def point_unpack(pt):
    """[..., 3, 12] -> list of (x, y, z) ints."""
    arr = np.asarray(pt.cpu() if torch.is_tensor(pt) else pt)
    return [tuple(FP.from_mont_host(c) for c in p)
            for p in arr.reshape(-1, 3, FP.n)]


def infinity(shape=(), device="cpu"):
    return torch.zeros(tuple(shape) + (3, FP.n), dtype=torch.int32,
                       device=device)


def base_point(device="cpu"):
    return torch.from_numpy(point_pack((G1_X, G1_Y, 1))).to(device)


def affine_pack(points) -> np.ndarray:
    """list of affine (x, y) or None -> [k, 3, 12] words with Z = 1
    (zeros for None)."""
    return np.stack([point_pack((P[0], P[1], 1)) if P is not None
                     else np.zeros((3, FP.n), np.int32) for P in points])


def _is_zero(v):
    return ~torch.any(v != 0, dim=-1)


# ---------------------------------------------------------------------
# plain versions


def pdouble_plain(p):
    """Jacobian doubling, a = 0 curve.  Handles infinity (Z=0) and
    Y = 0 (-> infinity) implicitly: 2*inf = inf since Z3 = 2YZ = 0."""
    PLAIN_CALLS["g1_add"] += 1
    return _pdouble(p)


def _pdouble(p):
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    A = FP.mul(X, X)
    B = FP.mul(Y, Y)
    Cc = FP.mul(B, B)
    t = FP.add(X, B)
    D = FP.sub(FP.sub(FP.mul(t, t), A), Cc)
    D = FP.add(D, D)
    E = FP.add(FP.add(A, A), A)
    F = FP.mul(E, E)
    X3 = FP.sub(F, FP.add(D, D))
    eightC = FP.add(Cc, Cc)
    eightC = FP.add(eightC, eightC)
    eightC = FP.add(eightC, eightC)
    Y3 = FP.sub(FP.mul(E, FP.sub(D, X3)), eightC)
    YZ = FP.mul(Y, Z)
    Z3 = FP.add(YZ, YZ)
    return torch.stack([X3, Y3, Z3], dim=-2)


def padd_plain(p, q):
    """Jacobian addition with edge handling: p + inf, inf + q, p == q
    (double), p == -q (canonical zeros)."""
    PLAIN_CALLS["g1_add"] += 1
    return _padd(p, q)


def _padd(p, q):
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    Z1Z1 = FP.mul(Z1, Z1)
    Z2Z2 = FP.mul(Z2, Z2)
    U1 = FP.mul(X1, Z2Z2)
    U2 = FP.mul(X2, Z1Z1)
    S1 = FP.mul(FP.mul(Y1, Z2), Z2Z2)
    S2 = FP.mul(FP.mul(Y2, Z1), Z1Z1)
    H = FP.sub(U2, U1)
    r = FP.sub(S2, S1)
    HH = FP.mul(H, H)
    HHH = FP.mul(H, HH)
    V = FP.mul(U1, HH)
    r2 = FP.mul(r, r)
    X3 = FP.sub(FP.sub(r2, HHH), FP.add(V, V))
    Y3 = FP.sub(FP.mul(r, FP.sub(V, X3)), FP.mul(S1, HHH))
    Z3 = FP.mul(FP.mul(Z1, Z2), H)
    out = torch.stack([X3, Y3, Z3], dim=-2)

    h_zero = _is_zero(H)
    r_zero = _is_zero(r)
    same = (h_zero & r_zero)[..., None, None]
    out = torch.where(same, _pdouble(p), out)
    opp = (h_zero & ~r_zero)[..., None, None]
    out = torch.where(opp, torch.zeros_like(out), out)
    p_inf = _is_zero(Z1)[..., None, None]
    q_inf = _is_zero(Z2)[..., None, None]
    out = torch.where(q_inf, p, out)
    out = torch.where(p_inf, q, out)
    return out


def scalar_bits(scalars_plain, nbits: int):
    """[..., 8] plain words -> [..., nbits] bits, least significant
    first."""
    idx = torch.arange(nbits, device=scalars_plain.device)
    w = scalars_plain.to(torch.int64) & 0xFFFFFFFF
    return (w[..., idx // 32] >> (idx % 32)) & 1


def scalar_mul_plain(pt, scalars_plain, nbits: int = 255):
    """Double-and-add over the low nbits bits, most significant first."""
    PLAIN_CALLS["g1_scalar_mul"] += 1
    bits = scalar_bits(scalars_plain, nbits)
    lead = torch.broadcast_shapes(pt.shape[:-2], bits.shape[:-1])
    acc = infinity(lead, pt.device)
    for i in range(nbits - 1, -1, -1):
        acc = _pdouble(acc)
        b = bits[..., i] > 0
        acc = torch.where(b[..., None, None], _padd(acc, pt), acc)
    return acc


def scalar_mul_host(pt, scalars_plain, nbits: int = 255):
    """The same function in Python integers on the host, for CPU
    tensors: Z = 1 points (zeros for infinity)."""
    PLAIN_CALLS["g1_scalar_mul"] += 1
    lead = torch.broadcast_shapes(pt.shape[:-2], scalars_plain.shape[:-1])
    mask = (1 << nbits) - 1
    affine = to_affine_host(pt.expand(lead + (3, FP.n)))
    ks = scalars_plain.expand(lead + (FR.n,)).reshape(-1, FR.n).numpy()
    out = [py_mul_signed(P, FR.int_host(k) & mask)
           for P, k in zip(affine, ks)]
    return torch.from_numpy(affine_pack(out)).reshape(lead + (3, FP.n))


# ---------------------------------------------------------------------
# the public functions: kernel on the card; on the CPU the plain version
# (padd, pdouble) or the host version (scalar_mul)


def _add_kernel(p, q):
    shape = p.shape
    p = p.reshape(-1, 3, FP.n).contiguous()
    n = p.shape[0]
    out = torch.empty_like(p)
    q_ptr = None
    if q is not None:
        q = q.reshape(-1, 3, FP.n).contiguous()
        q_ptr = q.data_ptr()
    if n:
        launch(g1_lib().zk_g1_add, p.data_ptr(), q_ptr, out.data_ptr(), n,
               stream_of(p.device))
        count_launch("g1_add", (n,))
    return out.reshape(shape)


def pdouble(p):
    if not check_points("pdouble", p):
        return pdouble_plain(p)
    return _add_kernel(p, None)


def padd(p, q):
    if not check_points("padd", p, q):
        return padd_plain(p, q)
    p, q = torch.broadcast_tensors(p, q)
    return _add_kernel(p, q)


def pneg(p):
    out = p.clone()
    out[..., 1, :] = FP.neg(p[..., 1, :])
    return out


def tree_sum(pts, add=padd):
    """Sum points along axis 0 by pairwise halving; `add` is the
    addition to use (`msm_plain` passes the plain one)."""
    n = pts.shape[0]
    while n > 1:
        if n % 2:
            pts = torch.cat([pts, infinity((1,) + tuple(pts.shape[1:-2]),
                                           pts.device)])
            n += 1
        pts = add(pts[0::2], pts[1::2])
        n >>= 1
    return pts[0]


def _flat(x, lead, tail):
    """x broadcast to lead + tail as [n, width] rows and its row stride;
    an operand of one element in all is shared through a stride of 0."""
    width = math.prod(tail)
    if x.numel() == width:
        return x.reshape(width).contiguous(), 0
    return x.expand(lead + tail).reshape(-1, width).contiguous(), width


def table_kernel(points, nwin: int = NWIN):
    """The fixed-base table of CUDA points [N, 3, 12] over nwin windows:
    [N, nwin, 15, 3, 12], entry (i, j, d - 1) = d 2^(4j) P_i.  One launch
    of g1_msm_table (four device kernels: the chain, three rounds of
    digits)."""
    pts = points.contiguous()
    N = pts.shape[0]
    tab = torch.empty((N, nwin, WTAB, 3, FP.n), dtype=torch.int32,
                      device=pts.device)
    n = ctypes.c_int(0)
    launch(g1_lib().zk_g1_msm_table, pts.data_ptr(), tab.data_ptr(), N,
           nwin, stream_of(pts.device), ctypes.byref(n))
    count_launch("g1_msm_table", (N, nwin), n.value)
    return tab


def table_msm_kernel(tab, ks, nbits: int, mont: bool):
    """[R, 3, 12]: row r is sum_i k[r, i] P_i from the table of the P_i
    (`table_kernel`), for scalars ks [R, N, 8] on the card, Montgomery
    words (mont) or the low nbits bits of plain ones.  One launch of
    g1_msm (one or two device kernels)."""
    R, N = ks.shape[:2]
    ks = ks.contiguous()
    lib = g1_lib()
    out = torch.empty((R, 3, FP.n), dtype=torch.int32, device=ks.device)
    per_row = lib.zk_g1_msm_parts(N)
    parts = torch.empty((R, per_row, 3, FP.n), dtype=torch.int32,
                        device=ks.device) if per_row > 1 else None
    n = ctypes.c_int(0)
    launch(lib.zk_g1_msm, tab.data_ptr(), ks.data_ptr(), out.data_ptr(),
           parts.data_ptr() if parts is not None else None, R, N,
           tab.shape[1], nbits, int(mont), stream_of(ks.device),
           ctypes.byref(n))
    count_launch("g1_msm", (R, N), n.value)
    return out


def _check_scalars(name, scalars_plain, device, nbits):
    if scalars_plain.dtype != torch.int32 or scalars_plain.shape[-1] != FR.n \
            or scalars_plain.device != device:
        raise ValueError(f"{name}: expected [..., {FR.n}] int32 scalars "
                         f"on {device}, got {tuple(scalars_plain.shape)} "
                         f"{scalars_plain.dtype} on {scalars_plain.device}")
    if not 1 <= nbits <= 32 * FR.n:
        raise ValueError(f"{name}: nbits {nbits} outside 1..256")


def scalar_mul(pt, scalars_plain, nbits: int = 255):
    """pt: [..., 3, 12] points; scalars_plain: [..., 8] plain (not
    Montgomery) Fr words; both broadcast over the leading dimensions.
    Multiplies by the low nbits bits of each scalar.  On a CUDA device:
    with one shared point, its table over nbits / 4 windows and one MSM
    of a row a scalar (g1_msm_table, g1_msm); else one launch of
    g1_scalar_mul."""
    on_cuda = check_points("scalar_mul", pt)
    _check_scalars("scalar_mul", scalars_plain, pt.device, nbits)
    if not on_cuda:
        return scalar_mul_host(pt, scalars_plain, nbits)
    lead = torch.broadcast_shapes(pt.shape[:-2], scalars_plain.shape[:-1])
    n = math.prod(lead)
    p, p_stride = _flat(pt, lead, (3, FP.n))
    k, k_stride = _flat(scalars_plain, lead, (FR.n,))
    if not n:
        return torch.empty(lead + (3, FP.n), dtype=torch.int32,
                           device=pt.device)
    if p_stride == 0:
        tab = table_kernel(p.reshape(1, 3, FP.n), -(-nbits // WBITS))
        out = table_msm_kernel(tab, k.reshape(n, 1, FR.n), nbits, False)
        return out.reshape(lead + (3, FP.n))
    out = torch.empty((n, 3, FP.n), dtype=torch.int32, device=pt.device)
    launch(g1_lib().zk_g1_scalar_mul, p.data_ptr(), k.data_ptr(), k_stride,
           out.data_ptr(), n, nbits, stream_of(pt.device))
    count_launch("g1_scalar_mul",
                 (n, nbits, "scalar" if k_stride == 0 else ""))
    return out.reshape(lead + (3, FP.n))


def base_table(device):
    """The base point's table over NWIN windows on a CUDA device: built
    by the first call on that device (one launch of g1_msm_table) and
    kept in `BASE_TABLES`."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in BASE_TABLES:
        BASE_TABLES[dev] = table_kernel(base_point(dev)[None])
    return BASE_TABLES[dev]


def base_mul(scalars_plain, nbits: int = 255):
    """k G for the base point G and plain scalars [..., 8] (the low nbits
    bits of each): on a CUDA device one MSM of a row a scalar on
    `base_table` (g1_msm); on the CPU `scalar_mul` (Python integers)."""
    dev = scalars_plain.device
    if dev.type != "cuda":
        return scalar_mul(base_point(dev), scalars_plain, nbits)
    _check_scalars("base_mul", scalars_plain, dev, nbits)
    lead = tuple(scalars_plain.shape[:-1])
    n = math.prod(lead)
    if not n:
        return torch.empty(lead + (3, FP.n), dtype=torch.int32, device=dev)
    k = scalars_plain.reshape(n, 1, FR.n)
    return table_msm_kernel(base_table(dev), k, nbits, False).reshape(
        lead + (3, FP.n))


# ---------------------------------------------------------------------
# pure-Python integer versions (tests, host-side set-up)


def py_add(P, Q, p=FP_P):
    if P is None:
        return Q
    if Q is None:
        return P
    (x1, y1), (x2, y2) = P, Q
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def _jac_double(X, Y, Z, p):
    """2 (X, Y, Z) in Jacobian coordinates on y^2 = x^3 + b (Z = 0, the
    point at infinity, stays 0)."""
    YY = Y * Y % p
    S, M = 4 * X * YY % p, 3 * X * X % p
    X3 = (M * M - 2 * S) % p
    return X3, (M * (S - X3) - 8 * YY * YY) % p, 2 * Y * Z % p


def py_mul(P, k, p=FP_P):
    """k P for k >= 0: double-and-add from the top bit in Jacobian
    coordinates, adding the affine P, with one inversion at the end
    (py_add inverts at every step)."""
    if P is None or k == 0:
        return None
    x, y = P
    X, Y, Z = x, y, 1
    for bit in bin(k)[3:]:
        X, Y, Z = _jac_double(X, Y, Z, p)
        if bit == "0":
            continue
        if not Z:
            X, Y, Z = x, y, 1
            continue
        ZZ = Z * Z % p
        H, R = (x * ZZ - X) % p, (y * ZZ * Z - Y) % p
        if H == 0:                          # P + P, or P + (-P)
            X, Y, Z = _jac_double(X, Y, Z, p) if R == 0 else (1, 1, 0)
            continue
        HH = H * H % p
        HHH, V = H * HH % p, X * HH % p
        X = (R * R - HHH - 2 * V) % p
        Y, Z = (R * (V - X) - Y * HHH) % p, Z * H % p
    if not Z:
        return None
    zi = pow(Z, -1, p)
    return (X * zi * zi % p, Y * zi * zi * zi % p)


def py_mul_signed(P, k):
    """k P for 0 <= k < r through the shorter of k and r - k: the
    witness's negative values are r - small."""
    if P is None or k == 0:
        return None
    if k > FR_P >> 1:
        Q = py_mul(P, FR_P - k)
        return None if Q is None else (Q[0], (-Q[1]) % FP_P)
    return py_mul(P, k)


def to_affine_host(pt):
    """[..., 3, 12] -> list of (x, y) or None, for comparisons."""
    out = []
    for (x, y, z) in point_unpack(pt):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, FP_P)
            out.append((x * zi * zi % FP_P, y * zi * zi * zi % FP_P))
    return out


def encode_points_host(pt) -> bytes:
    """Canonical byte encoding of a batch of points: affine x||y (48+48
    LE bytes each; a single zero byte for infinity).  Used for
    Fiat-Shamir absorption -- Jacobian words are NOT canonical (any
    Z-scaling changes them without changing the group element)."""
    parts = []
    for a in to_affine_host(pt):
        if a is None:
            parts.append(b"\x00")
        else:
            parts.append(a[0].to_bytes(48, "little")
                         + a[1].to_bytes(48, "little"))
    return b"".join(parts)


def hash_to_group_host(seed: bytes, index: int):
    """Try-and-increment hash-to-curve with cofactor clearing: returns
    an affine (x, y) whose discrete log is unknown to everyone.  Used
    for Fiat-Shamir-mode Pedersen generators, where tape-derived
    s_i*G generators would hand the prover every discrete log (the
    tape is a public function of the seed).  Host-side Python-int math
    (setup-time only).  p == 3 (mod 4), so sqrt is a single pow."""
    assert FP_P % 4 == 3
    ctr = 0
    while True:
        h = hashlib.sha512(seed + index.to_bytes(8, "little")
                           + ctr.to_bytes(8, "little")).digest()
        x = int.from_bytes(h, "little") % FP_P
        rhs = (x * x * x + 4) % FP_P
        y = pow(rhs, (FP_P + 1) // 4, FP_P)
        if y * y % FP_P == rhs:
            if y & 1:
                y = FP_P - y          # canonical sign choice
            P = py_mul((x, y), G1_COFACTOR)
            if P is not None:
                return P
        ctr += 1
