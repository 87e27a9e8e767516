"""Batched Fr arithmetic on PyTorch tensors, Montgomery form.

Counterpart of `zkcnn_tpu/field/limbs.py`.  A field element is a
`[..., 8]` `torch.int32` tensor holding the little-endian 32-bit words
of its Montgomery residue a*R mod p, with R = 2^256 as in the JAX
package, so word k equals JAX limb[2k] | JAX limb[2k+1] << 16: the two
packages hold the same integer.  int32 and not uint32, because torch's
uint32 has no add, shift or `index_add_` on the CPU; words >= 2^31 read
as negative and are masked back to 32 bits when widened.

The arithmetic here is the plain PyTorch path.  It widens to sixteen
16-bit limbs in int64, limb axis FIRST ([16, ...]) so that every
per-limb step works on one contiguous slice.  A limb product is below
2^32 and a column of sixteen of them below 2^36, so schoolbook columns
and a limb-serial Montgomery reduction are exact in int64 with no
byte-plane tricks.  Every public op returns canonical residues
(0 <= x < p), which are unique, so results equal the JAX package's bit
for bit.  The sumcheck round kernels (round_kernels.py) run the same
math in CUDA.
"""

import numpy as np
import torch

from .params import LIMB_BITS, LIMB_MASK, FR_P, to_limbs

N_WORDS = 8
N_LIMBS = 16
_I64 = torch.int64


def _rows(vec, nd: int, device):
    """[k] python ints -> [k, 1, ...] int64 column constant."""
    return torch.tensor(vec, dtype=_I64, device=device).view(
        len(vec), *([1] * nd))


def limbs16(x):
    """[..., 8] int32 words -> [16, ...] int64 16-bit limbs."""
    w = x.to(_I64) & 0xFFFFFFFF
    lo, hi = w & LIMB_MASK, w >> LIMB_BITS
    out = torch.stack([lo, hi], dim=-1).reshape(*x.shape[:-1], N_LIMBS)
    return out.movedim(-1, 0).contiguous()


def words(l16):
    """[16, ...] int64 normalized limbs -> [..., 8] int32 words."""
    l16 = l16.movedim(0, -1)
    pair = l16.reshape(*l16.shape[:-1], N_WORDS, 2)
    w = pair[..., 0] | (pair[..., 1] << LIMB_BITS)
    return (w - ((w >> 31) << 32)).to(torch.int32).contiguous()


def normalize(t):
    """Carry-propagate limb columns in place (signed-safe: >> floors).
    Every row but the last ends in [0, 2^16); the last keeps the
    excess (its sign is the sign of the whole value)."""
    for k in range(t.shape[0] - 1):
        t[k + 1] += t[k] >> LIMB_BITS
        t[k] &= LIMB_MASK
    return t


def _pad_rows(t, rows: int):
    if t.shape[0] >= rows:
        return t.clone()
    z = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]), dtype=_I64,
                    device=t.device)
    return torch.cat([t, z])


def _align(t, nd: int):
    """View a [16, ...] limb tensor with nd trailing dims (broadcast)."""
    return t.view(t.shape[0], *([1] * (nd - t.dim() + 1)), *t.shape[1:])


def mul_cols(a16, b16):
    """Schoolbook product columns [33, ...] of two [16, ...] limb
    tensors (broadcast).  Columns < 16 * 2^32 = 2^36."""
    shape = torch.broadcast_shapes(a16.shape[1:], b16.shape[1:])
    a16, b16 = _align(a16, len(shape)), _align(b16, len(shape))
    t = torch.zeros((2 * N_LIMBS + 1,) + tuple(shape), dtype=_I64,
                    device=a16.device)
    for i in range(N_LIMBS):
        t[i:i + N_LIMBS] += a16[i] * b16
    return t


class Field:
    """A prime field with batched tensor ops and host scalar helpers."""

    def __init__(self, p: int, name: str):
        self.p = p
        self.name = name
        self.n = N_WORDS
        self.R = 1 << (32 * N_WORDS)
        self.R_inv = pow(self.R, -1, p)
        self.R2 = (self.R * self.R) % p
        self.pp0 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.p_limbs = to_limbs(p, N_LIMBS)
        self._consts = {}

    # ---------- host scalar <-> word conversion ----------

    @staticmethod
    def words_host(x: int) -> np.ndarray:
        """Canonical integer -> [8] int32 words (no Montgomery map)."""
        return np.array([(x >> (32 * k)) & 0xFFFFFFFF
                         for k in range(N_WORDS)], np.uint32).view(np.int32)

    @staticmethod
    def int_host(w) -> int:
        """[8] words (any int dtype) -> the integer they hold."""
        w = np.asarray(w).astype(np.int64) & 0xFFFFFFFF
        return sum(int(v) << (32 * k) for k, v in enumerate(w))

    def to_mont_host(self, x: int) -> np.ndarray:
        return self.words_host((x % self.p) * self.R % self.p)

    def from_mont_host(self, w) -> int:
        return self.int_host(w) * self.R_inv % self.p

    def pack_mont_host(self, xs) -> np.ndarray:
        """[k] python ints -> [k, 8] Montgomery words."""
        raw = b"".join(((x % self.p) * self.R % self.p).to_bytes(
            4 * N_WORDS, "little") for x in xs)
        return np.frombuffer(raw, "<i4").reshape(len(xs), N_WORDS).copy()

    def unpack_mont_host(self, arr) -> list:
        arr = np.asarray(arr).reshape(-1, N_WORDS)
        return [self.from_mont_host(a) for a in arr]

    def const(self, x: int, device) -> torch.Tensor:
        """Montgomery [8] tensor of the host int x on `device`."""
        return torch.from_numpy(self.to_mont_host(x)).to(device)

    def zeros(self, rows: int, device) -> torch.Tensor:
        return torch.zeros((rows, N_WORDS), dtype=torch.int32, device=device)

    # ---------- limb-level primitives ([16, ...] int64) ----------

    def _p_rows(self, nd: int, device):
        key = ("p", nd, str(device))
        if key not in self._consts:
            self._consts[key] = _rows(self.p_limbs, nd, device)
        return self._consts[key]

    def redc_step(self, t):
        """One Montgomery division on exact limb columns t [W, ...]
        (W >= 32, columns < 2^40): returns (t + m*p)/R as columns
        [W - 16, ...] (normalized; value < t/R + p)."""
        t = _pad_rows(t, max(t.shape[0], 2 * N_LIMBS) + 1)
        p = self._p_rows(t.dim() - 1, t.device)
        for i in range(N_LIMBS):
            m = (t[i] * self.pp0) & LIMB_MASK
            t[i:i + N_LIMBS] += m * p
            t[i + 1] += t[i] >> LIMB_BITS
        return normalize(t[N_LIMBS:])

    def canon(self, x):
        """Normalized limb rows holding a value < 2p -> canonical
        [16, ...] limbs (one conditional subtract of p)."""
        if x.shape[0] > N_LIMBS:
            # the rows above 16 are zero: the value is below 2p < 2^256
            x = x[:N_LIMBS].clone()
        d = x - self._p_rows(x.dim() - 1, x.device)
        normalize(d)
        return torch.where(d[N_LIMBS - 1] < 0, x, d)

    def redc(self, t):
        """t * R^-1 mod p, canonical, for exact columns with t < R*p."""
        return self.canon(self.redc_step(t))

    def times_r(self, x):
        """Canonical limbs x -> x * R mod p (one product with R^2)."""
        key = ("r2", x.dim() - 1, str(x.device))
        if key not in self._consts:
            self._consts[key] = _rows(to_limbs(self.R2, N_LIMBS),
                                      x.dim() - 1, x.device)
        return self.redc(mul_cols(x, self._consts[key]))

    def mont_sum_cols(self, cols):
        """Exact column sums [W, ...] of Montgomery residues (value
        V < R*p) -> canonical Montgomery limbs of V mod p."""
        return self.times_r(self.redc(cols))

    def dot_reduce_cols(self, cols):
        """Exact columns [W, ...] of V = sum_i (a_i R)(b_i R) (V <
        2^544) -> canonical Montgomery limbs of sum_i mont(a_i, b_i)."""
        cols = normalize(_pad_rows(cols, 34))
        return self.times_r(self.redc(self.redc_step(cols)))

    # ---------- tensor ops ([..., 8] int32, broadcasting) ----------

    def add(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        s = limbs16(a) + limbs16(b)
        return words(self.canon(normalize(s)))

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        s = limbs16(a) - limbs16(b) + self._p_rows(a.dim() - 1, a.device)
        return words(self.canon(normalize(s)))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p."""
        return words(self.redc(mul_cols(limbs16(a), limbs16(b))))

    def mul_scalar(self, x, r):
        """x * r for one Montgomery scalar r [8] broadcast over x."""
        return self.mul(x, r.reshape(N_WORDS))

    def lincomb2_scalar(self, x, y, rx, ry):
        """x*rx + y*ry for two shared Montgomery scalars, one reduction
        (value < 2p^2 < R*p)."""
        t = mul_cols(limbs16(x), limbs16(rx.reshape(N_WORDS))) \
            + mul_cols(limbs16(y), limbs16(ry.reshape(N_WORDS)))
        return words(self.redc(t))

    def sum(self, x, axis: int = -2):
        """Exact modular sum along `axis` (Montgomery in and out)."""
        x = x.movedim(axis, -2)
        if x.shape[-2] == 0:
            return torch.zeros(x.shape[:-2] + (N_WORDS,), dtype=torch.int32,
                               device=x.device)
        cols = limbs16(x).sum(dim=-1)       # [16, ...]; < rows * 2^16
        return words(self.mont_sum_cols(cols))

    # rows of the contracted axis per chunk in dot_mont: bounds the
    # [16, ...] int64 product temporaries to ~2^22 elements
    DOT_CHUNK_ELEMS = 1 << 22

    def dot_mont(self, a, b, axis: int = -2):
        """sum_i mont(a_i, b_i) along `axis` (the value FR.dot_mont of
        the JAX package returns): elementwise products, then one exact
        column sum, chunked along the contracted axis."""
        a, b = torch.broadcast_tensors(a.movedim(axis, -2),
                                       b.movedim(axis, -2))
        n = a.shape[-2]
        per_row = max(1, a.numel() // max(n, 1))
        ch = max(1, self.DOT_CHUNK_ELEMS // per_row)
        cols = None
        for s in range(0, n, ch):
            e = limbs16(self.mul(a[..., s:s + ch, :], b[..., s:s + ch, :]))
            part = e.sum(dim=-1)
            cols = part if cols is None else cols + part
        if cols is None:
            return torch.zeros(a.shape[:-2] + (N_WORDS,), dtype=torch.int32,
                               device=a.device)
        return words(self.mont_sum_cols(cols))

    # ---------- conversions for witness data ----------

    def _plain_to_mont(self, plain16: np.ndarray, device):
        """Host [N, 16] plain limbs -> Montgomery words on `device`."""
        x = torch.from_numpy(np.ascontiguousarray(plain16.T)).to(device)
        return words(self.times_r(x))

    def from_int64(self, v, device):
        """Signed int64 numpy array -> Montgomery words on `device`.
        Exact for |v| < 2^63; negative values map to p - |v|."""
        v = np.asarray(v, np.int64)
        a = np.abs(v).astype(np.uint64)
        plain = np.zeros((v.size, N_LIMBS), np.int64)
        flat = a.reshape(-1)
        for i in range(4):
            plain[:, i] = ((flat >> np.uint64(16 * i))
                           & np.uint64(LIMB_MASK)).astype(np.int64)
        neg = v.reshape(-1) < 0
        if neg.any():
            borrow = np.zeros(v.size, np.int64)
            out = np.zeros_like(plain)
            for i in range(N_LIMBS):
                d = self.p_limbs[i] - plain[:, i] - borrow
                borrow = (d < 0).astype(np.int64)
                out[:, i] = d + (borrow << 16)
            plain = np.where(neg[:, None], out, plain)
        return self._plain_to_mont(plain, device).reshape(
            v.shape + (N_WORDS,))

    def from_bigint(self, v, device):
        """Object array of python ints (any size, any sign) -> Montgomery
        words on `device`; values are reduced mod p."""
        v = np.asarray(v, object)
        rem = (v % self.p).reshape(-1)
        plain = np.zeros((rem.size, N_LIMBS), np.int64)
        for i in range(N_LIMBS):
            plain[:, i] = (rem & LIMB_MASK).astype(np.int64)
            rem = rem >> LIMB_BITS
        return self._plain_to_mont(plain, device).reshape(
            v.shape + (N_WORDS,))

    def to_int_host(self, w) -> np.ndarray:
        """Montgomery words -> python-int object array (host, exact)."""
        arr = np.asarray(w.cpu() if torch.is_tensor(w) else w)
        flat = arr.reshape(-1, N_WORDS)
        out = np.empty(flat.shape[0], object)
        for i in range(flat.shape[0]):
            out[i] = self.from_mont_host(flat[i])
        return out.reshape(arr.shape[:-1])

    def to_signed_host(self, w) -> np.ndarray:
        """Like to_int_host but mapped to (-p/2, p/2] (mcl getInt64)."""
        vals = self.to_int_host(w)
        half = self.p >> 1
        flat = vals.reshape(-1)
        for i in range(flat.shape[0]):
            if flat[i] > half:
                flat[i] -= self.p
        return vals


FR = Field(FR_P, "Fr")
