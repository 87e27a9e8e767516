"""Multi-scalar multiplication over fixed bases (counterpart of
`zkcnn_tpu/pcs/msm.py`).

`FixedBaseMSM(points).compute(scalars_mont [R, N, 8]) -> [R, 3, 12]`:
row r is sum_i k[r, i] P_i, the scalars given as Montgomery words.  The
contract is the group element, not its Jacobian coordinates (compare
with `points_equal`).

On a CUDA device the JAX package's design is kept where it serves the
card: the constructor builds a fixed-base table of the bases (kernel
`g1_msm_table`: d 2^(4j) P_i for 4-bit digits d and 64 windows j, as
the JAX package's `build_table` does at construction), whose entries
kernel `g1_table_affine` then brings to Z = 1 in place, and `compute` is
one launch of kernel `g1_msm`, which adds the table entry of every
nonzero digit of every term (no doubling) with a mixed addition, each
term's scalar taken as r - k where that is the smaller, a warp's lanes
adding the nonzero digits of a tile of terms 32 at a time, then the
partial sums of a row added by one or two more kernels.  What the JAX
package does for XLA's dense model (signed radix-256 digits, GLV, a
gather a window and a Horner step between windows) is not carried over.
`extend(extra)` gives an MSM over the bases and a few more that reuses
the table: only the extra bases' table is built, then joined (the
inner-product opening's [generators; Q]); both have Z = 1 entries.
The plain PyTorch versions,
`msm_table_plain` (the table from the plain doubling and addition),
`table_affine_plain` (its entries to Z = 1, an inversion an entry) and
`msm_plain` (the scalars out of Montgomery form, `scalar_mul_plain` a
term, a tree along each row), take tensors on either device and are
what the kernels are held against.  For CPU tensors the constructor
builds no table and `compute` runs `msm_host`, Python integers on the
host (see `curve.py` for why).
"""

import torch

from ..field.limbs import FR, FP, limbs16, words
from . import curve


def plain_scalars(scalars_mont):
    """[..., 8] Montgomery words -> [..., 8] plain words."""
    return words(FR.redc(limbs16(scalars_mont)))


def msm_plain(points, scalars_mont, nbits: int = 255):
    """[N, 3, 12], [R, N, 8] Montgomery -> [R, 3, 12]; nbits: a bound on
    the scalars' bit length."""
    curve.PLAIN_CALLS["g1_msm"] += 1
    terms = curve.scalar_mul_plain(points[None], plain_scalars(scalars_mont),
                                   nbits)
    return curve.tree_sum(terms.movedim(1, 0), curve._padd)   # over N


def msm_host(points, scalars_mont):
    """The same function in Python integers on the host, for CPU
    tensors: Z = 1 points (zeros for infinity)."""
    curve.PLAIN_CALLS["g1_msm"] += 1
    affine = curve.to_affine_host(points)
    rows = []
    for row in scalars_mont.numpy():
        acc = None
        for P, k in zip(affine, FR.unpack_mont_host(row)):
            acc = curve.py_add(acc, curve.py_mul_signed(P, k))
        rows.append(acc)
    return torch.from_numpy(curve.affine_pack(rows))


def msm_table_plain(points, nwin: int = curve.NWIN):
    """[N, 3, 12] -> [N, nwin, 15, 3, 12], entry (i, j, d - 1) =
    d 2^(4j) P_i: the table of `g1_msm_table` (as group elements) from the
    plain doubling and addition, the multiples made as the kernel makes
    them (d = 1, 2, 4, 8 from the chain of doublings, then entry m + e =
    entry m + entry e, e < m, m = 2, 4, 8)."""
    curve.PLAIN_CALLS["g1_msm_table"] += 1
    q, chain = points, []
    for t in range(curve.WBITS * nwin):          # chain[t] = 2^t P
        if t:
            q = curve._pdouble(q)
        chain.append(q)
    rows = [None] * curve.WTAB                   # rows[d - 1]: d 2^(4j) P
    for s in range(curve.WBITS):
        rows[(1 << s) - 1] = torch.stack(chain[s::curve.WBITS], 1)
    m = 2
    while m < curve.WTAB:
        es = range(1, min(m, curve.WTAB - m + 1))
        sums = curve._padd(rows[m - 1][None],
                           torch.stack([rows[e - 1] for e in es]))
        for e, row in zip(es, sums.unbind(0)):
            rows[m + e - 1] = row
        m *= 2
    return torch.stack(rows, 2)


def table_affine_plain(tab):
    """[..., 3, 12] Jacobian table entries -> the same with Z = 1: x =
    X / Z^2, y = Y / Z^3, Z = one in Montgomery form, and all zeros where
    Z = 0 (the layout `g1_msm` reads).  Z^-1 is Z^(p - 2), squaring and
    multiplying from the top bit, on every entry at once."""
    curve.PLAIN_CALLS["g1_table_affine"] += 1
    X, Y, Z = tab[..., 0, :], tab[..., 1, :], tab[..., 2, :]
    inf = curve._is_zero(Z)
    e = FP.p - 2
    zi = Z
    for b in range(e.bit_length() - 2, -1, -1):
        zi = FP.mul(zi, zi)
        if (e >> b) & 1:
            zi = FP.mul(zi, Z)
    zz = FP.mul(zi, zi)
    out = torch.stack([FP.mul(X, zz), FP.mul(Y, FP.mul(zz, zi)),
                       FP.const(1, tab.device).expand_as(Z)], dim=-2)
    return torch.where(inf[..., None, None], torch.zeros_like(out), out)



class FixedBaseMSM:
    def __init__(self, points):
        on_cuda = curve.check_points("FixedBaseMSM", points)
        if points.dim() != 3:
            raise ValueError(f"FixedBaseMSM: expected [N, 3, {FP.n}] points, "
                             f"got {tuple(points.shape)}")
        self.points = points.contiguous()
        self.n_points = int(points.shape[0])
        self.table = curve.table_kernel(self.points) if on_cuda else None

    def extend(self, extra):
        """A FixedBaseMSM over [self.points; extra] that reuses this
        table: on a CUDA device only the extra bases' table is built (one
        launch of g1_msm_table) and joined to this one (one copy); for
        CPU tensors `compute` runs `msm_host` over the joined points."""
        on_cuda = curve.check_points("FixedBaseMSM.extend", self.points,
                                     extra)
        out = FixedBaseMSM.__new__(FixedBaseMSM)
        out.points = torch.cat([self.points, extra.reshape(-1, 3, FP.n)])
        out.n_points = int(out.points.shape[0])
        out.table = torch.cat([self.table, curve.table_kernel(
            out.points[self.n_points:], self.table.shape[1])]) \
            if on_cuda else None
        return out

    def compute(self, scalars_mont, plan_rows=None):
        """scalars_mont [R, N, 8] (Montgomery) -> [R, 3, 12] points.
        plan_rows: on the card, the rows whose cut into the kernel's warp
        items each row takes (default R; `curve.table_msm_kernel`)."""
        pts = self.points
        if scalars_mont.dtype != torch.int32 or scalars_mont.dim() != 3 \
                or scalars_mont.shape[1:] != (self.n_points, FR.n) \
                or scalars_mont.device != pts.device:
            raise ValueError(
                f"FixedBaseMSM.compute: expected [R, {self.n_points}, "
                f"{FR.n}] int32 scalars on {pts.device}, got "
                f"{tuple(scalars_mont.shape)} {scalars_mont.dtype} on "
                f"{scalars_mont.device}")
        if self.table is None:
            return msm_host(pts, scalars_mont)
        return curve.table_msm_kernel(self.table, scalars_mont,
                                      curve.WBITS * curve.NWIN, True,
                                      plan_rows)


def points_equal(p, q):
    """Jacobian equality: cross-multiplied affine comparison."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    Z1Z1, Z2Z2 = FP.mul(Z1, Z1), FP.mul(Z2, Z2)
    xe = torch.all(FP.sub(FP.mul(X1, Z2Z2), FP.mul(X2, Z1Z1)) == 0, dim=-1)
    ye = torch.all(FP.sub(FP.mul(FP.mul(Y1, Z2), Z2Z2),
                          FP.mul(FP.mul(Y2, Z1), Z1Z1)) == 0, dim=-1)
    i1 = ~torch.any(Z1 != 0, dim=-1)
    i2 = ~torch.any(Z2 != 0, dim=-1)
    return torch.where(i1 | i2, i1 == i2, xe & ye)
