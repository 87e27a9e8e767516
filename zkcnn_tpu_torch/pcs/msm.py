"""Multi-scalar multiplication over fixed bases (counterpart of
`zkcnn_tpu/pcs/msm.py`).

`FixedBaseMSM(points).compute(scalars_mont [R, N, 8]) -> [R, 3, 12]`:
row r is sum_i k[r, i] P_i, the scalars given as Montgomery words.  The
contract is the group element, not its Jacobian coordinates (compare
with `points_equal`).

On a CUDA device one call is the `g1_msm` kernel of
`csrc/g1_kernels.cu`: a thread a term, a tree of additions within a
block and a second launch across a row's blocks.  The JAX package's
design (a table of digit multiples, a gather a window, a dense tree,
chunking of the gathered tensor) answers XLA's dense model and is not
carried over.  The plain PyTorch version (`msm_plain`: the scalars out
of Montgomery form, `scalar_mul_plain` a term, a tree along each row)
takes tensors on either device and is what the kernel is held against.
For CPU tensors `compute` runs `msm_host`, Python integers on the host
(see `curve.py` for why).
"""

import ctypes

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


class FixedBaseMSM:
    def __init__(self, points):
        curve.check_points("FixedBaseMSM", points)
        if points.dim() != 3:
            raise ValueError(f"FixedBaseMSM: expected [N, 3, {FP.n}] points, "
                             f"got {tuple(points.shape)}")
        self.points = points.contiguous()
        self.n_points = int(points.shape[0])

    def compute(self, scalars_mont):
        """scalars_mont [R, N, 8] (Montgomery) -> [R, 3, 12] points."""
        pts = self.points
        if scalars_mont.dtype != torch.int32 or scalars_mont.dim() != 3 \
                or scalars_mont.shape[1:] != (self.n_points, FR.n) \
                or scalars_mont.device != pts.device:
            raise ValueError(
                f"FixedBaseMSM.compute: expected [R, {self.n_points}, "
                f"{FR.n}] int32 scalars on {pts.device}, got "
                f"{tuple(scalars_mont.shape)} {scalars_mont.dtype} on "
                f"{scalars_mont.device}")
        if pts.device.type != "cuda":
            return msm_host(pts, scalars_mont)
        R, N = scalars_mont.shape[:2]
        ks = scalars_mont.contiguous()
        lib = curve.g1_lib()
        out = torch.empty((R, 3, FP.n), dtype=torch.int32, device=pts.device)
        per_row = lib.zk_g1_msm_parts(N)
        parts = torch.empty((R, per_row, 3, FP.n), dtype=torch.int32,
                            device=pts.device) if per_row > 1 else None
        n = ctypes.c_int(0)
        curve.launch(lib.zk_g1_msm, pts.data_ptr(), ks.data_ptr(),
                     out.data_ptr(),
                     parts.data_ptr() if parts is not None else None,
                     R, N, curve.stream_of(pts.device), ctypes.byref(n))
        curve.count_launch("g1_msm", (R, N), n.value)
        return out


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
