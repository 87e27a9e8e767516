"""The prover's hot paths split over a device mesh (counterpart of
`zkcnn_tpu/parallel/sharding.py`).

Each function takes the port's [rows, 8]-word operands (an MSM its
[N, 3, 12] points and [R, N, 8] scalars), splits them with
`context.shard_rows` (which keeps them whole where the rule says so),
runs the unsplit counterpart on every shard's device and joins the
results; the output equals the unsplit counterpart's word for word:

  * `sharded_fold_coeffs`: a quadratic round on split rows, one
    `round_ladder` launch a shard (`ladder_shards`, which the sumcheck
    engines run for every ladder, split or not): the four pair dots
    (`quad_dots_plain`) and the folds (`fold`);
  * `sharded_dot`: `FR.dot_mont`;
  * `sharded_segment_sum`: `segment_sum_field` with the gates split;
  * `sharded_ntt`: `ntt` / `intt` with the batch of transforms split
    (the witness's NTT of a large batch, `circuit/eval.py`);
  * `stage_sharded_ntt`: `ntt` / `intt` split within one transform (the
    witness's NTT of a small batch);
  * `sharded_msm` / `ShardedMSM`: `FixedBaseMSM.compute` with its rows
    (the R MSMs) split, each shard on the bases' table on its own device
    (the Hyrax commit, `pcs/hyrax.py`).

`sharded_dot` and `sharded_segment_sum` have no caller on the proof
path, as their JAX counterparts have none; they are held against them
(tests/test_torch_parallel_jax.py).  The proof's split of the witness
and the gates (`gkr/prover.py`, `gkr/kernels.py`) takes `sharded_dot`'s
shape where it sums (the FFT layers' count contraction, the opening's
row fold, the predicates: one partial a block, an exact sum on the
first device), but not `sharded_segment_sum`'s for the inits' scatter:
a full-length partial a shard, then their sum, would hold the whole
column accumulator on every shard (4 GiB a shard at vgg16's Liu phase),
so each gate chunk is routed instead to the shard that owns its scatter
row, and each shard's accumulator holds its own rows.

The reduction across shards is exact and modular: the partials are
gathered onto the first device and summed with `FR.sum` (a sum of the
limbs alone would not be a reduction mod p).
"""

import torch

from ..field import FR
from ..field.ops import segment_sum_field
from ..field.params import FR_P
from ..field.round_kernels import round_ladder
from ..ntt import ntt, intt
from .context import COUNTS, Mesh, make_mesh, shard_rows, gather_rows, \
    gather_parts, _moved

__all__ = ["make_mesh", "ladder_shards", "sharded_fold_coeffs",
           "sharded_dot", "sharded_segment_sum", "sharded_ntt",
           "stage_sharded_ntt", "ShardedMSM", "sharded_msm"]


def reduce_parts(parts, device):
    """The exact modular sum of same-shaped per-shard Montgomery partials
    (a dot's, a row fold's), gathered onto `device`; one part as it is,
    on `device`."""
    if len(parts) == 1:
        return _moved(parts[0], device)
    shape = parts[0].shape
    joined = gather_parts([p.reshape(1, -1, FR.n) for p in parts], device)
    return FR.sum(joined, axis=0).reshape(shape)


def _reduce(parts, mesh: Mesh):
    """reduce_parts onto the mesh's first device."""
    return reduce_parts(parts, mesh.first)


def ladder_shards(As, Vs, rs):
    """len(rs) quadratic rounds on each shard's blocks (As[i], Vs[i]) at
    the challenges rs, one `round_ladder` launch a shard: (each shard's
    dots as [4 len(rs), 8], the folded As, the folded Vs)."""
    outs = [round_ladder(a, v, rs) for a, v in zip(As, Vs)]
    return ([o[0].reshape(4 * len(rs), FR.n) for o in outs],
            [o[1] for o in outs], [o[2] for o in outs])


def sharded_fold_coeffs(mesh: Mesh, A, V, r: int):
    """One quadratic round on A, V [N, 8] split over the mesh: (dots [4,
    8], A folded at r, V folded at r), equal to (quad_dots_plain(A, V),
    fold(A, r), fold(V, r))."""
    dots, As, Vs = ladder_shards(shard_rows(A, mesh), shard_rows(V, mesh),
                                 [r])
    return (_reduce(dots, mesh), gather_rows(As, A.device),
            gather_rows(Vs, V.device))


def sharded_dot(mesh: Mesh, a, b):
    """FR.dot_mont(a, b) of [N, 8] vectors split over the mesh: [8]."""
    parts = [FR.dot_mont(x, y) for x, y in zip(shard_rows(a, mesh),
                                               shard_rows(b, mesh))]
    return _reduce(parts, mesh)


def sharded_segment_sum(mesh: Mesh, vals, seg_ids, num_segments: int):
    """segment_sum_field(vals, seg_ids, num_segments) with the gates
    split over the mesh: per-shard exact segment sums, then their exact
    modular sum; [S, 8]."""
    parts = [segment_sum_field(v, s, num_segments)
             for v, s in zip(shard_rows(vals, mesh),
                             shard_rows(seg_ids, mesh))]
    return _reduce(parts, mesh)


def sharded_ntt(mesh: Mesh, x, logn: int, inverse: bool = False):
    """ntt(x, logn) (intt when inverse) of a batch [B, N, 8] with the
    transforms split over the mesh (the witness's per-(picture, channel)
    slots are independent)."""
    step = intt if inverse else ntt
    return gather_rows([step(b, logn) for b in shard_rows(x, mesh)],
                       x.device)


def _stages(x, tw, N: int):
    """The butterfly stages of `ntt._ntt_core` that pair rows inside a
    block, on [b, rows, 8] blocks of a transform of N points."""
    b, rows = x.shape[:2]
    for s in range(1, rows.bit_length()):
        half = 1 << (s - 1)
        v = x.reshape(b, rows >> s, 2, half, FR.n)
        u = v[:, :, 0]
        t = FR.mul(v[:, :, 1], tw[::N >> s][None, None])
        x = torch.stack([FR.add(u, t), FR.sub(u, t)], dim=2).reshape(
            b, rows, FR.n)
    return x


def _transpose(blocks, mesh: Mesh):
    """The all-to-all of D blocks [b, D, M, 8]: block d' of the result
    holds block e's [:, d'] for every e, as [b, D (e), M, 8] on device
    d'."""
    COUNTS["transposes"] += 1
    D = len(blocks)
    return [torch.stack([_moved(blocks[e][:, dp], dev) for e in range(D)],
                        dim=1)
            for dp, dev in enumerate(mesh.devices)]


def stage_sharded_ntt(mesh: Mesh, x, logn: int, inverse: bool = False):
    """ntt(x, logn) (intt when inverse) of [B, N, 8], split WITHIN each
    transform: the bit-reversed rows in D contiguous blocks of L = N/D,
    the stages that pair rows inside a block run on each shard, one
    all-to-all transpose gives shard d' the rows e L + d' M + m of every
    block e (M = L / D), the log2(D) cross stages run there with the
    gathered twiddles tw[(p L + j) (N >> s)], j = d' M + m, and a second
    transpose brings the rows back.  Every butterfly makes the FR ops of
    `ntt` on the same operands, so the words are the same.  Needs D a
    power of two and N >= D^2."""
    from ..ntt.ntt import _plan
    D = mesh.size
    logD = D.bit_length() - 1
    if D & (D - 1):
        raise ValueError(f"stage_sharded_ntt: {D} shards, not a power of 2")
    N = 1 << logn
    L = N >> logD
    M = L // D
    if M < 1:
        raise ValueError(f"stage_sharded_ntt: N = {N} < D^2 = {D * D}")
    logL = logn - logD
    home, b = x.device, x.shape[0]
    rev, tw_host = _plan(logn, inverse)
    x = x[:, torch.from_numpy(rev).to(home)]
    tws = {dev: torch.from_numpy(tw_host).to(dev) for dev in mesh.devices}
    blocks = [_stages(_moved(x[:, d * L:(d + 1) * L], dev).contiguous(),
                      tws[dev], N)
              for d, dev in enumerate(mesh.devices)]
    z = _transpose([blk.reshape(b, D, M, FR.n) for blk in blocks], mesh)
    for dp, dev in enumerate(mesh.devices):
        zz, j = z[dp], dp * M + torch.arange(M, device=dev)
        for sl in range(1, logD + 1):
            s, half = logL + sl, 1 << (sl - 1)
            v = zz.reshape(b, D >> sl, 2, half, M, FR.n)
            u, w = v[:, :, 0], v[:, :, 1]
            p = torch.arange(half, device=dev)
            idx = (p[:, None] * L + j[None, :]) * (N >> s)     # [half, M]
            t = FR.mul(w, tws[dev][idx][None, None])
            zz = torch.stack([FR.add(u, t), FR.sub(u, t)], dim=2).reshape(
                b, D, M, FR.n)
        z[dp] = zz
    out = [blk.reshape(b, L, FR.n) for blk in _transpose(z, mesh)]
    if inverse:
        out = [FR.mul(blk, FR.const(pow(N, FR_P - 2, FR_P), blk.device))
               for blk in out]
    return torch.cat([_moved(blk, home) for blk in out], dim=1)


class ShardedMSM:
    """A FixedBaseMSM whose rows (the R MSMs of a call) are split over
    a mesh: the bases' table on every device of the mesh (`msm`'s own on
    its device, one built on each other device), and shard i computes
    its block of rows on its device with one g1_msm.  A row is the same
    kernel on the same words, cut into the kernel's warp items as the
    whole matrix's rows are (`plan_rows`), so the result equals
    `msm.compute` word for word."""

    def __init__(self, msm, mesh: Mesh):
        from ..pcs.msm import FixedBaseMSM
        self.mesh, self.home = mesh, msm.points.device
        self.on = {self.home: msm}
        for dev in mesh.devices:
            if dev not in self.on:
                self.on[dev] = FixedBaseMSM(msm.points.to(dev))

    def compute(self, scalars_mont):
        """scalars_mont [R, N, 8] (Montgomery) -> [R, 3, 12] points on the
        bases' device."""
        return self.compute_blocks(shard_rows(scalars_mont, self.mesh,
                                              count=False))

    def compute_blocks(self, blocks):
        """compute of the rows given as blocks already split (block i on
        the mesh's device i: the committed layer's own blocks, `Prover.val`)
        -> the rows' points joined on the bases' device."""
        if len(blocks) > 1:
            COUNTS["splits"] += 1
        rows = sum(b.shape[0] for b in blocks)
        return gather_rows([self.on[b.device].compute(b, rows)
                            for b in blocks], self.home)


def sharded_msm(mesh: Mesh, points, scalars_mont):
    """FixedBaseMSM(points).compute(scalars_mont) ([N, 3, 12] points,
    [R, N, 8] Montgomery scalars -> [R, 3, 12] on the points' device)
    with the rows split over the mesh (`ShardedMSM`)."""
    from ..pcs.msm import FixedBaseMSM
    return ShardedMSM(FixedBaseMSM(points), mesh).compute(scalars_mont)
