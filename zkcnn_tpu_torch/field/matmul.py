"""Field matrix multiplication, C = A B over Fr.

Counterpart of `zkcnn_tpu/field/matmul.py`.  Torch has no integer
matmul on CUDA, so the contraction runs in float64 on 8-bit planes:
each Montgomery residue splits into 32 byte planes, a plane product is
< 2^16, and a contraction over K rows sums K of them -- exact in
float64 while K * 2^16 * 32 < 2^53 (K < 2^32), far above any layer
here.  A 0/1 routing matmul then adds the plane products into 63
base-2^8 columns (each < 32 * K * 2^16, still exact), which become
int64 base-2^16 columns of sum_k (a_k R)(b_k R) and get one Montgomery
finish.  This sits outside every Pallas kernel of the JAX package, so
it is plain PyTorch on both devices.
"""

import torch

from .limbs import FR, words

_ROUTE = {}


def _route(device):
    """[1024, 63] float64: plane pair (i, j) -> base-2^8 column i + j."""
    key = str(device)
    if key not in _ROUTE:
        i = torch.arange(32).repeat_interleave(32)
        j = torch.arange(32).repeat(32)
        S = torch.zeros((1024, 63), dtype=torch.float64)
        S[torch.arange(1024), i + j] = 1.0
        _ROUTE[key] = S.to(device)
    return _ROUTE[key]


def _planes8(x):
    """[..., 8] int32 words -> [..., 32] float64 byte planes."""
    w = x.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(0, 32, 8, device=x.device)
    b = (w[..., None] >> sh) & 0xFF
    return b.reshape(*x.shape[:-1], 32).to(torch.float64)


def _bmm(A, B):
    """A [T, M, K, 8] x B [T, K, N, 8] -> [T, M, N, 8] Montgomery."""
    T, M, K, _ = A.shape
    N = B.shape[2]
    a2 = _planes8(A).permute(0, 1, 3, 2).reshape(T, M * 32, K)
    b2 = _planes8(B).reshape(T, K, N * 32)
    O = torch.matmul(a2, b2)                       # < K * 2^16, exact
    O = O.reshape(T, M, 32, N, 32).permute(0, 1, 3, 2, 4).reshape(
        T, M, N, 1024)
    c8 = torch.matmul(O, _route(A.device)).to(torch.int64)   # [.., 63]
    c8 = torch.nn.functional.pad(c8, (0, 1))
    c16 = c8[..., 0::2] + (c8[..., 1::2] << 8)     # [.., 32] base 2^16
    return words(FR.dot_reduce_cols(c16.movedim(-1, 0)))


# elements of the [T, M*32, N*32] float64 plane product per piece
_TILE = 1 << 24


def field_batched_matmul(A, B):
    """A [T, M, K, 8] x B [T, K, N, 8] -> [T, M, N, 8]: independent field
    matmuls per leading index (the DOT_PROD witness is one [pic, ci] x
    [ci, co] product per frequency t)."""
    T, M, K, _ = A.shape
    N = B.shape[2]
    ch = max(1, _TILE // (M * N * 1024))
    outs = [_bmm(A[s:s + ch], B[s:s + ch]) for s in range(0, T, ch)]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def field_matmul(A, B):
    """A [M, K, 8] x B [K, N, 8] -> [M, N, 8] (Montgomery), exact."""
    M, K, _ = A.shape
    N = B.shape[1]
    ch = max(1, _TILE // (M * 1024))
    outs = [_bmm(A[None], B[None, :, s:s + ch])[0]
            for s in range(0, N, ch)]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
