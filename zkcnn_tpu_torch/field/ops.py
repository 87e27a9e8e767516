"""Tensor helpers on top of the limb field: signed views, bit selects,
gate scatter-accumulation.  Counterpart of `zkcnn_tpu/field/ops.py`.

`segment_sum_field` replaces the reference's per-gate
`mult_array[u] += beta_g[g] * ...` scatter loops (reference
src/prover.cpp:224-233,286-305).  With int64 limb accumulators an
exact `index_add_` needs no 8-bit plane split: a column stays below
count * 2^16.
"""

import torch

from .params import to_limbs
from .limbs import FR, limbs16, words, normalize, N_LIMBS, _rows


class SignedView:
    """Batched (sign, |v|) decomposition of field elements that encode
    small signed integers (|v| < p/2), mirroring mcl's isNegative /
    getInt64 semantics (x is negative iff its standard form >=
    (p+1)/2)."""

    def __init__(self, f):
        self.f = f
        self.half_limbs = to_limbs((f.p + 1) >> 1, N_LIMBS)

    def split(self, x_mont):
        """-> (neg [...] bool, |v| as [16, ...] plain int64 limbs)."""
        f = self.f
        plain = f.redc(limbs16(x_mont))
        d = plain - _rows(self.half_limbs, plain.dim() - 1, plain.device)
        neg = normalize(d)[N_LIMBS - 1] >= 0          # plain >= half
        pm = f._p_rows(plain.dim() - 1, plain.device) - plain
        normalize(pm)                                 # p - plain >= 0
        return neg, torch.where(neg, pm, plain)

    def to_hilo(self, x_mont):
        """-> (neg, hi32, lo32): |v| as two int64 words (exact for
        |v| < 2^64)."""
        neg, a = self.split(x_mont)
        lo = a[0] | (a[1] << 16)
        hi = a[2] | (a[3] << 16)
        return neg, hi, lo


SIGNED_FR = SignedView(FR)


def bits_to_mont(bits):
    """0/1 tensor [...] -> Montgomery words [..., 8] (0 -> 0, 1 -> R mod
    p), a single select."""
    one = FR.const(1, bits.device)
    return torch.where(bits[..., None] > 0, one,
                       torch.zeros_like(one))


# rows of the modular finish of a segment sum at a time: mont_sum_cols
# pads its columns to [34, rows] int64 and makes [16, rows] temporaries
# a limb, about 1 KB a row, so a finish over 2^24 segments at once would
# hold tens of GB
FINISH_BLOCK = 1 << 20


def segment_cols(num_segments: int, device):
    """An exact limb-column accumulator for `segment_add`: [16, S + 1]
    int64 zeros, the last row the spare row of dropped ids."""
    return torch.zeros((N_LIMBS, num_segments + 1), dtype=torch.int64,
                       device=device)


def segment_add(acc, vals, seg_ids):
    """acc[:, s] += the 16-bit limbs of every vals[i] with seg_ids[i] ==
    s, in place (exact: a column stays below count * 2^16).  Ids outside
    [0, S) (the JAX package's pad sentinels) go to the spare row, so no
    index is ever out of range."""
    S = acc.shape[1] - 1
    seg = seg_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < S), seg, torch.full_like(seg, S))
    acc.index_add_(1, seg, limbs16(vals))
    return acc


def segment_finish(acc):
    """The modular finish of a `segment_cols` accumulator -> [S, 8]
    canonical Montgomery words, FINISH_BLOCK segments at a time (read at
    call time); the spare row is cut off."""
    S = acc.shape[1] - 1
    block = FINISH_BLOCK
    if S <= block:
        return words(FR.mont_sum_cols(acc[:, :S]))
    out = torch.empty((S, FR.n), dtype=torch.int32, device=acc.device)
    for s in range(0, S, block):
        e = min(S, s + block)
        out[s:e] = words(FR.mont_sum_cols(acc[:, s:e]))
    return out


def segment_sum_field(vals, seg_ids, num_segments: int):
    """Exact modular scatter-add: out[s] = sum of vals[i] with
    seg_ids[i] == s.  vals [G, 8] Montgomery words, seg_ids [G] int64;
    out [S, 8].  Ids outside [0, S) are dropped (`segment_add`)."""
    acc = segment_cols(num_segments, vals.device)
    return segment_finish(segment_add(acc, vals, seg_ids))
