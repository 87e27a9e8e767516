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


def segment_sum_field(vals, seg_ids, num_segments: int):
    """Exact modular scatter-add: out[s] = sum of vals[i] with
    seg_ids[i] == s.  vals [G, 8] Montgomery words, seg_ids [G] int64;
    out [S, 8].  Ids outside [0, S) (the JAX package's pad sentinels)
    are dropped: they land in one spare row that is cut off, so no
    index is ever out of range."""
    S = num_segments
    seg = seg_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < S), seg, torch.full_like(seg, S))
    acc = torch.zeros((N_LIMBS, S + 1), dtype=torch.int64,
                      device=vals.device)
    acc.index_add_(1, seg, limbs16(vals))
    return words(FR.mont_sum_cols(acc[:, :S]))
