"""Witness debugging utilities (counterpart of `zkcnn_tpu/nn/debug.py`;
reference printLayerValues, src/neuralNetwork.cpp:979-992: exits loudly
on any nonzero value in a layer's must-be-zero region)."""

from ..circuit import Circuit


def check_zero_regions(C: Circuit, vals, raise_on_fail: bool = True):
    """Every layer's [zero_start_id, size) block must be zero.  The zero
    regions carry the bit-ness / reconstruction constraints of the ReLU
    and pooling gadgets, so a violation pinpoints a witness bug before
    any proving happens.  vals: the layers' [N, 8] word tensors (any
    device).  -> [(layer, first nonzero gate)]; raises AssertionError
    on a violation when raise_on_fail."""
    bad = []
    for i, layer in enumerate(C.layers):
        if layer.zero_start_id < layer.size:
            seg = vals[i][layer.zero_start_id:layer.size]
            nz = seg.ne(0).any(dim=-1).nonzero()
            if nz.numel():
                bad.append((i, layer.zero_start_id + int(nz[0, 0])))
    if bad and raise_on_fail:
        raise AssertionError(f"zero-region violations at (layer, gate): "
                             f"{bad}")
    return bad


def layer_summary(C: Circuit) -> str:
    """One line a layer: type, size, gate counts, zero region, FFT bits."""
    lines = []
    for i, ly in enumerate(C.layers):
        lines.append(
            f"{i:3d} {ly.ty.name:12s} size={ly.size:>9d} (2^{ly.bit_length})"
            f" uni={len(ly.uni):>9d} bin={len(ly.bin):>9d}"
            f" zero_start={ly.zero_start_id}"
            + (f" fft_bl={ly.fft_bit_length}" if ly.fft_bit_length >= 0
               else ""))
    return "\n".join(lines)
