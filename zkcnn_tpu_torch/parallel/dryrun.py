"""Complete proofs of the three tiny models split over a device mesh,
each held to its one-device transcript (counterpart of
`__graft_entry__.dryrun_multichip`).

    python -m zkcnn_tpu_torch.parallel.dryrun [N] [--cpu]

proves `ccnn4_max`, `sconv_muladd` and `tiny_fc_fft` (random_source(24),
`Tape(b"dryrun-<name>")`, the sqrt Hyrax commitment) with the witness,
every sumcheck phase and the commitment split over N shards (default 4:
the first N cards, or N shards on the CPU with --cpu) and asserts each
transcript digest and proof size equal to `PINNED_1CHIP`, the models'
one-device pins.
"""

import sys
import time

from .context import make_mesh, use_mesh

# 1-device transcript digests and proof sizes of the tiny models (seed
# 24, Tape(b"dryrun-<name>"), the sqrt commitment): the JAX package's pins
PINNED_1CHIP = {
    "ccnn4_max": {
        "digest": "1b867d59ffc8f98a2ee23baf77553cd685234ab0"
                  "84d380bbbb03e0bcfee711e4",
        "proof_size": 5440},
    "sconv_muladd": {
        "digest": "d801eb929b093c9ca85f1a783cd3c5a0459e4c2e"
                  "6f4dd10483e1ca8dea418a16",
        "proof_size": 2752},
    "tiny_fc_fft": {
        "digest": "c18f271efe5df09760a90a2de42921745cfab602"
                  "2cee125825f7954b865041c7",
        "proof_size": 10336},
}


def tiny_models():
    """(name, constructor) of the three tiny models: every layer kind, Liu,
    an FFT convolution with its DOT_PROD cubic phase."""
    from ..nn import NeuralNetwork
    from ..nn import models as zoo
    from ..nn.params import PoolType, ConvType, ConvKernel, PoolKernel, \
        FconKernel

    class tiny_fc_fft(NeuralNetwork):
        """FFT conv -> RELU -> AVG pool -> FC -> RELU -> FC."""

        def __init__(self):
            super().__init__(4, 4, 1, 1)
            self.conv_section.append(
                [ConvKernel(ConvType.FFT, 2, 1, 2, 0, 0)])
            self.pool.append(PoolKernel(PoolType.AVG, 2, 1))
            self.full_conn = [FconKernel(4, 2), FconKernel(3, 4)]

    return [
        ("ccnn4_max", lambda: zoo.ccnn(4, 4, 1, 1, PoolType.MAX)),
        ("sconv_muladd", lambda: zoo.singleConv(6, 1, 1, 3, 2,
                                                ConvType.NAIVE)),
        ("tiny_fc_fft", tiny_fc_fft),
    ]


def dryrun_multichip(n_devices: int, devices=None, log=print) -> dict:
    """Proves the tiny models under a mesh of n_devices shards (on
    `devices`, else the first n_devices cards: `make_mesh`), each with
    its witness built under the mesh, and asserts each digest and proof
    size equal to PINNED_1CHIP.  -> {name: (proof_size, digest)}."""
    from ..gkr import Prover, Verifier, Tape
    from ..nn import random_source
    from ..pcs import HyraxPCS
    mesh = make_mesh(n_devices, devices=devices)
    t0, out = time.time(), {}
    for name, build in tiny_models():
        with use_mesh(mesh):
            C, vals = build().create(random_source(24), device=mesh.first)
            p = Prover(C, vals, own_vals=True)
            v = Verifier(p, C, Tape(b"dryrun-" + name.encode()),
                         pcs=HyraxPCS(mode="sqrt"))
            ok = v.verify()
        pin = PINNED_1CHIP[name]
        got = (p.proof_size, v.transcript_digest)
        if not ok or got != (pin["proof_size"], pin["digest"]):
            raise AssertionError(f"{name} over {mesh}: verified {ok}, "
                                 f"proof size and digest {got}, pinned "
                                 f"{(pin['proof_size'], pin['digest'])}")
        out[name] = got
        log(f"[dryrun {time.time() - t0:6.1f}s] {name}: verified over "
            f"{mesh}, digest and proof size equal to the 1-device pin")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(next((a for a in argv if a.isdigit()), 4))
    dryrun_multichip(n, ["cpu"] * n if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
