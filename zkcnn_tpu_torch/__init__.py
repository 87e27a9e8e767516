"""zkcnn_tpu_torch: the zkCNN (GKR) prover/verifier on PyTorch and CUDA.

A port of `zkcnn_tpu` (JAX/Pallas, the reference, which stays beside
it) to PyTorch with hand-written CUDA kernels for Hopper.  It imports
torch and numpy, never jax or zkcnn_tpu.  Entry points run on the
first CUDA device unless the caller asks for another device (`--cpu`,
`device="cpu"`) and raise when there is no card; they pass the device
down.  The sumcheck round kernels run as CUDA on a CUDA device and as
their plain PyTorch versions on the CPU.

Layer map (same module paths and names as zkcnn_tpu):
  field/    Fr arithmetic on [..., 8] int32 Montgomery words, segment
            sums, field matmul, the round kernels (round_kernels.py)
  csrc/     CUDA C++ sources of the kernels (built by cuda_build.py)
  mle/      beta/eq and phi tables, folds, round-message helpers
  ntt/      batched radix-2 field NTT
  circuit/  layered circuit IR, subset compaction, layer evaluation
  nn/       quantizer, layer emitters, model zoo, witness generation
  gkr/      sumcheck engines, prover, verifier, seeded tape
  cli/      demo entry points with the reference argv and result row
  interop   numpy-level bridge from zkcnn_tpu objects (tests only)
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: the one asked for, else the
    first CUDA device.  Raises when none was asked for and there is no
    card: the CPU is taken only on request."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "zkcnn_tpu_torch runs on a CUDA device and found none: pass "
            "device=\"cpu\" (--cpu on the command line) to run on the CPU")
    return torch.device("cuda")
