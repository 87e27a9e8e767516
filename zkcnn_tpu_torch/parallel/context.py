"""The device mesh a proof is split over (counterpart of
`zkcnn_tpu/parallel/context.py`).

One controller process holds the mesh, an ordered list of torch devices,
and every tensor of the proof; a split tensor is a list of blocks, block
i on device i.  The JAX package's mesh is the same single-controller
design (GSPMD over a `jax.sharding.Mesh`, collectives inside
`shard_map`); here the collectives are copies between devices (peer
copies over NVLink between cards) and `torch.cat`.

Layout: a sumcheck operand [2^l, 8] is split on its leading dimension
into D contiguous row blocks, so the HIGH index bits select the shard
and the pair fold of a round (index bit 0) stays inside a block; only
the round's dots cross devices, and they are summed exactly (as host
integers mod p, or with `FR.sum`).  A block of one row cannot fold
again: the D rows are then gathered onto the tensor's own device, where
the last log2(D) rounds run (`gather_rows`).  `shard_rows` returns the
list of blocks, one block (the tensor itself) when it does not split, so
that the code that runs on the blocks is the same with and without a
mesh.

A mesh may repeat a device (`make_mesh(4, devices=["cpu"] * 4)`, or
four shards on one card): the split path then runs as on D devices,
with every copy local.  `make_mesh` without devices takes the first n
CUDA cards and raises when there are fewer.

`COUNTS`, set to 0 by `reset_counts`: "splits" the operands split by
`shard_rows`, "gathers" the split operands gathered back by
`gather_rows`, "partials" the collections of per-shard partial results
(`gather_parts`: round dots, MSM rows), "transposes" the all-to-all
transposes of the stage-sharded NTT, "bytes" the bytes those copies
moved and "peer_bytes" the share of them that went from one device to
another.  "host_tape_phases" counts the Fiat-Shamir phases under a
mesh that ran their rounds with the tape on the host (a side split;
`gkr/engine.py`, `run_fs`), "device_tape_phases" those that made their
phase call on the device (every operand whole).
"""

from contextlib import contextmanager
from typing import List, Optional

import torch

COUNTS = {k: 0 for k in ("splits", "gathers", "partials", "transposes",
                         "bytes", "peer_bytes", "host_tape_phases",
                         "device_tape_phases")}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered list of torch devices (repeats allowed)."""

    def __init__(self, devices):
        self.devices = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """A mesh of n shards: on `devices` when given (a list of n devices,
    which may repeat one), else on the first n CUDA cards."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"make_mesh: {n_devices} CUDA devices asked "
                               f"for, {have} present; pass devices= to put "
                               f"several shards on one device")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"make_mesh: {n_devices} shards, {len(devices)} "
                         f"devices")
    return Mesh(devices)


_MESH: Optional[Mesh] = None


def active_mesh() -> Optional[Mesh]:
    return _MESH


@contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate a device mesh for every Prover, engine and commitment
    built inside the context."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def _moved(x, dev):
    """x on dev, counting the bytes a copy to another device moves."""
    if x.device != dev:
        n = x.numel() * x.element_size()
        COUNTS["bytes"] += n
        COUNTS["peer_bytes"] += n
    return x.to(dev)


def shard_rows(x, mesh: Optional[Mesh] = None,
               min_block: int = 2) -> List[torch.Tensor]:
    """x split over the mesh (the active one when none is given): its D
    contiguous row blocks, block i on device i; [x] itself, on its own
    device, when there is no mesh or one of one device, or when D does
    not divide its rows or a block would hold fewer than min_block rows
    (the JAX rule: no split below 2D rows; the tail rounds run on one
    device anyway)."""
    mesh = mesh or _MESH
    if mesh is None:
        return [x]
    D, N = mesh.size, x.shape[0]
    if D == 1 or x.dim() == 0 or N % D or N // D < max(min_block, 2):
        return [x]
    L = N // D
    COUNTS["splits"] += 1
    return [_moved(x[i * L:(i + 1) * L], dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def replicate(x, blocks) -> List[torch.Tensor]:
    """x on the device of each of blocks: one copy a shard (x itself on
    x's own device), as an operand that every shard reads whole."""
    return [_moved(x, b.device) for b in blocks]


def gather_parts(parts, device):
    """The collective of per-shard results: every tensor of parts copied
    onto `device` and joined along dim 0 (a new contiguous tensor, also
    when every part lies on `device`); a single part on `device` is
    returned as it is."""
    if len(parts) == 1 and parts[0].device == device:
        return parts[0]
    COUNTS["partials"] += 1
    return _join(parts, device)


def gather_rows(blocks, device):
    """The row blocks of a split operand put back together on `device`
    (a new contiguous tensor); the one block of an operand that did not
    split is returned as it is."""
    if len(blocks) == 1:
        return blocks[0]
    COUNTS["gathers"] += 1
    return _join(blocks, device)


def _join(parts, device):
    COUNTS["bytes"] += sum(p.numel() * p.element_size() for p in parts
                           if p.device == device)
    return torch.cat([_moved(p, device) for p in parts])
