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
phase call on the device (every operand whole).  "takes" counts the
indexed gathers from row blocks (`take_rows`: a gate's operand read by
its global row), "take_bytes" the indices sent to the owning shards and
the rows copied back, "routes" the gate chunks of a split init routed to
the shards that own their scatter rows (`gkr/kernels.py`), "route_bytes"
their gate rows, "reblocks" the prefixes of a split tensor put into
another split (`prefix_blocks`) or joined whole (`row_range`).

The witness (`gkr/prover.py`: `Prover.val`), the gate blocks and the
inits' column accumulators are split as the engines' operands are; the
resident bytes a shard holds of each are kept in `RESIDENT` (`hold`,
`drop`, reset by `reset_counts`): by shard (its place in the block
list, 0 for a tensor that stayed whole) and kind ("val", "gates",
"acc", and "replicated" for the whole tables each shard reads, counted
on every shard that reads them, also where the copy is the table itself
because the shards share a device), the bytes held now and the
high-water mark, of each kind and of "val", "gates" and "acc" together
("split").  It is an account of the blocks' bytes, not of the
allocator: four shards on one card show what four cards would each
hold.
"""

from contextlib import contextmanager
from typing import List, Optional

import torch

COUNTS = {k: 0 for k in ("splits", "gathers", "partials", "transposes",
                         "bytes", "peer_bytes", "host_tape_phases",
                         "device_tape_phases", "takes", "take_bytes",
                         "routes", "route_bytes", "reblocks")}

KINDS = ("val", "gates", "acc", "replicated")
SPLIT_KINDS = ("val", "gates", "acc")
RESIDENT = {"now": {}, "high": {}}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0
    RESIDENT["now"].clear()
    RESIDENT["high"].clear()


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _account(kind: str, shard: int, n: int):
    now = RESIDENT["now"].setdefault(shard, dict.fromkeys(KINDS, 0))
    high = RESIDENT["high"].setdefault(
        shard, dict.fromkeys(KINDS + ("split",), 0))
    now[kind] += n
    high[kind] = max(high[kind], now[kind])
    high["split"] = max(high["split"], sum(now[k] for k in SPLIT_KINDS))


def hold(kind: str, blocks, shard: Optional[int] = None, sign: int = 1):
    """Account the bytes of blocks (a list, block i on shard i, one
    tensor on `shard`, or byte counts in their place) as resident of
    `kind` (module docstring)."""
    if isinstance(blocks, int):
        _account(kind, shard or 0, sign * blocks)
    elif torch.is_tensor(blocks):
        _account(kind, shard or 0, sign * _nbytes(blocks))
    else:
        for i, b in enumerate(blocks):
            if b is not None:
                _account(kind, i, sign * (b if isinstance(b, int)
                                          else _nbytes(b)))


def drop(kind: str, blocks, shard: Optional[int] = None):
    """Take what `hold` accounted off again."""
    hold(kind, blocks, shard, -1)


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


def split_count(N: int, mesh: Optional[Mesh] = None,
                min_block: int = 2) -> int:
    """The number of row blocks `shard_rows` makes of N rows: the mesh's
    D, or 1 when there is no mesh or one of one device, or when D does
    not divide N or a block would hold fewer than min_block rows (the
    JAX rule: no split below 2D rows; the tail rounds run on one device
    anyway)."""
    mesh = mesh or _MESH
    if mesh is None:
        return 1
    D = mesh.size
    if D == 1 or N % D or N // D < max(min_block, 2):
        return 1
    return D


def shard_rows(x, mesh: Optional[Mesh] = None, min_block: int = 2,
               count: bool = True) -> List[torch.Tensor]:
    """x split over the mesh (the active one when none is given): its D
    contiguous row blocks, block i on device i, each in storage of its
    own (a block left on x's device is copied, so that it never keeps
    the rest of x alive: the first card would otherwise hold all of a
    witness layer for as long as its block lives); [x] itself, on its
    own device, where `split_count` says 1.  count=False leaves "splits"
    as it is (the witness, which is released, never gathered)."""
    mesh = mesh or _MESH
    if x.dim() == 0 or split_count(x.shape[0], mesh, min_block) == 1:
        return [x]
    D = mesh.size
    L = x.shape[0] // D
    if count:
        COUNTS["splits"] += 1
    return [own_storage(_moved(x[i * L:(i + 1) * L], dev).contiguous())
            for i, dev in enumerate(mesh.devices)]


def own_storage(x):
    """x, or a copy of it where x is a view into a larger storage."""
    return x.clone() if x.untyped_storage().nbytes() != _nbytes(x) else x


def take_rows(blocks, idx, device):
    """The rows of a row-split tensor at the global indices idx ([n]
    int64 on `device`), as [n, ...] on `device`: each index goes to the
    shard that owns its row (one sort of the indices by owner, one fetch
    of the counts), is gathered there and copied back, its bytes counted
    ("takes", "take_bytes"; "peer_bytes" between devices).  One block is
    indexed as it is."""
    if len(blocks) == 1:
        x = blocks[0]
        if x.device == device:
            return x[idx]
        COUNTS["takes"] += 1
        rows = x[_moved(idx, x.device)]
        COUNTS["take_bytes"] += _nbytes(idx) + _nbytes(rows)
        return _moved(rows, device)
    COUNTS["takes"] += 1
    L = blocks[0].shape[0]
    owner = torch.div(idx, L, rounding_mode="floor")
    counts = torch.bincount(owner, minlength=len(blocks)).tolist()
    order = torch.argsort(owner, stable=True)
    out = torch.empty((idx.shape[0],) + tuple(blocks[0].shape[1:]),
                      dtype=blocks[0].dtype, device=device)
    at = 0
    for s, (blk, n) in enumerate(zip(blocks, counts)):
        if n:
            pos = order[at:at + n]
            local = idx[pos] - s * L if s else idx[pos]
            rows = blk[_moved(local, blk.device)]
            COUNTS["take_bytes"] += _nbytes(local) + _nbytes(rows)
            out[pos] = _moved(rows, device)
        at += n
    return out


def _rows(blocks):
    return sum(b.shape[0] for b in blocks)


def row_range(blocks, a: int, b: int, device):
    """Rows [a, b) of a row-split tensor joined whole on `device` (one
    piece a block it meets; a copy counted in "reblocks" and "bytes"
    unless the range lies in one block on `device`)."""
    L = blocks[0].shape[0]
    pieces = [blk[max(a - i * L, 0):min(b - i * L, L)]
              for i, blk in enumerate(blocks)
              if i * L < b and (i + 1) * L > a]
    if len(pieces) == 1 and pieces[0].device == device:
        return pieces[0]
    COUNTS["reblocks"] += 1
    COUNTS["bytes"] += sum(_nbytes(p) for p in pieces)
    return torch.cat([_moved(p, device) for p in pieces])


def prefix_blocks(blocks, n: int, min_block: int = 2):
    """The first n rows of a row-split tensor (zero rows past its end) as
    `shard_rows` would split them under the active mesh, without a whole
    copy on one device: where the split of n matches the blocks' own,
    the blocks themselves; where each new block lies inside one old
    block, a slice of it, copied to its shard's device when that is
    another ("reblocks"); else (no split of n, or rows to pad) the rows
    joined on the first block's device and split again."""
    N, home = _rows(blocks), blocks[0].device
    D = split_count(n, min_block=min_block) if n <= N else 1
    if D > 1 and len(blocks) > 1:
        L, T = blocks[0].shape[0], n // D
        if T == L:
            return list(blocks)
        if L % T == 0:
            COUNTS["reblocks"] += 1
            out = []
            for t, dev in enumerate(_MESH.devices):
                src = blocks[t * T // L]
                off = t * T % L
                out.append(_moved(src[off:off + T], dev))
            return out
    if len(blocks) == 1:
        x = blocks[0][:n]
    else:
        x = row_range(blocks, 0, min(n, N), home)
    if x.shape[0] < n:
        x = torch.cat([x, torch.zeros((n - x.shape[0],) + x.shape[1:],
                                      dtype=x.dtype, device=home)])
    return shard_rows(x, min_block=min_block, count=False)


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
