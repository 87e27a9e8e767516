"""Per-layer sumcheck inits and the verifier's predicate evaluations
(counterpart of `zkcnn_tpu/gkr/kernels.py`).

Each function is one logical step as gathers, batched field muls and an
exact segment sum or dot.  Gate tensors are used at their exact size:
the JAX package pads them to power-of-two buckets with sentinel rows to
share compiled programs, which an eager port does not need, so no
sentinel index ever reaches a gather here.  The Liu phase's subset maps
are the one place where a table is longer than its index list; that
table is cut to the list (see prover._liu_parts).

The gate-chunk contract (the JAX package's `*_chunked` forms): the
inits, the predicates and `gr_term` take their gate tensors GATE_CHUNK
rows at a time, so that the gathers and the `FR.mul` temporaries (about
1 KB a row) stay bounded at vgg scale, where a gate list reaches 2^25
rows.  Each chunk adds its exact int64 limb columns into one
accumulator (`segment_add`, or the column sum of a dot) and one modular
finish closes the sum: the columns are exact and integer addition is
associative, so the result is word for word the unchunked one at any
chunk size.  A layer that fits in one chunk runs as one piece.

The split forms (the prover under an active mesh, `gkr/prover.py`): an
init that scatters (`p1_mult`, `p2_mult`, `dotprod_p1_V0_gates`,
`dotprod_p2_mult`) given `shards`, the mesh's D devices, keeps one
column accumulator of total / D rows a shard (accounted as the shard's
"acc", `parallel.context.RESIDENT`) and returns its D finished blocks,
which are the engine's row blocks: each gate class is streamed
GATE_CHUNK rows at a time (a `HostBlock` is uploaded a chunk at a time)
and each chunk's rows are routed to the shard that owns the row they
scatter into (`_route`: one sort by owner, one fetch of the counts), so
every shard's segment sum is local and its gates never stay on its
device longer than a chunk.  A witness argument (val0, prev) may be a
list of row blocks, read through `take_rows`; the tables every shard
reads whole (beta_g, beta_u, two_mul, the subset map, V_u) are copies on
the shard's device, accounted as "replicated".  A sum
(`p2_uni_add_term`, the predicates, `gr_term`) takes any partition of
its gates, a tensor or a list of blocks: one column partial a block, on
the block's device, the exact int64 columns added on the first block's
device, then one finish.  Without shards, or with one block, the code
is the unsplit function's.
"""

import numpy as np
import torch

from ..field import FR
from ..field.limbs import limbs16, words, N_LIMBS
from ..field.ops import segment_cols, segment_add, segment_finish
from ..circuit.ir import UNI_G, UNI_U, UNI_SC, BIN_G, BIN_U, BIN_V, BIN_SC
from ..parallel.context import COUNTS, take_rows, hold, drop, _moved

GATE_CHUNK = 1 << 19   # gate rows a step at a time (read at call time)


class HostBlock:
    """A gate class kept on the host (a [G, k] int64 numpy array) and
    streamed to `device` GATE_CHUNK rows at a time (`_chunks`): a split
    init reads each gate once, so a device holds one chunk of the class
    at a time, however unevenly its rows fall on the shards."""

    def __init__(self, arr, device):
        self.arr, self.device = arr, torch.device(device)
        self.shape = arr.shape

    def chunk_bytes(self) -> int:
        return min(self.shape[0], GATE_CHUNK) * self.arr[:1].nbytes


def _chunks(gates):
    """Windows of GATE_CHUNK rows of a [G, k] gate tensor (a HostBlock's
    uploaded to its device one window at a time)."""
    step = GATE_CHUNK
    for s in range(0, gates.shape[0], step):
        if isinstance(gates, HostBlock):
            yield torch.as_tensor(gates.arr[s:s + step], device=gates.device)
        else:
            yield gates[s:s + step]


def _cols(device):
    """A [16] int64 column accumulator of a modular sum."""
    return torch.zeros(N_LIMBS, dtype=torch.int64, device=device)


def _add_cols(cols, x):
    """cols += the limb columns of the rows of x [n, 8], in place."""
    return cols.add_(limbs16(x).sum(dim=-1))


def _finish_cols(cols):
    """The canonical [8] Montgomery sum the columns hold (the finish of
    `FR.sum` and `FR.dot_mont`)."""
    return words(FR.mont_sum_cols(cols))


def _listed(x):
    return x if isinstance(x, list) else [x]


class _Replicas:
    """The whole tables shard s reads, on its device (each a copy where
    the table lies on another device), accounted as the shard's
    "replicated" bytes while the shard's work runs."""

    def __init__(self, s: int, dev, *tables):
        self.s = s
        self.tables = [None if t is None else _moved(t, dev)
                       for t in tables]

    def __enter__(self):
        for t in self.tables:
            if t is not None:
                hold("replicated", t, self.s)
        return self.tables

    def __exit__(self, *exc):
        for t in self.tables:
            if t is not None:
                drop("replicated", t, self.s)


def _route(ch, col: int, L: int, devices):
    """A gate chunk's rows by the shard of blocks of L that owns their
    column col (the row each scatters into): (shard, its rows on its
    device) for each shard with rows, one sort of the chunk by owner and
    one fetch of the counts on the chunk's device ("routes",
    "route_bytes"; "peer_bytes" between devices)."""
    COUNTS["routes"] += 1
    owner = torch.div(ch[:, col], L, rounding_mode="floor")
    counts = torch.bincount(owner, minlength=len(devices)).tolist()
    order = torch.argsort(owner, stable=True)
    at = 0
    for s, (n, dev) in enumerate(zip(counts, devices)):
        if n:
            part = ch[order[at:at + n]]
            COUNTS["route_bytes"] += part.numel() * part.element_size()
            yield s, _moved(part, dev)
        at += n


def _scatter(total: int, shards, home, classes, body, *tables,
             unit: int = 1):
    """The scatter of an init into total rows: one segment_cols
    accumulator on `home`, or with shards (D devices) one of total / D
    rows a shard.  Each class (gates, col) streams GATE_CHUNK rows at a
    time, each chunk routed to the shards that own its column col (in
    units of `unit` rows); body(acc, row offset, device, the tables on
    it, k, chunk) adds class k's chunk, its ids made local by the
    offset.  -> the finished accumulator, or its D blocks."""
    devices = [torch.device(d) for d in shards] if shards else [home]
    D = len(devices)
    L = total // D
    accs = [segment_cols(L, dev) for dev in devices]
    reps = [_Replicas(s, dev, *tables) for s, dev in enumerate(devices)]
    for s, acc in enumerate(accs):
        hold("acc", acc, s)
        reps[s].__enter__()
    for k, (gates, col) in enumerate(classes):
        for ch in _chunks(gates):
            parts = _route(ch, col, L // unit, devices) if D > 1 \
                else [(0, ch)]
            for s, part in parts:
                body(accs[s], s * L, devices[s], reps[s].tables, k, part)
    out = []
    for s in range(D):
        out.append(segment_finish(accs[s]))
        drop("acc", accs[s], s)
        accs[s] = None
        reps[s].__exit__()
    return out if shards else out[0]


def _local(ids, offset: int):
    return ids - offset if offset else ids


def _sum_blocks(gates, body, *tables):
    """The split sum: one [16] column partial a gate block, on the
    block's device (body(cols, tables on the device, the block)), the
    exact int64 columns added on the first block's device, one finish."""
    gates = _listed(gates)
    home = gates[0].device
    total = None
    for s, g in enumerate(gates):
        cols = _cols(g.device)
        with _Replicas(s, g.device, *tables) as reps:
            body(cols, reps, g)
        cols = _moved(cols, home)
        total = cols if total is None else total.add_(cols)
    return _finish_cols(total)


def p1_mult(total: int, sc0_flags, bg, tm, uni, bin_v0, bin_v1, ori_v,
            val0, prev, shards=None):
    """Phase-1 mult_array for one u-side (reference prover.cpp:224-233):
    mult[u] += beta_g[g]*two_mul[sc] (uni) and += beta_g[g]*V_v*tm[sc]
    (bin), one exact modular segment sum over every gate chunk (JAX
    `p1_mult`, `p1_mult_chunked`).  sc0_flags: (uni_sc0, b_v0_sc0,
    b_v1_sc0) -- a class whose constants are all two_mul[0] = 1 skips
    the multiply.  Split form (module docstring): shards, the gates
    routed by their u, val0 and prev a tensor or row blocks -> mult's
    blocks."""
    val0, prev = _listed(val0), _listed(prev)

    def body(acc, off, dev, reps, k, ch):
        bg, tm, ori_v = reps
        if k == 0:
            c = bg[ch[:, UNI_G]]
            if not sc0_flags[0]:
                c = FR.mul(c, tm[ch[:, UNI_SC]])
            segment_add(acc, c, _local(ch[:, UNI_U], off))
            return
        if k == 1:
            vals = take_rows(val0, ori_v[ch[:, BIN_V]], dev)
        else:
            vals = take_rows(prev, ch[:, BIN_V], dev)
        c = FR.mul(vals, bg[ch[:, BIN_G]])
        if not sc0_flags[k]:
            c = FR.mul(c, tm[ch[:, BIN_SC]])
        segment_add(acc, c, _local(ch[:, BIN_U], off))

    return _scatter(total, shards, bg.device,
                    [(uni, UNI_U), (bin_v0, BIN_U), (bin_v1, BIN_U)], body,
                    bg, tm, ori_v)


def p2_mult(total: int, sc0_flags, bg, beta_u, tm, bin_u0, bin_u1, vu0,
            vu1, shards=None):
    """Phase-2 mult_array for one v-side (reference prover.cpp:286-305):
    mult[v] += beta_g[g]*beta_u[u]*V_u[ub]*tm[sc], over every gate chunk
    (JAX `p2_mult`, `p2_mult_chunked`).  Split form: shards, the gates
    routed by their v -> mult's blocks."""
    def body(acc, off, dev, reps, ub, ch):
        bg, beta_u, tm = reps[:3]
        c = FR.mul(bg[ch[:, BIN_G]], beta_u[ch[:, BIN_U]])
        if not sc0_flags[ub]:
            c = FR.mul(c, tm[ch[:, BIN_SC]])
        segment_add(acc, FR.mul(c, reps[3 + ub]), _local(ch[:, BIN_V], off))

    return _scatter(total, shards, bg.device,
                    [(bin_u0, BIN_V), (bin_u1, BIN_V)], body, bg, beta_u,
                    tm, _table(vu0, bg), _table(vu1, bg))


def _table(x, like):
    """A claim that may be a host int (0 for an absent side) as an [8]
    tensor on like's device."""
    return FR.const(x, like.device) if isinstance(x, int) else x


def p2_uni_add_term(bg, beta_u, tm, uni, vu):
    """Phase-2 uni-gate contribution to add_term (prover.cpp:286-291):
    sum_g beta_g[g]*beta_u[u]*tm[sc]*V_u, over every gate chunk (JAX
    `p2_uni_add_term`, `p2_uni_add_term_chunked`); uni a tensor or gate
    blocks."""
    def body(cols, reps, uni):
        bg, beta_u, tm, vu = reps
        for ch in _chunks(uni):
            c = FR.mul(bg[ch[:, UNI_G]], beta_u[ch[:, UNI_U]])
            c = FR.mul(c, tm[ch[:, UNI_SC]])
            _add_cols(cols, FR.mul(c, vu))

    return _sum_blocks(uni, body, bg, beta_u, tm, _table(vu, bg))


def gather_pad(total: int, ori, val0):
    """V-operand for an input-subset side: val0[ori], zero-padded to
    total rows (reference getCirValue at lu==0, prover.cpp:499-501).
    val0 a tensor, or row blocks: then the V blocks of `shard_rows`'s
    split of total rows, shard s's from the ids of its rows."""
    if not isinstance(val0, list):
        V = val0[ori[:total]]
        if V.shape[0] < total:
            V = torch.cat([V, FR.zeros(total - V.shape[0], V.device)])
        return V
    from ..parallel.context import active_mesh, split_count
    D = split_count(total)
    if D == 1:
        home = val0[0].device
        V = take_rows(val0, ori[:total], home)
        if V.shape[0] < total:
            V = torch.cat([V, FR.zeros(total - V.shape[0], home)])
        return [V]
    T = total // D
    out = []
    for s, dev in enumerate(active_mesh().devices):
        ids = _moved(ori[s * T:(s + 1) * T], dev)
        V = take_rows(val0, ids, dev)
        if V.shape[0] < T:
            V = torch.cat([V, FR.zeros(T - V.shape[0], dev)])
        out.append(V)
    return out


def zero_region_scale(bg, relu_rou: int, zero_start: int):
    """Scale the >= zero_start region by relu_rou (prover.cpp:221-222,
    verifier.cpp:76-78)."""
    head = bg[:zero_start]
    tail = FR.mul(bg[zero_start:], FR.const(relu_rou, bg.device))
    return torch.cat([head, tail])


def mul_outer_flat(a, b):
    """[A, 8] x [B, 8] -> [A*B, 8] products (PADDING beta cross table,
    prover.cpp:214-219 / verifier.cpp:81-88)."""
    return FR.mul(a[:, None, :], b[None, :, :]).reshape(
        a.shape[0] * b.shape[0], FR.n)


def contract_counts(prev, bg):
    """FFT/IFFT phase-1 V: contract count dims (prover.cpp:185-197):
    prev [cnt, L, 8] dot bg [cnt, 8] over cnt -> [L, 8]."""
    return FR.dot_mont(prev, bg[:, None, :], axis=0)


def pred_uni(bg, beta_u, tm, uni):
    """Verifier predicatePhase1 uni term (verifier.cpp:89-102):
    sum beta_g[g]*tm[sc]*beta_u[u], over every gate chunk (JAX
    `pred_uni`, `pred_uni_chunked`); uni a tensor or gate blocks."""
    def body(cols, reps, uni):
        bg, beta_u, tm = reps
        for ch in _chunks(uni):
            c = FR.mul(bg[ch[:, UNI_G]], tm[ch[:, UNI_SC]])
            _add_cols(cols, FR.mul(c, beta_u[ch[:, UNI_U]]))

    return _sum_blocks(uni, body, bg, beta_u, tm)


def pred_bin(use_tm: bool, bg, beta_u, beta_v, tm, gates):
    """Verifier predicatePhase2 bin term for one (ub, vb, l) gate group
    (verifier.cpp:104-116): sum beta_g[g]*beta_u[u]*tm[sc]*beta_v[v],
    over every gate chunk (JAX `pred_bin`, `pred_bin_chunked`); gates a
    tensor or gate blocks."""
    def body(cols, reps, gates):
        bg, beta_u, beta_v, tm = reps
        for ch in _chunks(gates):
            c = FR.mul(bg[ch[:, BIN_G]], beta_u[ch[:, BIN_U]])
            if use_tm:
                c = FR.mul(c, tm[ch[:, BIN_SC]])
            _add_cols(cols, FR.mul(c, beta_v[ch[:, BIN_V]]))

    return _sum_blocks(gates, body, bg, beta_u, beta_v, tm)


def gr_term(beta_g, ori, bu):
    """Liu-phase subset predicate term (verifier.cpp:307-333):
    sum_j beta_g[ori[j]] * bu[j] over the subset, GATE_CHUNK ids at a
    time.  Split form: beta_g as row blocks and ori as the subset's
    blocks by the shard of its id (`Prover._liu_blocks`: shard s's ids
    made local to its rows, on its device, and their places j in the
    subset, None for a contiguous range) -> one column partial a shard,
    the columns added on the first shard's device."""
    if not isinstance(beta_g, list):
        return gr_term([beta_g], [(ori, None, 0)], bu)
    home = beta_g[0].device
    total = None
    step = GATE_CHUNK
    for s, (bg, (ids, j, at)) in enumerate(zip(beta_g, ori)):
        b = bu[at:at + ids.shape[0]] if j is None else bu[j]
        b = _moved(b, bg.device)
        cols = _cols(bg.device)
        for k in range(0, ids.shape[0], step):
            c = ids[k:k + step]
            _add_cols(cols, FR.mul(bg[c], b[k:k + c.shape[0]]))
        cols = _moved(cols, home)
        total = cols if total is None else total.add_(cols)
    return _finish_cols(total)


def liu_acc(accs, part, ids):
    """One side's beta part (the beta table over its subset slots, cut to
    the slots that exist) added, GATE_CHUNK rows at a time, into the Liu
    phase's column accumulators (JAX `liu_plane_acc`): ids the side's
    subset map (one accumulator), or split, each shard's (local ids,
    places j or None, start) of `subset_blocks`, the part's rows for them
    copied to its accumulator's device."""
    if torch.is_tensor(ids):
        ids = [(ids, None, 0)]
    step = GATE_CHUNK
    for acc, (loc, j, at) in zip(accs, ids):
        rows = part[at:at + loc.shape[0]] if j is None else part[j]
        rows = _moved(rows, acc.device)
        for s in range(0, loc.shape[0], step):
            segment_add(acc, rows[s:s + step], loc[s:s + step])


def subset_partition(ori, L: int, D: int):
    """The host partition of a subset map (numpy int64 input-layer ids)
    by the shard of D blocks of L rows that owns each id: (order or None
    when the map is already in shard order, the D + 1 cuts)."""
    owner = ori // L
    order = None if np.all(owner[1:] >= owner[:-1]) else \
        np.argsort(owner.astype(np.int16), kind="stable")
    cuts = np.searchsorted(owner if order is None else owner[order],
                           np.arange(D + 1))
    return order, cuts


def subset_blocks(ori, partition, L: int, devices, home):
    """A subset map split as `subset_partition` says: shard s's ids, made
    local to its rows, on devices[s], with their places j in the map (on
    `home`; None for the contiguous range from the start, the third
    item)."""
    order, cuts = partition
    out = []
    for s, dev in enumerate(devices):
        a, b = int(cuts[s]), int(cuts[s + 1])
        j = None if order is None else order[a:b]
        ids = (ori[a:b] if j is None else ori[j]) - s * L
        out.append((torch.as_tensor(np.ascontiguousarray(ids, np.int64),
                                    device=dev),
                    None if j is None else torch.as_tensor(j, device=home),
                    a))
    return out


def dotprod_p1_V0_gates(bg, prev, L: int, gates, total_rows: int,
                        shards=None):
    """DOT_PROD phase-1 per-gate V0 build (prover.cpp:57-101, for
    circuits without structural dims): V0[u*L+t] += beta_g[g] *
    prev[v*L+t], prev's rows a tensor or row blocks read through
    `take_rows`.  Split form: shards, the gates routed by the shard of
    u*L -> V0's blocks."""
    prev = _listed(prev)

    def body(acc, off, dev, reps, k, ch):
        bg, = reps
        t = torch.arange(L, device=dev)
        rows = take_rows(prev, (ch[:, BIN_V][:, None] * L + t).reshape(-1),
                         dev)
        contrib = FR.mul(bg[ch[:, BIN_G]][:, None, :],
                         rows.reshape(-1, L, FR.n))
        seg = ch[:, BIN_U][:, None] * L + t
        segment_add(acc, contrib.reshape(-1, FR.n),
                    _local(seg.reshape(-1), off))

    return _scatter(total_rows, shards, bg.device, [(gates, BIN_U)], body,
                    bg, unit=L)


def dotprod_p2_mult(bg, beta_u, vu1, gates, total: int, prev, beta_gs,
                    shards=None):
    """DOT_PROD phase-2 (prover.cpp:272-305): V1 = contract prev rows
    with the fft beta table; mult1[v] += beta_g[g]*beta_u[u]*V_u1.  prev:
    a tensor or row blocks, each of whole fft rows of beta_gs's length,
    contracted on its own device -> (mult1, V1's blocks).  Split form:
    shards, the gates routed by their v -> mult1's blocks."""
    L = beta_gs.shape[0]
    V1 = []
    for s, blk in enumerate(_listed(prev)):
        with _Replicas(s, blk.device, beta_gs) as (bgs,):
            V1.append(FR.dot_mont(blk.reshape(-1, L, FR.n), bgs[None],
                                  axis=1))

    def body(acc, off, dev, reps, k, ch):
        bg, beta_u, vu1 = reps
        c = FR.mul(FR.mul(bg[ch[:, BIN_G]], beta_u[ch[:, BIN_U]]), vu1)
        segment_add(acc, c, _local(ch[:, BIN_V], off))

    return _scatter(total, shards, bg.device, [(gates, BIN_V)], body, bg,
                    beta_u, _table(vu1, bg)), V1
