"""The split inits of zkcnn_tpu_torch (gkr/kernels.py under a CPU mesh of
["cpu"] repeated D = 2 and 4 times) against the port's unsplit functions
and the JAX package's of the same name (zkcnn_tpu/gkr/kernels.py) on the
same numpy inputs, tolerance 0:

  * `p1_mult` and `p2_mult` split over D shards (one accumulator of total
    / D rows a shard, each gate chunk routed to the shard that owns the
    row it scatters into: u in phase 1, v in phase 2), the gates as
    tensors and streamed from the host (`HostBlock`), the witness as row
    blocks read through `take_rows`, one output block a shard;
    `p2_uni_add_term` on D pieces of its gates; and the DOT_PROD inits of
    a circuit without structural dims (`dotprod_p1_V0_gates`,
    `dotprod_p2_mult`), their scatters split and V1 contracted a block
    at a time;
  * `pred_uni`, `pred_bin` and `gr_term`: one column partial a gate block
    (any partition), the subset map of `gr_term` split by the shard of
    its ids (`subset_partition`, `subset_blocks`) over a split beta table;
  * the Liu phase's accumulate (`liu_acc` into one column accumulator a
    shard, each shard's ids local to its rows) against the JAX package's
    `liu_plane_acc` and its finish, and the unsplit accumulate.

GATE_CHUNK is lowered to 7 rows so that every block runs several chunks.
"""

import numpy as np
import jax.numpy as jnp
import torch

from zkcnn_tpu.gkr import kernels as JK
from zkcnn_tpu_torch.circuit.eval import two_mul_table
from zkcnn_tpu_torch.circuit.ir import UNI_U, BIN_U, BIN_V
from zkcnn_tpu_torch.parallel import COUNTS, reset_counts
from zkcnn_tpu_torch.field.ops import segment_cols, segment_finish
from zkcnn_tpu_torch.gkr import kernels as K
from zkcnn_tpu_torch.parallel import make_mesh, use_mesh, shard_rows
from tests.test_torch_chunked import CHUNK, _fields, _j, _same, _uni, _bin

torch.set_num_threads(1)

MESHES = (2, 4)


def _rows(x, D):
    with use_mesh(make_mesh(D, devices=["cpu"] * D)):
        blocks = shard_rows(x, count=False)
    assert len(blocks) == D
    return blocks


def _joined(blocks):
    return torch.cat(blocks)


def test_split_phase_inits_equal_the_unsplit_port_and_jax(monkeypatch):
    from zkcnn_tpu.circuit.eval import two_mul_table as j_two_mul
    monkeypatch.setattr(K, "GATE_CHUNK", CHUNK)
    rng = np.random.default_rng(41)
    tm, jtm = two_mul_table("cpu"), j_two_mul()
    for trial in range(2):
        out_bl, u_bl, v_bl = 5, 4 + trial, 3 + trial
        total, n0, nprev = 1 << u_bl, 64, 1 << out_bl
        bg, prev, val0 = _fields(rng, 1 << out_bl), _fields(rng, nprev), \
            _fields(rng, n0)
        ori_v = torch.from_numpy(rng.integers(0, n0, 40))
        sc = len(tm) if trial else 1
        uni = _uni(rng, 45, 1 << out_bl, total, sc, seg=UNI_U)
        b0 = _bin(rng, 30, 1 << out_bl, total, 40, sc, seg=BIN_U)
        b1 = _bin(rng, 38, 1 << out_bl, total, nprev, sc, seg=BIN_U)
        flags = (trial == 0, trial == 0, False)
        whole = K.p1_mult(total, flags, bg, tm, uni, b0, b1, ori_v, val0,
                          prev)
        _same(JK.p1_mult(total, flags, _j(bg), jtm, _j(uni), _j(b0),
                         _j(b1), _j(ori_v), _j(val0), _j(prev)), whole)
        beta_u, vu0, vu1 = _fields(rng, total), _fields(rng, 1)[0], \
            _fields(rng, 1)[0]
        c0 = _bin(rng, 33, 1 << out_bl, total, 1 << v_bl, sc, seg=BIN_V)
        c1 = _bin(rng, 21, 1 << out_bl, total, 1 << v_bl, sc, seg=BIN_V)
        flags2 = (trial == 0, False)
        whole2 = K.p2_mult(1 << v_bl, flags2, bg, beta_u, tm, c0, c1, vu0,
                           vu1)
        _same(JK.p2_mult(1 << v_bl, flags2, _j(bg), _j(beta_u), jtm,
                         _j(c0), _j(c1), _j(vu0), _j(vu1)), whole2)
        add = K.p2_uni_add_term(bg, beta_u, tm, uni, vu0)
        _same(JK.p2_uni_add_term(_j(bg), _j(beta_u), jtm, _j(uni),
                                 jnp.asarray(uni.shape[0]), _j(vu0)), add)
        for D in MESHES:
            shards = ["cpu"] * D
            for host in (False, True):
                gates = [K.HostBlock(g.numpy(), "cpu") if host else g
                         for g in (uni, b0, b1, c0, c1)]
                reset_counts()
                got = K.p1_mult(total, flags, bg, tm, *gates[:3], ori_v,
                                _rows(val0, D), _rows(prev, D), shards=shards)
                assert len(got) == D and all(
                    b.shape[0] == total // D for b in got)
                assert torch.equal(_joined(got), whole), (trial, D)
                # every chunk of every class routed, the bin gates'
                # operands read through an indexed gather a shard's part
                # of a chunk
                assert COUNTS["routes"] == sum(
                    -(-g.shape[0] // CHUNK) for g in (uni, b0, b1))
                bin_chunks = sum(-(-g.shape[0] // CHUNK) for g in (b0, b1))
                assert bin_chunks <= COUNTS["takes"] <= D * bin_chunks
                got = K.p2_mult(1 << v_bl, flags2, bg, beta_u, tm,
                                *gates[3:], vu0, vu1, shards=shards)
                assert torch.equal(_joined(got), whole2), (trial, D)
            with use_mesh(make_mesh(D, devices=["cpu"] * D)):
                pieces = list(torch.tensor_split(uni, D))
                assert torch.equal(K.p2_uni_add_term(bg, beta_u, tm, pieces,
                                                     vu0), add), (trial, D)

    # the DOT_PROD inits of a circuit without structural dims: V0 scattered
    # by u*L + t, mult1 by v, V1 contracted a block of whole fft rows at a
    # time
    L, n_u, n_v = 4, 8, 16
    bg, beta_u, beta_gs = _fields(rng, 32), _fields(rng, n_u), \
        _fields(rng, L)
    prev, vu1 = _fields(rng, n_v * L), _fields(rng, 1)[0]
    gates = _bin(rng, 37, 32, n_u, n_v, 1, l=3, seg=BIN_U)
    v0 = K.dotprod_p1_V0_gates(bg, prev, L, gates, n_u * L)
    _same(JK.dotprod_p1_V0_gates(_j(bg), _j(prev).reshape(n_v, L, -1),
                                 _j(gates), n_u * L), v0)
    gates2 = _bin(rng, 29, 32, n_u, n_v, 1, l=3, seg=BIN_V)
    m1, (v1,) = K.dotprod_p2_mult(bg, beta_u, vu1, gates2, n_v, prev,
                                  beta_gs)
    jm1, jv1 = JK.dotprod_p2_mult(_j(bg), _j(beta_u), _j(vu1), _j(gates2),
                                  jnp.zeros(n_v), _j(prev).reshape(n_v, L, -1),
                                  _j(beta_gs))
    _same(jm1, m1)
    _same(jv1, v1)
    for D in MESHES:
        got = K.dotprod_p1_V0_gates(bg, _rows(prev, D), L, gates, n_u * L,
                                    shards=["cpu"] * D)
        assert len(got) == D and torch.equal(_joined(got), v0), D
        m, v = K.dotprod_p2_mult(bg, beta_u, vu1, K.HostBlock(
            gates2.numpy(), "cpu"), n_v, _rows(prev, D), beta_gs,
            shards=["cpu"] * D)
        assert torch.equal(_joined(m), m1) and torch.equal(_joined(v), v1)


def test_split_predicates_and_gr_term_equal_the_unsplit_port_and_jax(
        monkeypatch):
    monkeypatch.setattr(K, "GATE_CHUNK", CHUNK)
    rng = np.random.default_rng(43)
    tm = two_mul_table("cpu")
    jtm = _j(tm)
    g_bl, u_bl, v_bl = 5, 4, 3
    bg, bu, bv = _fields(rng, 1 << g_bl), _fields(rng, 1 << u_bl), \
        _fields(rng, 1 << v_bl)
    uni = _uni(rng, 50, 1 << g_bl, 1 << u_bl, len(tm))
    gates = _bin(rng, 44, 1 << g_bl, 1 << u_bl, 1 << v_bl, len(tm))
    want_uni = K.pred_uni(bg, bu, tm, uni)
    _same(JK.pred_uni(_j(bg), _j(bu), jtm, _j(uni),
                      jnp.asarray(uni.shape[0])), want_uni)
    want_bin = {t: K.pred_bin(t, bg, bu, bv, tm, gates) for t in (0, 1)}
    for t in (0, 1):
        _same(JK.pred_bin(bool(t), _j(bg), _j(bu), _j(bv), jtm, _j(gates),
                          jnp.asarray(gates.shape[0])), want_bin[t])
    # gr_term: 2^6 input rows, a subset map in no order and one in order
    n_in = 1 << 6
    beta_g = _fields(rng, n_in)
    for ori_np in (rng.integers(0, n_in, 37), np.sort(rng.integers(
            0, n_in, 29))):
        ori = torch.from_numpy(ori_np)
        part = _fields(rng, ori.shape[0])
        want_gr = K.gr_term(beta_g, ori, part)
        _same(JK.gr_term(_j(beta_g), _j(ori), _j(part),
                         jnp.asarray(ori.shape[0])), want_gr)
        for D in MESHES:
            L = n_in // D
            ids = K.subset_blocks(ori_np, K.subset_partition(ori_np, L, D),
                                  L, ["cpu"] * D, "cpu")
            assert sum(x[0].shape[0] for x in ids) == ori.shape[0]
            assert all(x[0].numpy().min(initial=0) >= 0 and
                       x[0].numpy().max(initial=0) < L for x in ids)
            got = K.gr_term(_rows(beta_g, D), ids, part)
            assert torch.equal(got, want_gr), D
    for D in MESHES:
        assert torch.equal(K.pred_uni(bg, bu, tm, list(
            torch.tensor_split(uni, D))), want_uni), D
        for t in (0, 1):
            assert torch.equal(K.pred_bin(t, bg, bu, bv, tm, list(
                torch.tensor_split(gates, D))), want_bin[t]), D


def test_split_liu_accumulate_equals_liu_plane_acc_and_the_unsplit(
        monkeypatch):
    from zkcnn_tpu.field.ops import _segment_sum_finish
    monkeypatch.setattr(K, "GATE_CHUNK", CHUNK)
    rng = np.random.default_rng(47)
    total = 1 << 6
    sides = []
    for n in (40, 23, 64, 9):
        ori_np = rng.integers(0, total, n)
        if n == 64:
            ori_np = np.arange(total)            # one side in order
        sides.append((ori_np, _fields(rng, n)))
    # the JAX package: 8-bit planes into two uint32 accumulators, one
    # finish
    n_limbs = _j(sides[0][1]).shape[1]
    slo = jnp.zeros((total, n_limbs), jnp.uint32)
    shi = jnp.zeros((total, n_limbs), jnp.uint32)
    for ori_np, part in sides:
        slo, shi = JK.liu_plane_acc(slo, shi, _j(part),
                                    jnp.asarray(ori_np.astype(np.int32)))
    want = _segment_sum_finish(slo, shi)
    acc = [segment_cols(total, "cpu")]
    for ori_np, part in sides:
        K.liu_acc(acc, part, torch.from_numpy(ori_np))
    whole = segment_finish(acc[0])
    _same(want, whole)
    for D in MESHES:
        L = total // D
        accs = [segment_cols(L, "cpu") for _ in range(D)]
        for ori_np, part in sides:
            K.liu_acc(accs, part, K.subset_blocks(
                ori_np, K.subset_partition(ori_np, L, D), L, ["cpu"] * D,
                "cpu"))
        got = [segment_finish(a) for a in accs]
        assert all(g.shape[0] == L for g in got)
        assert torch.equal(_joined(got), whole), D
