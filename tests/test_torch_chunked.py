"""The port's gate-chunk contract on the CPU: the chunked inits, the
verifier's predicates and gr_term (gkr/kernels.py), the chunked layer
evaluation (circuit/eval.py), the blocked beta table (mle/beta.py) and the
segment sum split into an accumulate and a blockwise finish
(field/ops.py), each with its chunk lowered to a few rows, against the
JAX package's unchunked functions on the same numpy inputs, through
interop (tolerance 0).  Shapes are random; segment ids sit on both sides
of chunk edges and values include rows of p - 1."""

import numpy as np
import jax.numpy as jnp
import torch

from zkcnn_tpu.gkr import kernels as JK
from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.field.params import FR_P
from zkcnn_tpu_torch.gkr import kernels as K
from zkcnn_tpu_torch.circuit.ir import UNI_G, UNI_U, UNI_LU, UNI_SC, \
    BIN_G, BIN_U, BIN_V, BIN_SC, BIN_L
from zkcnn_tpu_torch.interop import limbs16_to_words, words_to_limbs16

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

CHUNK = 7          # GATE_CHUNK and EVAL_CHUNK: several chunks, a ragged end


def _fields(rng, n):
    """n Montgomery residues as port words: random, with rows of p - 1
    and 0 mixed in."""
    xs = [int.from_bytes(rng.bytes(32), "little") % FR_P for _ in range(n)]
    for i in rng.choice(n, size=max(1, n // 4), replace=False):
        xs[i] = FR_P - 1 if i % 3 else 0
    return torch.from_numpy(np.stack([FR.words_host(x) for x in xs]))


def _j(t):
    """Port words (or int64 ids) -> the JAX package's array."""
    if t.dtype == torch.int64:
        return jnp.asarray(t.numpy().astype(np.int32))
    return jnp.asarray(words_to_limbs16(t))


def _same(j, t):
    np.testing.assert_array_equal(limbs16_to_words(np.asarray(j)), t.numpy())


def _edge_ids(rng, n, hi):
    """n ids below hi; the rows next to every CHUNK edge repeat ids that
    also sit on the other side, and 0 and hi - 1 both occur."""
    ids = rng.integers(0, hi, n)
    for e in range(CHUNK, n - 1, CHUNK):
        ids[e - 1] = ids[e] = ids[(e + CHUNK) % n]
    ids[0], ids[-1] = 0, hi - 1
    return ids


def _uni(rng, n, g_hi, u_hi, sc_hi, seg=UNI_G):
    g = np.zeros((n, 4), np.int64)
    g[:, UNI_G] = rng.integers(0, g_hi, n)
    g[:, UNI_U] = rng.integers(0, u_hi, n)
    g[:, seg] = _edge_ids(rng, n, [g_hi, u_hi][seg])
    g[:, UNI_SC] = rng.integers(0, sc_hi, n)
    return torch.from_numpy(g)


def _bin(rng, n, g_hi, u_hi, v_hi, sc_hi, l=3, seg=BIN_G):
    g = np.zeros((n, 5), np.int64)
    g[:, BIN_G] = rng.integers(0, g_hi, n)
    g[:, BIN_U] = rng.integers(0, u_hi, n)
    g[:, BIN_V] = rng.integers(0, v_hi, n)
    if n:
        g[:, seg] = _edge_ids(rng, n, [g_hi, u_hi, v_hi][seg])
    g[:, BIN_SC] = rng.integers(0, sc_hi, n)
    g[:, BIN_L] = l
    return torch.from_numpy(g)


def test_chunked_inits_match_jax(monkeypatch):
    """p1_mult, p2_mult and p2_uni_add_term at GATE_CHUNK = 7 against
    the JAX package's p1_mult, p2_mult and p2_uni_add_term (one program,
    no chunks), on sides of random sizes."""
    from zkcnn_tpu.circuit.eval import two_mul_table as j_two_mul
    from zkcnn_tpu_torch.circuit.eval import two_mul_table
    monkeypatch.setattr(K, "GATE_CHUNK", CHUNK)
    rng = np.random.default_rng(11)
    tm, jtm = two_mul_table("cpu"), j_two_mul()
    for trial in range(3):
        out_bl, u_bl = int(rng.integers(3, 7)), int(rng.integers(2, 6))
        total, n0, nprev = 1 << u_bl, int(rng.integers(20, 60)), 1 << out_bl
        bg, prev, val0 = _fields(rng, 1 << out_bl), _fields(rng, nprev), \
            _fields(rng, n0)
        ori_v = torch.from_numpy(rng.integers(0, n0, 40))
        sc = len(tm) if trial else 1              # trial 0: two_mul[0] only
        uni = _uni(rng, int(rng.integers(1, 50)), 1 << out_bl, total, sc,
                   seg=UNI_U)
        b0 = _bin(rng, int(rng.integers(0, 40)), 1 << out_bl, total, 40, sc,
                  seg=BIN_U)
        b1 = _bin(rng, int(rng.integers(1, 40)), 1 << out_bl, total, nprev,
                  sc, seg=BIN_U)
        flags = (trial == 0, trial == 0, False)
        got = K.p1_mult(total, flags, bg, tm, uni, b0, b1, ori_v, val0, prev)
        want = JK.p1_mult(total, flags, _j(bg), jtm, _j(uni), _j(b0),
                          _j(b1), _j(ori_v), _j(val0), _j(prev))
        _same(want, got)

        beta_u, vu0, vu1 = _fields(rng, total), _fields(rng, 1)[0], \
            _fields(rng, 1)[0]
        v_bl = int(rng.integers(2, 6))
        c0 = _bin(rng, int(rng.integers(1, 40)), 1 << out_bl, total,
                  1 << v_bl, sc, seg=BIN_V)
        c1 = _bin(rng, int(rng.integers(0, 40)), 1 << out_bl, total,
                  1 << v_bl, sc, seg=BIN_V)
        flags = (trial == 0, False)
        got = K.p2_mult(1 << v_bl, flags, bg, beta_u, tm, c0, c1, vu0, vu1)
        want = JK.p2_mult(1 << v_bl, flags, _j(bg), _j(beta_u), jtm,
                          _j(c0), _j(c1), _j(vu0), _j(vu1))
        _same(want, got)

        uu = _uni(rng, int(rng.integers(1, 50)), 1 << out_bl, total, sc)
        got = K.p2_uni_add_term(bg, beta_u, tm, uu, vu0)
        want = JK.p2_uni_add_term(_j(bg), _j(beta_u), jtm, _j(uu),
                                  jnp.asarray(uu.shape[0]), _j(vu0))
        _same(want, got)


def test_chunked_predicates_and_gr_term_match_jax(monkeypatch):
    """pred_uni, pred_bin (with and without the constants) and gr_term
    at GATE_CHUNK = 7 against the JAX package's, one program each."""
    from zkcnn_tpu.circuit.eval import two_mul_table as j_two_mul
    from zkcnn_tpu_torch.circuit.eval import two_mul_table
    monkeypatch.setattr(K, "GATE_CHUNK", CHUNK)
    rng = np.random.default_rng(12)
    tm, jtm = two_mul_table("cpu"), j_two_mul()
    for trial in range(3):
        nb = [1 << int(rng.integers(2, 7)) for _ in range(3)]
        bg, bu, bv = (_fields(rng, n) for n in nb)
        n = int(rng.integers(1, 60))
        uni = _uni(rng, n, nb[0], nb[1], len(tm))
        got = K.pred_uni(bg, bu, tm, uni)
        want = JK.pred_uni(_j(bg), _j(bu), jtm, _j(uni), jnp.asarray(n))
        _same(want, got)
        gates = _bin(rng, int(rng.integers(1, 60)), nb[0], nb[1], nb[2],
                     len(tm), l=trial)
        for use_tm in (False, True):
            got = K.pred_bin(use_tm, bg, bu, bv, tm, gates)
            want = JK.pred_bin(use_tm, _j(bg), _j(bu), _j(bv), jtm,
                               _j(gates), jnp.asarray(gates.shape[0]))
            _same(want, got)
        ori = torch.from_numpy(_edge_ids(rng, int(rng.integers(1, 60)),
                                         nb[0]))
        part = _fields(rng, 1 << (ori.shape[0] - 1).bit_length())
        got = K.gr_term(bg, ori, part)
        want = JK.gr_term(_j(bg), _j(ori), _j(part),
                          jnp.asarray(ori.shape[0]))
        _same(want, got)


def test_segment_sum_beta_table_and_layer_evaluation_match_jax(monkeypatch):
    """The segment sum as accumulate-then-finish at FINISH_BLOCK = 8 (an
    accumulator fed in chunks, then the blockwise finish), the beta table
    built in blocks of 2^2 rows, and eval_normal_layer at EVAL_CHUNK = 7,
    against the JAX package's segment_sum_field, beta_table and
    eval_normal_layer."""
    from zkcnn_tpu.field.ops import segment_sum_field as j_segment_sum
    from zkcnn_tpu.mle.beta import beta_table as j_beta
    from zkcnn_tpu.circuit import ir as jir
    from zkcnn_tpu.circuit.eval import eval_normal_layer as j_eval
    from zkcnn_tpu_torch.circuit import Layer, LayerType
    from zkcnn_tpu_torch.circuit import eval as ev
    from zkcnn_tpu_torch.field import ops
    from zkcnn_tpu_torch.mle import beta
    monkeypatch.setattr(ops, "FINISH_BLOCK", 8)
    monkeypatch.setattr(beta, "BETA_BLOCK_BITS", 2)
    monkeypatch.setattr(ev, "EVAL_CHUNK", CHUNK)
    rng = np.random.default_rng(13)
    for S, n in ((5, 30), (8, 17), (37, 100)):
        vals = _fields(rng, n)
        seg = torch.from_numpy(_edge_ids(rng, n, S))
        seg[3] = S + 4                          # out of range: dropped
        acc = ops.segment_cols(S, "cpu")
        for s in range(0, n, CHUNK):
            ops.segment_add(acc, vals[s:s + CHUNK], seg[s:s + CHUNK])
        got = ops.segment_finish(acc)
        keep = seg < S
        want = j_segment_sum(_j(vals[keep]), _j(seg[keep]), S)
        _same(want, got)
        _same(want, ops.segment_sum_field(vals, seg, S))

    for ell, init in ((0, 3), (2, 5), (5, 1), (7, FR_P - 1)):
        r = [int.from_bytes(rng.bytes(32), "little") % FR_P
             for _ in range(ell)]
        r[:1] = [FR_P - 1][:ell]
        _same(j_beta(r, init), beta.beta_table(r, init, "cpu"))

    for trial in range(3):
        bl, n0, nprev = int(rng.integers(3, 7)), int(rng.integers(9, 40)), \
            int(rng.integers(9, 40))
        val0, prev = _fields(rng, n0), _fields(rng, nprev)
        uni = _uni(rng, int(rng.integers(1, 40)), 1 << bl, min(n0, nprev),
                   442).numpy()
        uni[:, UNI_LU] = rng.integers(0, 2, uni.shape[0])
        b = _bin(rng, int(rng.integers(1, 40)), 1 << bl, min(n0, nprev),
                 min(n0, nprev), 442).numpy()
        b[:, BIN_L] = rng.integers(0, 4, b.shape[0])
        scale = [1, 7, FR_P - 2][trial]
        jl, tl = jir.Layer(jir.LayerType.NCONV), Layer(LayerType.NCONV)
        for ly in (jl, tl):
            ly.bit_length, ly.scale, ly.uni, ly.bin = bl, scale, uni, b
        got = ev.eval_normal_layer(tl, val0, prev)
        want = j_eval(jl, _j(val0), _j(prev))
        _same(want, got)
