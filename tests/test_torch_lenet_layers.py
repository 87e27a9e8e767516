"""ROADMAP's fault 3.2, layer by layer: the JAX package's prover and
zkcnn_tpu_torch's on LeNet5 (pic_cnt=1, --synthetic --seed 17).

The port proves LeNet on the CPU under Tape(b"zkcnn-demo-17") (three
passes) on the JAX package's circuit and witness, carried across by
interop as in tests/test_torch_fs_gkr.py, and keeps its transcript and
its draws.  The JAX package's `Prover` then proves the same circuit and
witness one layer at a time, with the port's incoming state (sumcheck_id,
r_u, r_v, alpha and beta set on it directly, as zkcnn_tpu/gkr/verifier.py
drives it) and the port's challenges: every round polynomial and claim
of every layer, the output layer's evaluation, the input (Liu) phase and
the proof size must be equal (tolerance 0: field elements as integers).
XLA:CPU's programs of a layer are released (`jax.clear_caches()`) before
the next, so that a whole LeNet proof does not run out of memory
mappings.  Slow only: about half an hour on one core.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from zkcnn_tpu.field import FR as JFR
from zkcnn_tpu.gkr import Prover as JProver
from zkcnn_tpu.nn import random_source as j_random_source
from zkcnn_tpu.nn import models as j_zoo
from zkcnn_tpu.nn.params import PoolType as JPoolType
from zkcnn_tpu_torch.circuit.ir import LayerType
from zkcnn_tpu_torch.gkr import Prover, Verifier, Tape
from zkcnn_tpu_torch.interop import circuit_from_jax, vals_from_jax

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

# LeNet5 pic_cnt=1, random_source(17), Tape(b"zkcnn-demo-17"), no
# commitment: the port's digest, pinned in tests/test_torch_e2e.py
PINNED_LENET_DIGEST = \
    "3ffb56eaac141bde0071a6debbd0c8871385aeb16878983c6c2242648af12647"


def _ints(x):
    """A JAX transcript piece as host ints: a [n] claim -> int; a list of
    [sub, k, n] round-poly stacks -> a list of k-tuples."""
    if isinstance(x, int):
        return x
    if isinstance(x, list):
        polys = []
        for s in x:
            a = np.asarray(s)
            ints = JFR.unpack_mont_host(a.reshape(-1, a.shape[-1]))
            k = a.shape[1]
            polys += [tuple(ints[j:j + k]) for j in range(0, len(ints), k)]
        return polys
    return JFR.unpack_mont_host(np.asarray(x).reshape(1, -1))[0]


def _release():
    jax.clear_caches()
    gc.collect()


@pytest.mark.slow
def test_lenet_layers_match_the_jax_prover():
    Cj, vj = j_zoo.lenet(32, 32, 1, 1, JPoolType.MAX).create(
        j_random_source(17))

    # the port's proof, its transcript kept after the fetch
    p = Prover(circuit_from_jax(Cj), vals_from_jax(vj))
    v = Verifier(p, p.C, Tape(b"zkcnn-demo-17"))
    kept, fetch = {}, v._fetch_transcript
    v._fetch_transcript = lambda recs: (fetch(recs), kept.update(recs))
    assert v.verify()
    assert v.transcript_digest == PINNED_LENET_DIGEST
    _release()

    jp = JProver(Cj, vj)
    C = Cj
    wrong = []
    if _ints(jp.v_res_dev(v.r_u[C.size])) != kept["vres"]:
        wrong.append("output layer's evaluation")
    jp.sumcheck_init_all(v.r_u[C.size])
    for rec in kept["layers"]:
        i = rec["i"]
        cur = C.layers[i]
        name = f"layer {i} {cur.ty.name}"
        jp.sumcheck_id = i + 1
        jp.r_u[i + 1], jp.r_v[i + 1] = v.r_u[i + 1], v.r_v[i + 1]
        jp.sumcheck_init(rec["alpha"], rec["beta"])
        got = {}
        if cur.ty.name == LayerType.DOT_PROD.name:
            jp.sumcheck_dotprod_init_phase1()
            got["polys1"] = _ints(jp.run_rounds_cubic(v.r_u[i]))
            jp.account_cubic(got["polys1"])
            got["cu0"] = 0
            got["cu1"] = _ints(jp.dotprod_finalize1_dev(v.r_u[i])[0])
        else:
            jp.sumcheck_init_phase1(rec["relu_rou"])
            got["polys1"] = _ints(jp.run_rounds_quad(v.r_u[i]))
            got["cu0"], got["cu1"] = map(_ints, jp.finalize1_dev(v.r_u[i]))
        if cur.need_phase2:
            jp.sumcheck_init_phase2()
            got["polys2"] = _ints(jp.run_rounds_quad(v.r_v[i]))
            got["cv0"], got["cv1"] = map(_ints, jp.finalize2_dev(v.r_v[i]))
        for key, val in got.items():
            if val != rec[key]:
                wrong.append(f"{name}: {key}")
        _release()
    jp.sumcheck_liu_init(kept["sig_u"], kept["sig_v"])
    if _ints(jp.run_rounds_quad(v.r_u[0])) != kept["liu_polys"]:
        wrong.append("input layer (Liu): round polynomials")
    if _ints(jp.liu_finalize_dev(v.r_u[0])) != kept["eval_in"]:
        wrong.append("input layer (Liu): eval_in")
    if jp.proof_size != p.proof_size:
        wrong.append(f"proof size {jp.proof_size} against {p.proof_size}")
    assert not wrong, wrong
