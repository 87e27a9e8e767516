"""zkcnn_tpu_torch.parallel's `sharded_dot` and `sharded_segment_sum`
against the JAX package's functions of the same name
(zkcnn_tpu/parallel/sharding.py, shard_map over a mesh of the virtual CPU
devices that tests/conftest.py makes) on the same numpy inputs, over 2
and 4 shards (the port's on CPU meshes of ["cpu"] * D), tolerance 0.
The split inits of the proof path route each gate chunk to its shard
(`gkr/kernels.py`) instead of the segment sum's full-length partials;
these two stay the tested primitives the JAX package has.
"""

import jax
import numpy as np
import jax.numpy as jnp
import torch

from zkcnn_tpu.parallel import sharding as JS
from zkcnn_tpu_torch.parallel import make_mesh, sharded_dot, \
    sharded_segment_sum
from tests.test_torch_chunked import _fields, _j, _same

torch.set_num_threads(1)


def test_sharded_dot_and_segment_sum_equal_the_jax_package():
    rng = np.random.default_rng(61)
    N, S = 1 << 7, 24
    a, b = _fields(rng, N), _fields(rng, N)
    segs = torch.from_numpy(rng.integers(0, S, N))
    assert len(jax.devices()) >= 4
    for D in (2, 4):
        jmesh = JS.make_mesh(D)
        mesh = make_mesh(D, devices=["cpu"] * D)
        got = sharded_dot(mesh, a, b)
        _same(JS.sharded_dot(jmesh)(_j(a), _j(b)), got)
        got = sharded_segment_sum(mesh, a, segs, S)
        _same(JS.sharded_segment_sum(jmesh, S)(
            _j(a), jnp.asarray(segs.numpy().astype(np.int32))), got)
