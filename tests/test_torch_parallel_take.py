"""What a split tensor needs in zkcnn_tpu_torch/parallel/context.py, on CPU
meshes of ["cpu"] repeated D = 2, 4 and 8 times, tolerance 0:

  * `take_rows` (the indexed gather from row blocks: each index to the
    shard that owns it, gathered there, copied back) against plain
    indexing, with indices on both sides of every block boundary, the
    first and last rows, repeats, and an empty index list; its counts;
  * `prefix_blocks` (a prefix re-blocked to the split of its own rows,
    never joined whole where the new blocks lie inside old ones) and
    `row_range` against slicing the joined tensor, with zero rows past
    the end; the split output layer's MLE (`Prover.v_res_dev`'s fold a
    block, then the blocks' values) against `mle_eval_dev`;
  * the resident-byte account (`hold`, `drop`, `RESIDENT`): bytes now
    and high-water marks a shard and a kind, reset by `reset_counts`.
"""

import numpy as np
import torch

from zkcnn_tpu_torch.field import FR
from zkcnn_tpu_torch.mle.fold import mle_eval_dev, fold_ladder
from zkcnn_tpu_torch.parallel import make_mesh, use_mesh, shard_rows, \
    COUNTS, reset_counts
from zkcnn_tpu_torch.parallel.context import take_rows, prefix_blocks, \
    row_range, hold, drop, RESIDENT
from tests.test_torch_chunked import _fields

torch.set_num_threads(1)


def _mesh(D):
    return make_mesh(D, devices=["cpu"] * D)


def test_take_rows_equals_plain_indexing_across_every_block_boundary():
    rng = np.random.default_rng(51)
    N = 64
    x = _fields(rng, N)
    for D in (2, 4, 8):
        L = N // D
        with use_mesh(_mesh(D)):
            blocks = shard_rows(x, count=False)
        assert len(blocks) == D
        # each block in a storage of its own, not a view that would keep
        # the whole of x alive on its device
        assert all(b.untyped_storage().nbytes() == b.numel() *
                   b.element_size() for b in blocks), D
        edges = [b * L + d for b in range(1, D) for d in (-1, 0)]
        idx = np.concatenate([edges, [0, N - 1, 5, 5], rng.integers(
            0, N, 40), edges[::-1]])
        idx = torch.from_numpy(idx.astype(np.int64))
        reset_counts()
        got = take_rows(blocks, idx, "cpu")
        assert torch.equal(got, x[idx]), D
        assert COUNTS["takes"] == 1 and COUNTS["take_bytes"] == \
            idx.shape[0] * (8 + 8 * 4)
        empty = torch.zeros(0, dtype=torch.int64)
        assert take_rows(blocks, empty, "cpu").shape == (0, FR.n)
        # the gate ids of a 2-D index tensor's rows, as the inits read them
        ids = torch.from_numpy(rng.integers(0, N, (9, 3)))
        assert torch.equal(take_rows(blocks, ids[:, 1], "cpu"), x[ids[:, 1]])
    assert torch.equal(take_rows([x], idx, "cpu"), x[idx])


def test_prefixes_row_ranges_and_the_split_output_mle():
    rng = np.random.default_rng(53)
    N = 64
    x = _fields(rng, N)
    rs = [int(v) for v in rng.integers(1, 1 << 62, 6)]
    want_mle = mle_eval_dev(x, rs)
    for D in (2, 4, 8):
        with use_mesh(_mesh(D)):
            blocks = shard_rows(x, count=False)
            for n, min_block in ((64, 2), (32, 2), (16, 2), (8, 2), (4, 2),
                                 (16, 8), (100, 2), (3, 2)):
                reset_counts()
                got = prefix_blocks(blocks, n, min_block)
                want = torch.cat([x[:n], FR.zeros(max(0, n - N), "cpu")])
                assert torch.equal(torch.cat(got), want), (D, n)
                splits = n % D == 0 and n // D >= max(min_block, 2)
                assert len(got) == (D if splits else 1), (D, n, len(got))
                if n == N:
                    assert all(g is b for g, b in zip(got, blocks))
                    assert COUNTS["reblocks"] == 0
            L = N // D
            for a, b in ((0, 64), (3, 9), (L, 2 * L), (5, 60)):
                assert torch.equal(row_range(blocks, a, b, "cpu"), x[a:b])
        # the output layer folded a block at a time, then across blocks
        k = blocks[0].shape[0].bit_length() - 1
        heads = torch.cat([fold_ladder(b, rs[:k]) for b in blocks])
        assert torch.equal(mle_eval_dev(heads, rs[k:]), want_mle), D


def test_the_resident_account_keeps_bytes_and_high_water_a_shard():
    reset_counts()
    a = [torch.zeros(10, 8, dtype=torch.int32),
         torch.zeros(6, 8, dtype=torch.int32)]
    hold("val", a)
    hold("acc", torch.zeros(4, dtype=torch.int64), 1)
    assert RESIDENT["now"][0]["val"] == 320 and \
        RESIDENT["now"][1]["val"] == 192 and RESIDENT["now"][1]["acc"] == 32
    assert RESIDENT["high"][1]["split"] == 224
    drop("acc", torch.zeros(4, dtype=torch.int64), 1)
    hold("replicated", torch.zeros(100, dtype=torch.int64), 1)
    drop("val", a)
    now, high = RESIDENT["now"], RESIDENT["high"]
    assert now[0]["val"] == now[1]["val"] == now[1]["acc"] == 0
    assert high[0] == {"val": 320, "gates": 0, "acc": 0, "replicated": 0,
                       "split": 320}
    assert high[1] == {"val": 192, "gates": 0, "acc": 32,
                       "replicated": 800, "split": 224}
    reset_counts()
    assert RESIDENT == {"now": {}, "high": {}}
