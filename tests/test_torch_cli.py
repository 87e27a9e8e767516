"""The port's demo entry on the CPU: a small proof prints the 16-column
row; the Hyrax commitment is the default and --no-pcs is required to
leave it out (tests/test_torch_pcs_e2e.py runs the entry with it)."""

import pytest

from zkcnn_tpu_torch.cli import demo_lenet
from zkcnn_tpu_torch.cli.runner import OUT_COLS, base_arg_parser, finish_args


def test_demo_cli_runs_and_requires_no_pcs():
    res = demo_lenet.main(["--synthetic", "--model", "ccnn", "--no-pcs",
                           "--cpu"])
    assert res["digest"] and res["proof_size"] > 0
    assert res["line"].split(", ")[:16] == [res["row"][c] for c in OUT_COLS]
    assert [res["row"][c] for c in ("POLY_PT", "POLY_VT", "POLY_PS")] == \
        ["0.0000"] * 3
    assert res["row"]["TOT_PS"] == res["row"]["PS"]
    parse = lambda argv: finish_args(base_arg_parser("t").parse_args(argv))
    assert parse(["--synthetic", "--cpu", "--no-pcs"]).no_pcs is True
    assert parse(["--synthetic", "--cpu"]).no_pcs is False


def test_entry_points_without_a_gpu_raise_unless_cpu_is_asked_for():
    """Without --cpu / device="cpu" the runner and NeuralNetwork.create
    take the first CUDA device and raise where there is none; they never
    fall back to the CPU on their own."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: nothing to refuse")
    with pytest.raises(RuntimeError, match="--cpu"):
        demo_lenet.main(["--synthetic", "--model", "ccnn", "--no-pcs"])
    from zkcnn_tpu_torch.nn import models as zoo, random_source
    from zkcnn_tpu_torch.nn.params import PoolType
    with pytest.raises(RuntimeError, match='device="cpu"'):
        zoo.ccnn(4, 4, 1, 1, PoolType.MAX).create(random_source(24))
