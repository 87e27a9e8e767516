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


def test_demo_vgg_entry_builds_vgg_and_needs_a_card(tmp_path,
                                                   monkeypatch):
    """demo_vgg's --model entries are build_model's vgg11 and vgg16 (the
    reference's plans, CIFAR-sized), its --network file is read as the
    vgg config tokens, and without --cpu it raises where there is no
    card; nothing is proven here (tests/test_torch_vgg.py proves a tiny
    vgg)."""
    import torch
    from zkcnn_tpu_torch.cli import demo_vgg
    from zkcnn_tpu_torch.cli.runner import build_model
    from zkcnn_tpu_torch.nn import models as zoo
    args = finish_args(base_arg_parser("t").parse_args(
        ["--synthetic", "--cpu"]))
    for name, cls, convs in (("vgg11", zoo.vgg11, 8), ("vgg16", zoo.vgg16,
                                                       13)):
        nn, psize, ksize = build_model(name, args)
        assert type(nn) is cls and (psize, ksize) == (32, 3)
        assert (nn.pic_size_x, nn.pic_channel) == (32, 3)
        assert sum(len(sec) for sec in nn.conv_section) == convs
        assert [fc.channel_out for fc in nn.full_conn] == [512, 512, 10]
    net = tmp_path / "net.txt"
    net.write_text("8 M 16 A")
    with monkeypatch.context() as m:
        m.setattr(demo_vgg, "run", lambda nn, *a: nn)
        nn = demo_vgg.main(["--synthetic", "--cpu", "--network", str(net)])
    assert [[c.channel_out for c in sec] for sec in nn.conv_section] == \
        [[8], [16]]
    assert [p.ty.name for p in nn.pool] == ["MAX", "AVG"]
    assert nn.full_conn[0].channel_in == 8 * 8 * 16
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: nothing to refuse")
    for argv in (["--model", "vgg11"], ["--network", str(net)]):
        with pytest.raises(RuntimeError, match="--cpu"):
            demo_vgg.main(["--synthetic", "--no-pcs"] + argv)
