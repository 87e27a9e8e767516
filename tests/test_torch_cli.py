"""The port's demo entry on the CPU: a small proof prints the 16-column
row, and without --no-pcs the runner stops (the PCS is not ported)."""

import pytest

from zkcnn_tpu_torch.cli import demo_lenet
from zkcnn_tpu_torch.cli.runner import OUT_COLS


def test_demo_cli_runs_and_requires_no_pcs():
    res = demo_lenet.main(["--synthetic", "--model", "ccnn", "--no-pcs",
                           "--cpu"])
    assert res["digest"] and res["proof_size"] > 0
    assert res["line"].split(", ")[:16] == [res["row"][c] for c in OUT_COLS]
    with pytest.raises(SystemExit, match="--no-pcs"):
        demo_lenet.main(["--synthetic", "--model", "ccnn", "--cpu"])
