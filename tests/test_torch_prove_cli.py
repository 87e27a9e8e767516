"""The port's proving tool, zkcnn_tpu_torch/cli/prove.py, on the CPU
(ccnn 8x8, --synthetic seed 17, Tape(b"zkcnn-demo-17"), no commitment;
tolerance 0 throughout):

  * a circuit and witness saved with --snapshot --build-only, loaded
    back, equal a fresh build word for word, and proven from the loaded
    snapshot give the transcript digest and proof size that the JAX
    package's `python tools/prove.py ccnn --cpu --no-warm` prints
    (JAX_TOOL_CCNN, pinned once from that tool; the port's fresh build
    proves to the same digest);
  * --build-only stops before the proof, the stage log lines carry the
    seconds, the RSS and no device memory on the CPU, a failed check
    prints "Verification FAILED" and exits 1, and without --cpu the tool
    raises where there is no card;
  * no module of zkcnn_tpu_torch, nor chip_smoke.py, imports jax or the
    JAX package, and a fresh interpreter that runs the tool has imported
    neither.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from zkcnn_tpu_torch.cli import prove

# one CPU thread a test process: the suite's six xdist workers share
# the machine's cores, and torch's own thread pool in each of them
# made CPU-bound tests ten times slower than alone
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# `python tools/prove.py ccnn --cpu --no-warm` (the JAX package's tool)
JAX_TOOL_CCNN = {
    "digest": "377e81d51a04a611bff84bf2148412fe6bc458eb2bec481987242e5e8c5be30e",
    "row": "ccnn, pcnt=1, WS=1532(2^11)",
    "PS": "7.8438",
}


def test_a_loaded_snapshot_proves_to_the_jax_tools_digest(tmp_path,
                                                          capsys):
    from zkcnn_tpu_torch.nn import models as zoo, random_source
    from zkcnn_tpu_torch.nn.params import PoolType
    snap = str(tmp_path / "ccnn.snap")
    built = prove.main(["ccnn", "--cpu", "--snapshot", snap, "--build-only"])
    assert built["snapshot"]["bytes"] == os.path.getsize(snap) > 0
    assert built["snapshot"]["load_s"] is None
    assert not os.path.exists(snap + ".tmp")
    C, vals = prove.load_snapshot(snap, "cpu")
    Cf, vf = zoo.ccnn(8, 8, 1, 1, PoolType.MAX).create(random_source(17),
                                                       device="cpu")
    assert len(vals) == len(vf) == C.size == Cf.size
    for a, b in zip(vals, vf):
        assert a.device.type == "cpu" and torch.equal(a, b)
    for la, lb in zip(C.layers, Cf.layers):
        assert (la.ty, la.size, la.bit_length, la.size_u, la.size_v) == \
            (lb.ty, lb.size, lb.bit_length, lb.size_u, lb.size_v)
        for k in ("uni", "bin", "ori_id_u", "ori_id_v"):
            np.testing.assert_array_equal(getattr(la, k), getattr(lb, k))
    capsys.readouterr()
    res = prove.main(["ccnn", "--cpu", "--snapshot", snap])
    out = capsys.readouterr()
    assert res["snapshot"]["load_s"] is not None
    assert res["snapshot"]["save_s"] is None
    assert (res["digest"], res["row"]["PS"]) == (JAX_TOOL_CCNN["digest"],
                                                 JAX_TOOL_CCNN["PS"])
    lines = out.out.splitlines()
    assert lines[0].startswith(JAX_TOOL_CCNN["row"] + ", PT=")
    assert lines[0].endswith(f"PS={JAX_TOOL_CCNN['PS']}KB")
    assert lines[1:] == [f"transcript sha256 {JAX_TOOL_CCNN['digest']}",
                         "Verification pass"]
    assert "snapshot loaded from" in out.err


def test_build_only_stops_before_the_proof(capsys, monkeypatch):
    proved = []
    monkeypatch.setattr(prove, "Prover",
                        lambda *a, **k: proved.append(a) or 1 / 0)
    res = prove.main(["ccnn", "--cpu", "--build-only"])
    out = capsys.readouterr()
    assert not proved and out.out == "" and "digest" not in res
    assert res["snapshot"]["bytes"] is None
    log = out.err.splitlines()
    assert log[-1].endswith("build-only: stopping before the proof")
    assert all(line.startswith("[") and "s rss=" in line and "dev=" not in
               line for line in log)
    # a failed check: the message and exit code 1, after the row
    monkeypatch.undo()
    monkeypatch.setattr(prove.Verifier, "verify", lambda self: False)
    with pytest.raises(SystemExit) as e:
        prove.main(["ccnn", "--cpu"])
    assert e.value.code == 1
    assert capsys.readouterr().out.splitlines()[-1] == "Verification FAILED"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: nothing to refuse")
    with pytest.raises(RuntimeError, match="--cpu"):
        prove.main(["ccnn", "--build-only"])


def _imports(path: pathlib.Path):
    """The top-level names a source file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "zkcnn_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(
        _imports(f) & {"jax", "jaxlib", "zkcnn_tpu"}) for f in files}
    assert len(files) > 40
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
    code = (
        "import sys\n"
        "from zkcnn_tpu_torch.cli import prove\n"
        "prove.main(['ccnn', '--cpu', '--build-only'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zkcnn_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
