"""Build the CUDA kernels of zkcnn_tpu_torch with nvcc and load them.

The sources in `csrc/` have a plain C interface, so they compile with
nvcc alone (no PyTorch headers), each `.cu` into a shared library of
its own that ctypes loads; the compilers of all sources run side by
side.  The libraries land in `.cuda_build/` at the repository root,
named by a hash of the flags and of every file under `csrc/` (headers
included), so an edit to any of them rebuilds on first use and an
unchanged tree is reused.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PKG = pathlib.Path(__file__).resolve().parent
CSRC = PKG / "csrc"
SOURCES = {"round": CSRC / "round_kernels.cu", "g1": CSRC / "g1_kernels.cu"}
BUILD_DIR = PKG.parent / ".cuda_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]
# one build at a time in a process: a caller that needs a library while
# another thread compiles waits for that compile
_BUILDING = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_paths() -> dict:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    tag = h.hexdigest()[:16]
    return {name: BUILD_DIR / f"libzkcnn_{name}_{tag}.so" for name in SOURCES}


def build(verbose: bool = False, log=print) -> dict:
    """Compile every source that has no library for this exact tree and
    flag set, all at once; returns {name: path}.  verbose: the compiler
    reports each kernel's registers and spills (-Xptxas -v), passed to
    `log`."""
    with _BUILDING:
        return _build(verbose, log)


def _build(verbose, log):
    paths = library_paths()
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name} "
                          f"({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            log(err)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _declare(lib, name, restype, argtypes):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load library `name` ("round": the sumcheck
    round kernels, "g1": the curve kernels), with argtypes declared."""
    lib = ctypes.CDLL(str(build()[name]))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    N = ctypes.POINTER(I)
    if name == "round":
        _declare(lib, "zk_error_string", ctypes.c_char_p, [I])
        _declare(lib, "zk_ladder_scratch_bytes", L, [L, L, I, I])
        _declare(lib, "zk_round_ladder", I,
                 [P, P, P, P, P, P, P, L, I, I, P, N])
        _declare(lib, "zk_cubic_ladder", I,
                 [P, P, P, P, P, P, P, P, P, L, L, I, P, N])
        _declare(lib, "zk_round_scratch_bytes", L, [L, I])
        _declare(lib, "zk_fold_round", I, [P, P, P, P, P, P, P, L, P, N])
        _declare(lib, "zk_fold_cubic_round", I,
                 [P, P, P, P, P, P, P, P, P, L, L, P, N])
        _declare(lib, "zk_phase_head_words", I, [])
        _declare(lib, "zk_fold_round_phase_scratch", L, [N, I])
        _declare(lib, "zk_fold_round_phase", I,
                 [P, N, P, P, P, P, P, I, I, P, N])
        _declare(lib, "zk_fold_cubic_round_phase_scratch", L, [L, L, I])
        _declare(lib, "zk_fold_cubic_round_phase", I,
                 [P, P, P, P, P, P, P, L, L, I, P, N])
        _declare(lib, "zk_fs_tape_check", I,
                 [P, P, I, P, P, P, P, P, P, L, P])
    else:
        _declare(lib, "zk_g1_error_string", ctypes.c_char_p, [I])
        _declare(lib, "zk_g1_add", I, [P, P, P, L, P])
        _declare(lib, "zk_g1_scalar_mul", I, [P, P, L, P, L, I, P])
        _declare(lib, "zk_g1_msm_table", I, [P, P, L, I, P, N])
        _declare(lib, "zk_g1_table_chain", I, [P, P, L, I, I, P])
        _declare(lib, "zk_g1_table_digits", I, [P, L, I, P])
        _declare(lib, "zk_g1_table_lanes", None, [N, N])
        _declare(lib, "zk_g1_msm_parts", L, [L])
        _declare(lib, "zk_g1_msm", I, [P, P, P, P, L, L, I, I, I, P, N])
        _declare(lib, "zk_fp_mul", I, [P, P, P, L, L, P])
        _declare(lib, "zk_fp_mul_lanes", I, [P, P, P, L, L, P])
        _declare(lib, "zk_ipa_max_l", L, [])
        _declare(lib, "zk_ipa_round", I, [P, P, P, P, P, P, P, P, L, L, P])
    return lib
