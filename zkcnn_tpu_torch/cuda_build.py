"""Build the CUDA kernels of zkcnn_tpu_torch with nvcc and load them.

The sources in `csrc/` have a plain C interface, so they compile with
nvcc alone (no PyTorch headers) into one shared library that ctypes
loads.  The library lands in `.cuda_build/` at the repository root,
named by a hash of the source and the flags, so an edited source
rebuilds on first use and an unchanged one is reused.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parent
SOURCES = [PKG / "csrc" / "round_kernels.cu"]
BUILD_DIR = PKG.parent / ".cuda_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libzkcnn_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources unless a library for this exact source and
    flag set exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.zk_error_string.argtypes = [I]
    lib.zk_error_string.restype = ctypes.c_char_p
    lib.zk_ladder_scratch_bytes.argtypes = [L, L, I, I]
    lib.zk_ladder_scratch_bytes.restype = L
    N = ctypes.POINTER(I)
    lib.zk_round_ladder.argtypes = [P, P, P, P, P, P, P, L, I, I, P, N]
    lib.zk_round_ladder.restype = I
    lib.zk_cubic_ladder.argtypes = [P, P, P, P, P, P, P, P, P, L, L, I, P, N]
    lib.zk_cubic_ladder.restype = I
    return lib
