"""ctypes bindings for the optional native (C++) builder helpers, with
transparent numpy fallbacks when no toolchain is available."""

import ctypes
import pathlib

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = pathlib.Path(__file__).resolve().parents[2] / "native" \
        / "libzkcnn_native.so"
    if not so.exists():
        try:
            import sys
            sys.path.insert(0, str(so.parents[0]))
            from build import build          # type: ignore
            build()
        except Exception:
            _LIB = False
            return _LIB
    try:
        lib = ctypes.CDLL(str(so))
        lib.emit_nconv_gates.restype = ctypes.c_int64
        lib.subset_compact.restype = ctypes.c_int64
        lib.csv_load.restype = ctypes.c_int64
        _LIB = lib
    except OSError:
        _LIB = False
    return _LIB


def have_native() -> bool:
    return bool(_load())


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def emit_nconv_gates(pic, co, ci, nx_in, ny_in, m, padding, log_stride,
                     first_conv_id, l_code):
    """-> [N, 5] int64 (g, u, v, sc, l) bin-gate block, or None if the
    native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if not lib:
        return None
    nx_out = ((nx_in + 2 * padding - m) >> log_stride) + 1
    ny_out = ((ny_in + 2 * padding - m) >> log_stride) + 1
    cap = pic * co * ci * nx_out * ny_out * m * m
    cols = [np.empty(cap, np.int64) for _ in range(5)]
    n = lib.emit_nconv_gates(
        *(ctypes.c_int64(int(x)) for x in
          (pic, co, ci, nx_in, ny_in, m, padding, log_stride,
           first_conv_id, l_code)),
        *(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) for c in cols))
    return np.stack([c[:n] for c in cols], axis=1)


def subset_compact(ids: np.ndarray, universe: int, scratch=None):
    """First-appearance dedup; returns (ori, remap) or None."""
    lib = _load()
    if not lib:
        return None
    ids = np.ascontiguousarray(ids, np.int64)
    if scratch is None:
        scratch = np.full(universe, -1, np.int64)
    ori = np.empty(ids.size, np.int64)
    remap = np.empty(ids.size, np.int64)
    cnt = lib.subset_compact(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(ids.size),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(universe),
        ori.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        remap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if cnt < 0:
        return None
    return ori[:cnt].copy(), remap


def csv_load(path: str, cap_hint: int = 1 << 24):
    lib = _load()
    if not lib:
        return None
    out = np.empty(cap_hint, np.float64)
    n = lib.csv_load(path.encode(), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)), ctypes.c_int64(cap_hint))
    if n < 0:
        return None
    if n == cap_hint:   # maybe truncated: retry bigger
        return csv_load(path, cap_hint * 4)
    return out[:n].copy()
