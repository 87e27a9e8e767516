"""Input/parameter sources for model building.

The reference streams doubles from two csv files in a fixed order
(image, then per-layer kernel/bias as each layer is built; reference
src/neuralNetwork.cpp:805-897, format README.md:34-58).  We model that
as a `TensorSource` that yields flat float64 arrays on demand, with
constructors for the reference csv format and for synthetic data (the
repo's demo data archive is absent upstream, .MISSING_LARGE_BLOBS:1).
"""

import numpy as np


class TensorSource:
    """Sequential source of float64 values (whitespace-separated stream
    semantics, like ifstream >> double)."""

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, np.float64).ravel()
        self.pos = 0

    def take(self, n: int) -> np.ndarray:
        if self.pos + n > self.values.size:
            raise ValueError(
                f"input source exhausted: need {n}, have "
                f"{self.values.size - self.pos}")
        out = self.values[self.pos:self.pos + n]
        self.pos += n
        return out


def csv_source(path: str) -> TensorSource:
    """Whitespace/comma separated doubles, entire file.  Uses the
    native loader when built (native/zkcnn_native.cpp)."""
    try:
        from . import native
        vals = native.csv_load(path)
        if vals is not None:
            return TensorSource(vals)
    except Exception:
        pass
    with open(path) as f:
        txt = f.read().replace(",", " ")
    return TensorSource(np.array(txt.split(), np.float64))


class _LazyRandomSource(TensorSource):
    def __init__(self, seed: int, lo: float, hi: float):
        self.rng = np.random.default_rng(seed)
        self.lo, self.hi = lo, hi

    def take(self, n: int) -> np.ndarray:
        return self.rng.uniform(self.lo, self.hi, n)


def random_source(seed: int, lo=-1.0, hi=1.0) -> TensorSource:
    """Unbounded synthetic stream (demo data is absent upstream)."""
    return _LazyRandomSource(seed, lo, hi)
