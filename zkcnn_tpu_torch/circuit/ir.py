"""Layered-circuit IR: dense index tensors instead of gate-object lists.

TPU-native re-expression of the reference's circuit layer (reference
src/circuit.h:15-88, src/circuit.cpp:4-100):

  * `uniGate{g,u,lu,sc}` lists become one int64 array [Nu, 4]
  * `binGate{g,u,v,sc,l}` lists become one int64 array [Nb, 5]
  * gate source-layer encoding is unchanged: a uni gate reads the input
    layer when lu == 0, else the previous layer; a bin gate's u side
    reads input iff l == 0 and its v side reads input iff (l & 1) == 0
    (reference src/circuit.h:31-32).
  * `sc` indexes the +-2^k constant table `two_mul` where
    two_mul[k] = 2^k for k <= Q_BIT_SIZE and
    two_mul[Q_BIT_SIZE + 1 + k] = -2^k (reference src/circuit.cpp:90-97).

The subset compaction `init_subset` mirrors layeredCircuit::initSubset
(reference src/circuit.cpp:4-88) including its first-appearance subset
ordering, so that the per-layer input reads become dense subspaces and
the final input-consolidation sumcheck stays linear.
"""

from dataclasses import dataclass, field as dfield
from enum import Enum
from typing import List, Optional

import numpy as np

from ..field.params import FR_P


class LayerType(Enum):
    INPUT = 0
    FFT = 1
    IFFT = 2
    ADD_BIAS = 3
    RELU = 4
    SQR = 5
    OPT_AVG_POOL = 6
    MAX_POOL = 7
    AVG_POOL = 8
    DOT_PROD = 9
    PADDING = 10
    FCONN = 11
    NCONV = 12
    NCONV_MUL = 13
    NCONV_ADD = 14


def ceil_pow2_bit_length(n: int) -> int:
    """ceil(log2(n)); -1 for n == 0 (the reference's sentinel,
    src/utils.cpp:23-25)."""
    if n <= 0:
        return -1
    return (n - 1).bit_length() if n > 1 else 0


UNI_G, UNI_U, UNI_LU, UNI_SC = 0, 1, 2, 3
BIN_G, BIN_U, BIN_V, BIN_SC, BIN_L = 0, 1, 2, 3, 4

_EMPTY4 = np.zeros((0, 4), np.int64)
_EMPTY5 = np.zeros((0, 5), np.int64)


@dataclass
class Layer:
    ty: LayerType
    size: int = 0
    bit_length: int = -1
    zero_start_id: int = 0
    need_phase2: bool = False
    fft_bit_length: int = -1
    scale: int = 1                      # field element (plain int mod p)
    uni: np.ndarray = dfield(default_factory=lambda: _EMPTY4.copy())
    bin: np.ndarray = dfield(default_factory=lambda: _EMPTY5.copy())
    # filled by init_subset:
    size_u: List[int] = dfield(default_factory=lambda: [0, 0])
    size_v: List[int] = dfield(default_factory=lambda: [0, 0])
    bit_length_u: List[int] = dfield(default_factory=lambda: [-1, -1])
    bit_length_v: List[int] = dfield(default_factory=lambda: [-1, -1])
    max_bl_u: int = 0
    max_bl_v: int = 0
    ori_id_u: Optional[np.ndarray] = None
    ori_id_v: Optional[np.ndarray] = None

    def set_size(self, size: int, ty: LayerType):
        """Mirror initLayer (reference src/utils.cpp:193-197)."""
        self.size = self.zero_start_id = size
        self.bit_length = ceil_pow2_bit_length(size)
        self.ty = ty

    def update_size(self):
        self.max_bl_u = max(self.bit_length_u[0], self.bit_length_u[1])
        self.max_bl_v = 0
        if self.need_phase2:
            self.max_bl_v = max(self.bit_length_v[0], self.bit_length_v[1])

    def u_reads_input(self):
        """Mask over bin gates whose u side reads layer 0."""
        return self.bin[:, BIN_L] == 0

    def v_reads_input(self):
        return (self.bin[:, BIN_L] & 1) == 0


def _first_appearance_remap(ids: np.ndarray):
    """Subset compaction with the reference's first-appearance ordering
    (src/circuit.cpp:16-47).  Returns (ori_ids, remapped) where
    ori_ids[k] is the original id of subset slot k and remapped[i] is
    the subset slot of ids[i]."""
    if ids.size == 0:
        return np.zeros(0, np.int64), ids
    try:
        from ..nn import native
        if ids.size > (1 << 16):
            res = native.subset_compact(ids, int(ids.max()) + 1)
            if res is not None:
                return res
    except Exception:
        pass
    uniq_sorted, first_idx = np.unique(ids, return_index=True)
    appearance_rank = np.argsort(np.argsort(first_idx))
    remapped = appearance_rank[np.searchsorted(uniq_sorted, ids)]
    ori = uniq_sorted[np.argsort(appearance_rank)]
    return ori.astype(np.int64), remapped.astype(np.int64)


@dataclass
class Circuit:
    layers: List[Layer]
    two_mul: List[int]                  # 2*(Q_BIT_SIZE+1) field constants

    @staticmethod
    def init(q_bit_size: int, n_layers: int) -> "Circuit":
        """Mirror layeredCircuit::init (reference src/circuit.cpp:90-100)."""
        two_mul = [0] * ((q_bit_size + 1) << 1)
        two_mul[0] = 1
        two_mul[q_bit_size + 1] = FR_P - 1
        for i in range(1, q_bit_size + 1):
            two_mul[i] = (two_mul[i - 1] * 2) % FR_P
            two_mul[i + q_bit_size + 1] = FR_P - two_mul[i]
        return Circuit([Layer(LayerType.INPUT) for _ in range(n_layers)],
                       two_mul)

    @property
    def size(self) -> int:
        return len(self.layers)

    def init_subset(self):
        """Mirror layeredCircuit::initSubset (src/circuit.cpp:4-88)."""
        for i in range(1, self.size):
            cur, lst = self.layers[i], self.layers[i - 1]
            has_pre_u = cur.ty in (LayerType.FFT, LayerType.IFFT)
            has_pre_v = False

            uni_in = cur.uni[:, UNI_LU] == 0
            bin_u_in = cur.u_reads_input()
            bin_v_in = cur.v_reads_input()
            has_pre_u |= bool((~uni_in).any()) or bool((~bin_u_in).any())
            has_pre_v |= bool((~bin_v_in).any())

            # u-subset: uni gates (in emission order) then bin gates
            u_ids = np.concatenate([cur.uni[uni_in, UNI_U],
                                    cur.bin[bin_u_in, BIN_U]])
            ori_u, remap_u = _first_appearance_remap(u_ids)
            n_uni = int(uni_in.sum())
            cur.uni[uni_in, UNI_U] = remap_u[:n_uni]
            cur.bin[bin_u_in, BIN_U] = remap_u[n_uni:]
            cur.ori_id_u = ori_u
            cur.size_u[0] = int(ori_u.size)

            v_ids = cur.bin[bin_v_in, BIN_V]
            ori_v, remap_v = _first_appearance_remap(v_ids)
            cur.bin[bin_v_in, BIN_V] = remap_v
            cur.ori_id_v = ori_v
            cur.size_v[0] = int(ori_v.size)

            cur.bit_length_u[0] = ceil_pow2_bit_length(cur.size_u[0])
            cur.bit_length_v[0] = ceil_pow2_bit_length(cur.size_v[0])

            if has_pre_u:
                if cur.ty == LayerType.FFT:
                    cur.size_u[1] = 1 << (cur.fft_bit_length - 1)
                    cur.bit_length_u[1] = cur.fft_bit_length - 1
                elif cur.ty == LayerType.IFFT:
                    cur.size_u[1] = 1 << cur.fft_bit_length
                    cur.bit_length_u[1] = cur.fft_bit_length
                else:
                    cur.size_u[1] = lst.size
                    cur.bit_length_u[1] = lst.bit_length
            else:
                cur.size_u[1] = 0
                cur.bit_length_u[1] = -1

            if has_pre_v:
                if cur.ty == LayerType.DOT_PROD:
                    cur.size_v[1] = lst.size >> cur.fft_bit_length
                    cur.bit_length_v[1] = lst.bit_length - cur.fft_bit_length
                else:
                    cur.size_v[1] = lst.size
                    cur.bit_length_v[1] = lst.bit_length
            else:
                cur.size_v[1] = 0
                cur.bit_length_v[1] = -1
            cur.update_size()
