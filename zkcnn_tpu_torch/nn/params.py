"""Model hyper-parameter records (reference src/neuralNetwork.hpp:17-52)."""

from dataclasses import dataclass
from enum import Enum


class ConvType(Enum):
    FFT = 0
    NAIVE = 1
    NAIVE_FAST = 2


class PoolType(Enum):
    AVG = 0
    MAX = 1
    NONE = 2


class ActType(Enum):
    RELU = 0


@dataclass
class ConvKernel:
    ty: ConvType
    channel_out: int
    channel_in: int
    size: int
    stride_bl: int = 0
    padding: int = -1          # default: size >> 1 (reference hpp:28-30)
    weight_start_id: int = -1
    bias_start_id: int = -1

    def __post_init__(self):
        if self.padding < 0:
            self.padding = self.size >> 1


@dataclass
class FconKernel:
    channel_out: int
    channel_in: int
    weight_start_id: int = -1
    bias_start_id: int = -1


@dataclass
class PoolKernel:
    ty: PoolType
    size: int
    stride_bl: int
