from .params import ConvType, PoolType, ConvKernel, FconKernel, PoolKernel
from .source import TensorSource, csv_source, random_source
from .builder import NeuralNetwork

__all__ = ["ConvType", "PoolType", "ConvKernel", "FconKernel", "PoolKernel",
           "TensorSource", "csv_source", "random_source", "NeuralNetwork"]
