from .ir import LayerType, Layer, Circuit, ceil_pow2_bit_length

__all__ = ["LayerType", "Layer", "Circuit", "ceil_pow2_bit_length"]
