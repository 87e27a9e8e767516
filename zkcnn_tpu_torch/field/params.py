"""BLS12-381 field parameters.

The reference uses herumi/mcl's BLS12-381 `Fr` as the proof field and `G1`
for the Hyrax polynomial commitment (reference: src/global_var.hpp:43-44,
main_demo_lenet.cpp:20).  We re-derive every constant from first principles
with exact Python integer arithmetic at import time (cheap), instead of
linking a bignum library.

Limb layout: base-2^16 little-endian limbs stored in uint32 tensors.  16-bit
limbs are the sweet spot for TPU: a product of two limbs fits in uint32
exactly, and schoolbook column sums of up to 2^16 partial products stay below
2^32, so the whole multiplier runs on the VPU's native int32 lanes with no
emulated wide arithmetic.
"""

# BLS12-381 scalar field (Fr) modulus: 255 bits, 2-adicity 32.
FR_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS12-381 base field (Fp) modulus: 381 bits.
FP_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# Multiplicative generator of Fr* (smallest; standard for this curve).
FR_GENERATOR = 7

# 2^32-th primitive root of unity in Fr: g^((p-1)/2^32).
FR_TWO_ADICITY = 32
FR_ROOT_OF_UNITY_32 = pow(FR_GENERATOR, (FR_P - 1) >> FR_TWO_ADICITY, FR_P)


def root_of_unity(logn: int) -> int:
    """2^logn-th primitive root of unity in Fr.

    Semantics match the reference's `getRootOfUnit` (src/utils.cpp:224-232):
    an element w with w^(2^(logn-1)) == -1 (for logn >= 1); logn == 0 -> 1.
    The reference derives it by repeated square roots of -1 in mcl; we derive
    it from the canonical 2^32 root, which satisfies the same defining
    property (any primitive 2^n-th root works as the protocol recomputes all
    tables from the same constant on both sides).
    """
    assert 0 <= logn <= FR_TWO_ADICITY
    if logn == 0:
        return 1
    return pow(FR_ROOT_OF_UNITY_32, 1 << (FR_TWO_ADICITY - logn), FR_P)


def n_limbs_for(p: int) -> int:
    bits = p.bit_length()
    return -(-bits // LIMB_BITS)


def to_limbs(x: int, n: int) -> list:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def from_limbs(limbs) -> int:
    x = 0
    for i, l in enumerate(limbs):
        x |= int(l) << (LIMB_BITS * i)
    return x
