from .params import (FR_P, FP_P, LIMB_BITS, LIMB_MASK, root_of_unity,
                     to_limbs, from_limbs)
from .limbs import Field, FR, FP
