from .ntt import ntt, intt
