from .tape import Tape
from .prover import Prover
from .verifier import Verifier

__all__ = ["Tape", "Prover", "Verifier"]
