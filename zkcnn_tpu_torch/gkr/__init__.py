from .tape import Tape, FiatShamirTape
from .prover import Prover
from .verifier import Verifier

__all__ = ["Tape", "FiatShamirTape", "Prover", "Verifier"]
