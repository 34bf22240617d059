from .round_program import RoundNoise, RoundProgram

__all__ = ["RoundNoise", "RoundProgram"]
