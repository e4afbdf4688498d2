from .hahi import HAHIHeteroNeck
from .positional_encoding import SinePositionalEncoding

__all__ = ["HAHIHeteroNeck", "SinePositionalEncoding"]
