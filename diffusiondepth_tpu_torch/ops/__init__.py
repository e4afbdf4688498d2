"""The port's operations and kernel wrappers. Importing the package
registers the serving path's kernels as ``torch.library`` operators
(``ops/library.py``)."""

from . import library  # noqa: F401
