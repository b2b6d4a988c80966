"""Fleet execution modes (a copy of the JAX package's; reference
incubate/fleet/base/mode.py)."""

__all__ = ["Mode"]


class Mode:
    """reference mode.py Mode: which fleet backend drives training."""
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3
