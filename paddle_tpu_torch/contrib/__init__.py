"""fluid.contrib namespace of the port: only ``mixed_precision``."""
from . import mixed_precision  # noqa: F401
