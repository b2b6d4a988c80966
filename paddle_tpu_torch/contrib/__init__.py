"""fluid.contrib namespace of the port: ``mixed_precision`` and
``extend_with_decoupled_weight_decay``."""
from . import mixed_precision  # noqa: F401
from .extend_optimizer import extend_with_decoupled_weight_decay  # noqa: F401
