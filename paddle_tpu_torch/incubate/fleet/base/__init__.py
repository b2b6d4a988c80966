from . import role_maker  # noqa: F401
from . import mode  # noqa: F401
from .mode import Mode  # noqa: F401
from . import fleet_base  # noqa: F401
from .fleet_base import Fleet, DistributedOptimizer  # noqa: F401
