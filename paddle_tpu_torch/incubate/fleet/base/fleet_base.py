"""Fleet abstract base (a copy of the JAX package's; reference
incubate/fleet/base/fleet_base.py: Fleet + DistributedOptimizer). The
port's concrete fleet, Collective (fleet/collective), implements this
contract; the bases exist for user subclassing and isinstance-style
checks, as in the reference."""
import abc

from .mode import Mode  # noqa: F401  (reference re-exports Mode here)

__all__ = ["Fleet", "DistributedOptimizer", "Mode"]


class Fleet(abc.ABC):
    """reference fleet_base.py Fleet: role lifecycle + distributed
    optimizer factory."""

    def __init__(self, mode=Mode.TRANSPILER):
        self._mode = mode
        self._role_maker = None

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    @abc.abstractmethod
    def init_worker(self):
        ...

    @abc.abstractmethod
    def init_server(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def run_server(self):
        ...

    @abc.abstractmethod
    def stop_worker(self):
        ...

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        ...


class DistributedOptimizer(abc.ABC):
    """reference fleet_base.py DistributedOptimizer: wraps a local
    optimizer; minimize() both optimizes and rewrites the program for
    the distributed runtime."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ...
