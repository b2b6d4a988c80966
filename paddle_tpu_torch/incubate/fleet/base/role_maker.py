"""Role makers (a copy of ``paddle_tpu/incubate/fleet/base/role_maker.py``;
reference: python/paddle/fluid/incubate/fleet/base/role_maker.py — Role
:30, PaddleCloudRoleMaker :441 env-based, UserDefinedRoleMaker
:876/:952). The port's launcher (``paddle_tpu_torch.distributed.launch``)
sets the same PADDLE_* environment contract the reference cloud launcher
uses."""
import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = []
        self._server_endpoints = []

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def get_current_endpoint(self):
        eps = (self._worker_endpoints if self.is_worker()
               else self._server_endpoints)
        return eps[self._current_id] if eps else ""

    def generate_role(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-driven (reference role_maker.py:441): TRAINING_ROLE,
    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS,
    PADDLE_PSERVERS_IP_PORT_LIST, POD_IP + PADDLE_PORT."""

    def __init__(self, is_collective=False):
        super().__init__()
        self._is_collective = is_collective
        self.generate_role()

    def generate_role(self):
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._worker_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                      "").split(",") if e]
        if role == "PSERVER":
            self._role = Role.SERVER
            cur = os.environ.get("PADDLE_CURRENT_ENDPOINT") or (
                os.environ.get("POD_IP", "127.0.0.1") + ":" +
                os.environ.get("PADDLE_PORT", "0"))
            self._current_id = (self._server_endpoints.index(cur)
                                if cur in self._server_endpoints else 0)
        else:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            n = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                   str(max(len(self._worker_endpoints), 1))))
            if not self._worker_endpoints:
                self._worker_endpoints = [""] * n

    def worker_num(self):
        return int(os.environ.get(
            "PADDLE_TRAINERS_NUM",
            str(max(len(self._worker_endpoints), 1))))


class UserDefinedRoleMaker(RoleMakerBase):
    """reference role_maker.py:876 — explicit role wiring, no env."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        super().__init__()
        self._current_id = int(current_id)
        self._role = role
        self._server_endpoints = list(server_endpoints or [])
        self._worker_endpoints = list(worker_endpoints or
                                      [""] * int(worker_num))

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    """reference role_maker.py:952 — explicit collective wiring: every
    node is a worker."""

    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._current_id = int(current_id)
        self._role = Role.WORKER
        self._worker_endpoints = list(worker_endpoints or [""])

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)


class MPISymetricRoleMaker(RoleMakerBase):
    """reference role_maker.py MPISymetricRoleMaker: ranks split
    symmetrically — EVEN ranks are servers, ODD ranks are workers,
    worker_num == server_num == size // 2. Re-keyed off the launcher
    env (the reference reads mpi4py COMM_WORLD; the port has no MPI —
    the PADDLE_TRAINER_* contract carries the same rank/size info)."""

    def __init__(self):
        super().__init__()
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        eps = [e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                         "").split(",") if e]
        size = int(os.environ.get("PADDLE_TRAINERS_NUM",
                                  str(max(len(eps), 2))))
        if size % 2 != 0:
            raise ValueError(
                f"MPISymetricRoleMaker needs an even world size "
                f"(got {size}): even ranks serve, odd ranks train")
        eps = eps or [""] * size
        self._server_endpoints = eps[0::2]
        self._worker_endpoints = eps[1::2]
        self._role = Role.SERVER if rank % 2 == 0 else Role.WORKER
        self._current_id = rank // 2

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return max(len(self._server_endpoints), 1)


class GeneralRoleMaker(RoleMakerBase):
    """reference role_maker.py GeneralRoleMaker: env-driven like
    PaddleCloudRoleMaker but with explicit endpoint-list kwargs
    overriding the environment."""

    def __init__(self, current_id=None, role=None,
                 worker_endpoints=None, server_endpoints=None, **kwargs):
        super().__init__()
        env_role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = role if role is not None else (
            Role.SERVER if env_role == "PSERVER" else Role.WORKER)
        self._worker_endpoints = list(worker_endpoints or [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e])
        self._server_endpoints = list(server_endpoints or [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                      "").split(",") if e])
        if current_id is not None:
            self._current_id = int(current_id)
        elif self._role == Role.WORKER:
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID",
                                                  "0"))
        else:
            cur = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
            self._current_id = (self._server_endpoints.index(cur)
                                if cur in self._server_endpoints else 0)

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)
