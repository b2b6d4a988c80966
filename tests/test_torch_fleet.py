"""The port's Fleet collective (``incubate.fleet``) against the JAX
package, on the CPU.

- The role makers read the launcher's environment as the JAX package's
  do (``test_fleet.py::test_role_makers`` and the other makers).
- One launch of 4 gloo ranks (``torch_dp_runner.py``) runs every
  scenario of this file:
  - ``test_fleet_collective_two_process_parity`` at 4 ranks: its MLP
    under SGD(0.1) through ``fleet.init``, ``distributed_optimizer`` and
    ``fleet.main_program``; each rank's start is shifted but rank 0's
    reaches every rank. The ranks' parameters are bitwise equal, within
    1e-5 of max |ref| of the JAX package's run on the global batch, and
    the mean of the ranks' losses is within rtol 2e-4 of its losses
    (the JAX test itself is skipped on the CPU);
  - ``fleet.startup_program`` from a different seed on every rank ends
    with every persistable equal (its closing broadcasts);
  - tiny BERT (dropout 0) through Fleet, 2 Adam steps, against the JAX
    global-batch run within 1e-5 of the parameters' max |ref| (the
    largest value of any of them, as ``test_torch_bert_dygraph.py``
    holds its model: Adam's normalised step turns the rounding noise of
    near-zero grads into steps of up to lr either way);
  - ``save_checkpoint`` (one copy, by rank 0) and ``load_checkpoint`` on
    every rank with its ``TrainStatus``.
"""
import os

import numpy as np
import pytest

from paddle_tpu.models import bert as jbert

import torch_dp_runner as R
from test_torch_parallel import (N, assert_mean_loss, assert_params_close,
                                 assert_ranks_bitwise, jax_run, launch,
                                 read, save_start)

SCENARIOS = ["fleet_mlp", "fleet_startup", "fleet_bert", "fleet_ckpt"]

ENV = {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "1",
       "PADDLE_TRAINERS_NUM": "2",
       "PADDLE_TRAINER_ENDPOINTS": "127.0.0.1:7000,127.0.0.1:7001",
       "PADDLE_CURRENT_ENDPOINT": "127.0.0.1:7001"}


def _mlp_sgd(fluid):
    loss = R.fleet_mlp(fluid)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return loss


def _bert_adam(fluid):
    s = R.BERT_SHAPE
    out = jbert.bert_pretrain(R.bert_tiny_cfg(jbert), s["B"], s["S"],
                              s["P"])
    fluid.optimizer.AdamOptimizer(1e-3).minimize(out["loss"])
    return out["loss"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fleet"))
    refs = {"fleet_mlp": jax_run(_mlp_sgd, R.fleet_feeds()),
            "bert": jax_run(_bert_adam, R.bert_feeds(jbert))}
    start = {k: save_start(tmp, k, v[0]) for k, v in refs.items()}
    proc = launch(tmp, SCENARIOS, start)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    return {"tmp": tmp, "refs": refs}


@pytest.fixture
def launcher_env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def test_role_makers(launcher_env):
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)
    rm = PaddleCloudRoleMaker()
    assert rm.is_worker() and not rm.is_server()
    assert rm.worker_index() == 1 and rm.worker_num() == 2
    assert rm.get_current_endpoint() == "127.0.0.1:7001"
    rm = UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                              server_endpoints=["127.0.0.1:7100"])
    assert rm.is_server() and rm.get_current_endpoint() == "127.0.0.1:7100"


def _describe(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(),
            rm.worker_index(), rm.worker_num(), rm.server_num(),
            rm.get_trainer_endpoints(), rm.get_pserver_endpoints(),
            rm.get_current_endpoint())


@pytest.mark.parametrize("maker", ["PaddleCloudRoleMaker",
                                   "UserDefinedRoleMaker",
                                   "UserDefinedCollectiveRoleMaker",
                                   "MPISymetricRoleMaker",
                                   "GeneralRoleMaker"])
def test_role_makers_match_jax(launcher_env, maker):
    from paddle_tpu.incubate.fleet.base import role_maker as jrm
    from paddle_tpu_torch.incubate.fleet.base import role_maker as trm
    kwargs = {"UserDefinedRoleMaker": dict(current_id=1, worker_num=3),
              "UserDefinedCollectiveRoleMaker": dict(
                  current_id=1, worker_endpoints=["a:1", "b:2"])
              }.get(maker, {})
    assert _describe(getattr(trm, maker)(**kwargs)) == \
        _describe(getattr(jrm, maker)(**kwargs))


def test_fleet_mlp_matches_jax_global_batch(world):
    ranks = read(world["tmp"], "fleet_mlp")
    _, losses, final = world["refs"]["fleet_mlp"]
    assert_ranks_bitwise(ranks)
    assert_params_close(ranks[0][0], final)
    assert_mean_loss(ranks, losses)
    assert ranks[0][0]["losses"][-1] < ranks[0][0]["losses"][0]
    for r, (_, flags) in enumerate(ranks):
        assert flags["worker_index"] == r and flags["worker_num"] == N
        assert flags["first"] == (r == 0)
        # one per persistable the startup makes: w1, w2, the lr
        assert flags["startup_broadcasts"] == \
            len(world["refs"]["fleet_mlp"][0]) == 3


def test_fleet_startup_program_broadcasts(world):
    assert_ranks_bitwise(read(world["tmp"], "fleet_startup"))


def test_fleet_bert_matches_jax_global_batch(world):
    ranks = read(world["tmp"], "fleet_bert")
    _, losses, final = world["refs"]["bert"]
    assert_ranks_bitwise(ranks)
    assert_params_close(ranks[0][0], final, model=True)
    assert_mean_loss(ranks, losses)


def test_fleet_checkpoint_under_the_world(world):
    ranks = read(world["tmp"], "fleet_ckpt")
    for r, (_, flags) in enumerate(ranks):
        assert flags == {"status": 3, "equal": True, "checkpoints": 1}, \
            (r, flags)
    assert os.listdir(os.path.join(world["tmp"], "fleet_ckpt")) == \
        ["__paddle_checkpoint__0"]
    assert "_manifest.json" in os.listdir(
        os.path.join(world["tmp"], "fleet_persist"))


def test_distributed_optimizer_needs_init():
    from paddle_tpu_torch.incubate.fleet.collective import Collective
    import paddle_tpu_torch as tfluid
    with pytest.raises(AssertionError, match="fleet.init"):
        Collective().distributed_optimizer(tfluid.optimizer.SGD(0.1))


def test_fleet_in_a_world_of_one_matches_the_plain_run():
    """Without a launcher the fleet is a world of 1: its main program
    trains as the plain program does."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.framework.executor import scope_from_arrays
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        UserDefinedCollectiveRoleMaker)
    from paddle_tpu_torch.incubate.fleet.collective import Collective
    fleet = Collective()
    fleet.init(UserDefinedCollectiveRoleMaker(0, [""]))
    start, losses, final = jax_run(_mlp_sgd, R.fleet_feeds())
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        loss = R.fleet_mlp(tfluid)
        fleet.distributed_optimizer(tfluid.optimizer.SGD(0.1)) \
            .minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(fleet.startup_program, scope=scope)
    scope_from_arrays(scope, start)
    got = [float(exe.run(fleet.main_program, feed=f, fetch_list=[loss],
                         scope=scope)[0]) for f in R.fleet_feeds()]
    np.testing.assert_allclose(got, losses, rtol=2e-4, atol=1e-6)
