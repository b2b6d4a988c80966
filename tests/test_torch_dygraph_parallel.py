"""dygraph ``DataParallel`` of the port against the JAX package, on the
CPU.

One launch of 4 gloo ranks (``torch_dp_runner.py``): a 2-layer dygraph
MLP wrapped in ``DataParallel`` (each rank with other weights before the
wrap, which broadcasts rank 0's), 3 Adam steps of the reference's step
(``scale_loss``, ``backward``, ``apply_collective_grads``, ``minimize``)
on each rank's rows, eagerly and under ``jit_step``. Every rank's
weights equal rank 0's bitwise, and they are within 1e-4 of max |ref| of
the JAX dygraph's single-process steps on the global batch (the JAX
``apply_collective_grads`` is the identity there); the mean of the
ranks' losses is within rtol 2e-4 of the JAX losses. In a world of 1 the
wrapper changes nothing, as the JAX package's.
"""
import copy
import functools

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import layers as jdylayers

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph import layers as tdylayers
from paddle_tpu_torch.models import layer_params_from_jax

import torch_dp_runner as R
from test_torch_parallel import (assert_params_close, assert_ranks_bitwise,
                                 launch, read, save_start)

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _keep_init_streams():
    """Leave both packages' dygraph init streams as they were: the
    weights of a later test file in this worker process are drawn from
    them."""
    saved = [copy.deepcopy(m._init_rng) for m in (jdylayers, tdylayers)]
    yield
    jdylayers._init_rng, tdylayers._init_rng = saved


@functools.lru_cache(maxsize=1)
def _jax_steps():
    """(start weights, losses, final weights) of the JAX dygraph MLP's 3
    Adam steps on the global batches."""
    with jdy.guard():
        jdylayers.set_init_seed(23)
        model = R.dy_mlp(jdy)
        start = {k: np.array(v) for k, v in model.state_dict().items()}
        opt = jfluid.optimizer.Adam(0.01, parameter_list=model.parameters())
        losses = []
        for x, y in R.dy_feeds():
            loss = jfluid.layers.mean(jfluid.layers.square(
                jfluid.layers.elementwise_sub(model(jdy.to_variable(x)),
                                              jdy.to_variable(y))))
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(np.ravel(loss.numpy())[0]))
        final = {k: np.array(v) for k, v in model.state_dict().items()}
    return start, losses, final


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dy"))
    start, losses, final = _jax_steps()
    proc = launch(tmp, ["dy_mlp"],
                  {"dy_mlp": save_start(tmp, "dy_mlp", start)})
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    return {"tmp": tmp, "losses": losses, "final": final}


@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_data_parallel_mlp_matches_jax_global_batch(world, mode):
    ranks = read(world["tmp"], "dy_mlp")
    keys = [k for k in ranks[0][0] if k.startswith(f"{mode}/")
            and not k.endswith("losses")]
    assert_ranks_bitwise(ranks, keys)
    assert_params_close(ranks[0][0], world["final"], prefix=f"{mode}/",
                        tol=1e-4)
    mean = np.mean([a[f"{mode}/losses"] for a, _ in ranks], axis=0)
    np.testing.assert_allclose(mean, world["losses"], rtol=2e-4, atol=1e-6)


def test_data_parallel_in_a_world_of_one_matches_jax():
    """No process group: DataParallel's scale_loss and
    apply_collective_grads change nothing, in both packages."""
    start, losses, final = _jax_steps()
    with tdy.guard(CPU):
        model = R.dy_mlp(tdy)
        layer_params_from_jax(model, start)
        strategy = tdy.prepare_context()
        assert (strategy.nranks, strategy.local_rank) == (1, 0)
        model = tdy.DataParallel(model, strategy)
        opt = tfluid.optimizer.Adam(0.01, parameter_list=model.parameters())
        got = []
        for x, y in R.dy_feeds():
            loss = tfluid.layers.mean(tfluid.layers.square(
                tfluid.layers.elementwise_sub(model(tdy.to_variable(x)),
                                              tdy.to_variable(y))))
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss)
            model.clear_gradients()
            got.append(float(np.ravel(loss.numpy())[0]))
        state = model.state_dict()
    np.testing.assert_allclose(got, losses, rtol=2e-4, atol=1e-6)
    assert_params_close(state, final, tol=1e-4)


def test_env_reads_the_launcher(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("FLAGS_selected_gpus", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2,c:3,d:4")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "c:3")
    env = tdy.Env()
    assert (env.nranks, env.local_rank, env.dev_id) == (4, 2, 2)
    assert env.trainer_endpoints == ["a:1", "b:2", "c:3", "d:4"]
    assert env.current_endpoint == "c:3"
