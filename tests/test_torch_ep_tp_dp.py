"""Expert parallelism beside tensor and data parallelism in the port:
ep 2 x tp 2 x dp 2 over one launch of 8 gloo ranks
(``tests/torch_ep_mix_runner.py``'s model, capacity factor 0.5), against
the JAX package's run on ``MeshConfig(ep=2, tp=2, dp=2)`` on its
8-device CPU mesh: the losses (the mean over the data coordinates)
within rtol 2e-4, every gathered parameter within 2e-4 of max |ref|,
the slab bitwise its eager steps on every rank.
"""
import pytest

import test_torch_ep_mix as M

GRID = "ep2tp2dp2"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return M.launch([GRID], 8, str(tmp_path_factory.mktemp("mix8")))


def test_losses_match_jax_on_the_same_mesh(world):
    M.check_losses(world, GRID)


def test_parameters_match_jax_on_the_same_mesh(world):
    M.check_params(world, GRID)


def test_run_steps_slab_is_bitwise_its_eager_steps(world):
    for r, (_, flags) in enumerate(world["ranks"]):
        assert flags[GRID]["slab_bitwise"], r


def test_two_data_coordinates_fetch_their_own_rows(world):
    """dp 2 splits the batch: the two data coordinates' losses differ,
    the four ranks of each agree (check_losses)."""
    got = {f[GRID]["coords"]["dcn_dp+dp"]: f[GRID]["losses"]
           for _, f in world["ranks"]}
    assert sorted(got) == [0, 1] and got[0] != got[1]
    print(f"ep 2 x tp 2 x dp 2 launch: {world['seconds']:.1f} s")
