"""2-D device mesh without topology: the four GPUs of one host are joined
all to all, so the mesh follows the decomposition alone. Runs on virtual
CPU devices (tests/conftest.py provides 8)."""

import jax
import numpy as np
import pytest

from gt4py_tpu.parallel import CartesianMesh
from gt4py_tpu.parallel.mesh import _factor2


def test_four_devices_make_a_square_mesh_in_listed_order():
    devs = jax.devices()[:4]
    mesh = CartesianMesh(devs)
    assert mesh.shape == (2, 2)
    assert [d.id for d in mesh.device_grid.ravel()] == [d.id for d in devs]
    assert mesh.mesh.axis_names == ("x", "y")


def test_ij_shards_land_on_their_own_devices():
    """Each device holds exactly its (I, J) block, all of K: the sharding
    spreads the array over the four devices instead of keeping it on one."""
    mesh = CartesianMesh(jax.devices()[:4])
    x = np.arange(8 * 6 * 3, dtype=np.float64).reshape(8, 6, 3)
    xd = mesh.shard_ij(x)
    shards = {s.device.id: s for s in xd.addressable_shards}
    assert len(shards) == 4
    for ix in range(2):
        for iy in range(2):
            shard = shards[mesh.device_grid[ix, iy].id]
            np.testing.assert_array_equal(
                np.asarray(shard.data), x[4 * ix : 4 * ix + 4, 3 * iy : 3 * iy + 3, :]
            )
    y = jax.jit(lambda a: a * 2.0 + 1.0)(xd)
    np.testing.assert_allclose(np.asarray(y), x * 2.0 + 1.0)


def test_explicit_shape_and_mismatch():
    devs = jax.devices()[:4]
    assert CartesianMesh(devs, shape=(1, 4)).shape == (1, 4)
    with pytest.raises(ValueError, match="does not match"):
        CartesianMesh(devs, shape=(3, 2))


@pytest.mark.parametrize("n,expected", [(8, (2, 4)), (4, (2, 2)), (7, (1, 7)), (1, (1, 1))])
def test_factor2(n, expected):
    assert _factor2(n) == expected
