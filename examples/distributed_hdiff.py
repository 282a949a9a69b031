"""Multi-device horizontal diffusion: IJ domain decomposition over a device
mesh with ppermute halo exchange (cartesian path) and a GSPMD-sharded
field-view laplacian (next path).

Runs on any device count (four GPUs of one host, say) — on a one-GPU or
CPU-only host force a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/distributed_hdiff.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    # Force the CPU platform BEFORE any device query when a virtual mesh is
    # requested (backends initialize on first query).
    if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
        jax.config.update("jax_platforms", "cpu")

    from gt4py_tpu.cartesian import gtscript
    from gt4py_tpu.parallel import CartesianMesh, DistributedStencil, shard_field

    Field3D = gtscript.Field[np.float64]

    @gtscript.stencil(backend="jax")
    def hdiff(in_field: Field3D, out_field: Field3D, coeff: Field3D):
        with gtscript.computation("PARALLEL"), gtscript.interval(...):
            lap = 4.0 * in_field[0, 0, 0] - (
                in_field[1, 0, 0] + in_field[-1, 0, 0]
                + in_field[0, 1, 0] + in_field[0, -1, 0]
            )
            flx = lap[1, 0, 0] - lap[0, 0, 0]
            fly = lap[0, 1, 0] - lap[0, 0, 0]
            out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
                flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
            )

    mesh = CartesianMesh()
    print(f"mesh: {mesh.shape} over {len(jax.devices())} devices")

    rng = np.random.default_rng(0)
    shape = (32 * mesh.nx, 32 * mesh.ny, 8)
    dist = DistributedStencil(hdiff, mesh)
    out = dist.apply(
        in_field=rng.random(shape),
        coeff=np.full(shape, 0.05),
        out_field=np.zeros(shape),
    )
    print("cartesian distributed hdiff:", out["out_field"].shape, "done")

    # Field-view path: GSPMD sharding, XLA inserts the halo collectives.
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next.common import Dimension, FieldOffset

    I, J = Dimension("I"), Dimension("J")
    Ioff = FieldOffset("Ioff", source=I, target=(I,))
    Joff = FieldOffset("Joff", source=J, target=(J,))

    @gtx.field_operator
    def lap(phi):
        return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])

    ni, nj = 32 * mesh.nx, 32 * mesh.ny
    phi = shard_field(gtx.as_field({I: ni, J: nj}, rng.random((ni, nj))), mesh)
    # The 5-point laplacian is defined on the interior: ranges (1, n-1).
    out2 = gtx.zeros({I: (1, ni - 1), J: (1, nj - 1)})
    lap(phi, out=out2, offset_provider={"Ioff": I, "Joff": J})
    print("field-view GSPMD laplacian:", out2.ndarray.shape, "done")


if __name__ == "__main__":
    main()
