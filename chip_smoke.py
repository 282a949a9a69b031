"""Smoke test on the GPU: the main path of gt4py_tpu once, at the size its
users run, each result checked against the repository's plain reference.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the distributed path on four GPUs

Phases on one GPU, all in this one process (a second process that opens
the card would find its memory taken):

1. Device check: JAX must run on a GPU; the card's name and power limit.
2. GTScript: hdiff, vadv and tridiag at 512x512x80 in float64 and float32
   on the ``gpu`` and ``jax`` backends, one call and a 10-step ``chain``,
   each against the ``numpy`` backend (the float32 hdiff chain step by
   step, see :data:`STEPWISE`); the solvers must be served by the K-sweep
   kernel compiled through Triton.
3. Field view: the hdiff field operator and the tridiagonal
   ``scan_operator`` pair bridged onto ``gpu``, and FVM nabla on a
   1M-vertex mesh, against NumPy oracles.
4. K-sweep kernel against XLA's scan for vadv and tridiag; hdiff against
   the card's peak bandwidth; the memory analysis of each compiled step.
5. The ``gpu``-marked hardware tier (tests/gpu_tests), in this process.

``--four-cards`` runs only the distributed path: ``DistributedStencil``
hdiff and tridiag on a 2x2 mesh over a 1024x1024x80 float64 domain, the
halo-exchange checks of the compiled program, and
``DistributedUnstructured`` nabla on the 1M-vertex mesh.

Every line but the last is a report; the last is one JSON object naming
the device. A failed phase, or no GPU, ends the run with a nonzero exit
and no such line.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

# Before JAX starts: tests/conftest.py then leaves JAX on the GPU for the
# hardware tier run in phase 5.
os.environ.setdefault("GT4PY_TEST_PLATFORM", "gpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

#: Tolerances against the numpy reference, with why: (rtol, atol).
#: float64: the GPU contracts multiply-adds to FMA and orders sums
#: differently; the K recurrences carry that through 80 levels.
F64 = (1e-10, 1e-12)
#: float32 PARALLEL stencils: a few ulps per point.
F32_PARALLEL = (1e-5, 1e-6)
#: float32 K recurrences (vadv, tridiag): the division chains amplify the
#: rounding differences level by level. The systems here are diagonally
#: dominant, as a dycore's are, which keeps the spread well below the
#: 5e-3 that ill-conditioned random systems need.
F32_RECURRENCE = (1e-4, 1e-5)
#: hdiff's flux limiter (``flx = 0 if res * diff > 0 else res``) is
#: discontinuous. Over a float32 chain the state drifts from numpy's by a
#: few ulps a step, and where a neighbour difference ``diff`` lies within
#: that drift of 0 the two take different branches: the point then differs
#: by O(res), a whole flux. Such chains are checked step by step instead
#: (:func:`check_chain_stepwise`), where both sides start from the same
#: state and every point must meet the tolerance.
STEPWISE = {("hdiff", "f32")}
SOLVERS = ("vadv", "tridiag")
#: what must serve the solvers on the ``gpu`` backend: the K-sweep kernel
#: compiled through Triton
KERNEL = "triton"
#: FVM nabla mesh: NABLA_N x NABLA_N vertices (1M), periodic quads
NABLA_N = 1024
#: the four-card domain; each card holds a 512x512x80 share
FOUR_CARD_SHAPE = (1024, 1024, 80)


def tolerance(name: str, precision: str):
    if precision == "f64":
        return F64
    return F32_RECURRENCE if name in SOLVERS else F32_PARALLEL


def check(label: str, got, want, tol, report: bool = True) -> float:
    """``got`` matches ``want`` within ``tol`` at every point; returns the
    largest error scaled by the tolerance's own ``atol / rtol`` floor."""
    got, want = np.asarray(got), np.asarray(want)
    rtol, atol = tol
    assert got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}"
    assert np.all(np.isfinite(got)), f"{label}: non-finite values"
    want64 = want.astype(np.float64)
    err = np.abs(got.astype(np.float64) - want64)
    bad = int(np.count_nonzero(err > atol + rtol * np.abs(want64)))
    assert bad == 0, (
        f"{label}: {bad} of {got.size} points beyond rtol {rtol:g}/atol {atol:g}; "
        f"max abs err {float(err.max()):.3e}"
    )
    rel = float(np.max(err / (np.abs(want64) + atol / rtol)))
    if report:
        print(f"PASS {label}: scaled rel err {rel:.3e} (rtol {rtol:g}, atol {atol:g})", flush=True)
    return rel


def chained_roles(case) -> list:
    """The roles a chain's result is read from: the outputs and every
    swapped role (after the chain a swapped role holds the buffer of the
    role it served in the last step, so hdiff's ``in_field`` holds the last
    step's output and ``out_field`` the one before)."""
    return sorted({*case["outputs"], *case["swap"]})


def check_chain_stepwise(label, st, ref_st, case, backend, tol) -> None:
    """For k = 1..CHAIN_STEPS: ``chain(k)`` on the device against one step
    of the numpy stencil from the device's own ``chain(k - 1)`` state. By
    induction the device's chain is the stencil applied CHAIN_STEPS times,
    and no point is exempt from the tolerance."""
    import bench

    kw = {**case["scalars"], **case["call"]}
    before = {n: a.copy() for n, a in case["arrays"].items()}
    worst = 0.0
    for k in range(1, bench.CHAIN_STEPS + 1):
        stores = bench.storages(case, backend)
        st.chain(k, **stores, swap=case["swap"], **kw)
        bench.block(stores)
        want = {n: a.copy() for n, a in before.items()}
        ref_st.chain(1, **want, swap=case["swap"], **kw)
        for n in chained_roles(case):
            worst = max(worst, check(f"{label} chain({k}) {n}", stores[n], want[n], tol,
                                     report=False))
        before = {n: np.array(s) for n, s in stores.items()}
    rtol, atol = tol
    print(f"PASS {label} chain(1..{bench.CHAIN_STEPS}) step by step, {chained_roles(case)}: "
          f"scaled rel err {worst:.3e} (rtol {rtol:g}, atol {atol:g})", flush=True)


def memory_line(compiled=None) -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    parts = [f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}"]
    if compiled is not None:
        ma = compiled.memory_analysis()
        parts.append(
            f"memory_analysis: arguments {ma.argument_size_in_bytes}, outputs "
            f"{ma.output_size_in_bytes}, temporaries {ma.temp_size_in_bytes}, "
            f"aliased {ma.alias_size_in_bytes}"
        )
    return "; ".join(parts)


def compiled_step(st, case):
    """The compiled executable of one call of ``st`` on ``case``'s shapes."""
    backend = st._backend
    origin = case["call"]["origin"]
    origins = tuple(sorted((n, tuple(origin)) for n in case["arrays"]))
    fn, _ = backend._build(tuple(case["call"]["domain"]), origins, donate=False)
    import jax.numpy as jnp

    arrays = {n: jnp.asarray(a) for n, a in case["arrays"].items()}
    written = {n: a for n, a in arrays.items() if n in backend.written}
    read = {n: a for n, a in arrays.items() if n not in written}
    scalars = {
        n: np.asarray(v, dtype=st.parameter_info[n].dtype)[()]
        for n, v in case["scalars"].items()
    }
    return fn.lower(written, read, scalars).compile()


# --- phase 2: GTScript stencils -----------------------------------------------


def phase_gtscript(timings: dict) -> None:
    import bench

    failed = []
    for name in ("hdiff", "vadv", "tridiag"):
        for precision in bench.PRECISIONS:
            case = bench.cartesian_case(name, precision)
            kw = {**case["scalars"], **case["call"]}
            swap = case["swap"]
            ref_st = bench.build_stencil(case, "numpy")
            ref_call = {n: a.copy() for n, a in case["arrays"].items()}
            ref_st(**ref_call, **kw)
            ref_chain = None
            if (name, precision) not in STEPWISE:
                ref_chain = {n: a.copy() for n, a in case["arrays"].items()}
                ref_st.chain(bench.CHAIN_STEPS, **ref_chain, swap=swap, **kw)
            tol = tolerance(name, precision)
            for backend in ("gpu", "jax"):
                label = f"{name} {precision} {backend}"
                try:
                    _run_case(timings, name, precision, backend, case, ref_st, ref_call,
                              ref_chain, tol)
                except Exception:
                    traceback.print_exc()
                    print(f"FAIL {label}", flush=True)
                    failed.append(label)
    assert not failed, f"failed cases: {failed}"


def _run_case(timings, name, precision, backend, case, ref_st, ref_call, ref_chain, tol):
    import bench

    kw = {**case["scalars"], **case["call"]}
    swap = case["swap"]
    label = f"{name} {precision} {backend}"
    st = bench.build_stencil(case, backend)
    stores = bench.storages(case, backend)
    info: dict = {}
    t0 = time.perf_counter()
    st(**stores, exec_info=info, **kw)
    bench.block(stores)
    compile_call = time.perf_counter() - t0
    want = KERNEL if backend == "gpu" and name in SOLVERS else "xla"
    assert info["kernel"] == want, f"{label}: served by {info['kernel']}, not {want}"
    for out in case["outputs"]:
        check(f"{label} call {out}", stores[out], ref_call[out], tol)
    stores = bench.storages(case, backend)
    info = {}
    st.chain(bench.CHAIN_STEPS, **stores, swap=swap, exec_info=info, **kw)
    bench.block(stores)
    assert info["kernel"] == want, f"{label} chain: served by {info['kernel']}"
    if ref_chain is None:
        check_chain_stepwise(label, st, ref_st, case, backend, tol)
    else:
        for out in chained_roles(case):
            check(f"{label} chain({bench.CHAIN_STEPS}) {out}", stores[out], ref_chain[out], tol)
    call, step = bench.call_and_chain_seconds(st, stores, case)
    timings[(name, precision, backend)] = dict(
        call_ms=call * 1e3, chain_step_ms=step * 1e3, stencil=st, case=case,
    )
    print(f"TIME {label}: first call {compile_call:.2f} s, call {call * 1e3:.3f} ms, "
          f"chain step {step * 1e3:.3f} ms (median; 7 calls, 5 chains)", flush=True)


# --- phase 3: field view ------------------------------------------------------


def phase_field_view() -> None:
    import bench
    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where
    from gt4py_tpu.next.mesh_utils import periodic_quad_mesh
    from tests.cartesian_tests import stencil_defs as defs

    I = Dimension("I")
    J = Dimension("J")
    K = Dimension("K", kind=DimensionKind.VERTICAL)
    Ioff = FieldOffset("Ioff", source=I, target=(I,))
    Joff = FieldOffset("Joff", source=J, target=(J,))

    @gtx.field_operator(backend="gpu")
    def hdiff(inp, coeff):
        lap = 4.0 * inp - (inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1]))
        res1 = lap(Ioff[1]) - lap
        flx = where(res1 * (inp(Ioff[1]) - inp) > 0.0, 0.0, res1)
        res2 = lap(Joff[1]) - lap
        fly = where(res2 * (inp(Joff[1]) - inp) > 0.0, 0.0, res2)
        return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))

    case = bench.cartesian_case("hdiff", "f64")
    inp, coeff = case["arrays"]["in_field"], case["arrays"]["coeff"]
    ni, nj, nk = bench.DOMAIN
    out = gtx.zeros({I: (2, 2 + ni), J: (2, 2 + nj), K: nk})
    hdiff(gtx.as_field([I, J, K], inp), gtx.as_field([I, J, K], coeff), out=out,
          offset_provider={"Ioff": I, "Joff": J})
    variant = next(v for v in hdiff._bridge_cache.values() if v is not None)
    assert variant.backend.last_kernel == "xla", variant.backend.last_kernel
    check("field view hdiff f64 (bridged)", out.ndarray,
          defs.validate_horizontal_diffusion(inp, coeff), F64)

    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def tri_fwd(carry, a: float, b: float, c: float, d: float):
        cp_prev, dp_prev = carry
        denom = b - a * cp_prev
        return (c / denom, (d - a * dp_prev) / denom)

    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def tri_bwd(x_kp1, cp: float, dp: float):
        return dp - cp * x_kp1

    @gtx.field_operator(backend="gpu")
    def tridiag(a, b, c, d):
        cp, dp = tri_fwd(a, b, c, d)
        return tri_bwd(cp, dp)

    case = bench.cartesian_case("tridiag", "f64")
    arrays = case["arrays"]
    ref = {n: a.copy() for n, a in arrays.items()}
    bench.build_stencil(case, "numpy")(**ref, **case["call"])
    out = gtx.zeros({I: ni, J: nj, K: nk})
    tridiag(*(gtx.as_field([I, J, K], arrays[n]) for n in ("inf", "diag", "sup", "rhs")), out=out)
    variant = next(v for v in tridiag._bridge_cache.values() if v is not None)
    assert variant.backend.last_kernel == KERNEL, variant.backend.last_kernel
    check("field view tridiag scan f64 (bridged, K-sweep kernel)", out.ndarray, ref["out"], F64)

    V = Dimension("Vertex")
    E = Dimension("Edge")
    V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
    E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
    V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
    E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))

    @gtx.field_operator(backend="jax")
    def nabla(pp, s_x, sign, vol):
        zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
        return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol

    n = NABLA_N
    e2v, v2e, signs = periodic_quad_mesh(n)
    rng = np.random.default_rng(1)
    nv = n * n
    pp, sx, vol = rng.random(nv), rng.random(2 * nv), rng.random(nv) + 0.5
    out = gtx.zeros({V: nv})
    nabla(
        gtx.as_field([V], pp), gtx.as_field([E], sx),
        gtx.as_field([V, V2EDim], signs.astype(np.float64)), gtx.as_field([V], vol),
        out=out,
        offset_provider={
            "E2V": gtx.as_connectivity([E, E2VDim], V, e2v),
            "V2E": gtx.as_connectivity([V, V2EDim], E, v2e),
        },
    )
    zavg = 0.5 * (pp[e2v[:, 0]] + pp[e2v[:, 1]]) * sx
    check("field view FVM nabla f64, 1M vertices", out.ndarray,
          (zavg[v2e] * signs).sum(axis=1) / vol, F64)


# --- phase 4: K-sweep kernel against XLA -------------------------------------


def phase_ksweep_vs_xla(timings: dict) -> None:
    import bench
    import jax

    peaks = bench.device_peaks(jax.devices()[0].device_kind)
    missing = [
        (n, p, b) for n in ("hdiff", *SOLVERS) for p in bench.PRECISIONS
        for b in ("gpu", "jax") if (n, p, b) not in timings
    ]
    assert not missing, f"no timings (failed in phase 2): {missing}"
    for name in SOLVERS:
        for precision in bench.PRECISIONS:
            gpu = timings[(name, precision, "gpu")]
            xla = timings[(name, precision, "jax")]
            print(
                f"KSWEEP {name} {precision}: call {gpu['call_ms']:.3f} ms (K-sweep kernel) vs "
                f"{xla['call_ms']:.3f} ms (XLA scan), x{xla['call_ms'] / gpu['call_ms']:.2f}; "
                f"chain step {gpu['chain_step_ms']:.3f} vs {xla['chain_step_ms']:.3f} ms, "
                f"x{xla['chain_step_ms'] / gpu['chain_step_ms']:.2f}", flush=True,
            )
    points = int(np.prod(bench.DOMAIN))
    for precision in bench.PRECISIONS:
        for backend in ("gpu", "jax"):
            t = timings[("hdiff", precision, backend)]
            moved = t["case"]["bytes_per_point"] * points
            for what in ("call_ms", "chain_step_ms"):
                rate = moved / (t[what] * 1e-3)
                print(f"HDIFF {precision} {backend} {what[:-3]}: {t[what]:.3f} ms, "
                      f"{rate / 1e9:.1f} GB/s = {rate / peaks['hbm_bytes_per_s']:.3f} of "
                      f"{peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s ({peaks['source']})", flush=True)
    print(f"COPY ceiling: {bench.copy_ceiling_bytes_per_s() / 1e9:.1f} GB/s "
          f"(1 GiB float64 read+write)", flush=True)
    for (name, precision, backend), t in sorted(timings.items(), key=lambda kv: kv[0]):
        compiled = compiled_step(t["stencil"], t["case"])
        print(f"MEMORY {name} {precision} {backend}: {memory_line(compiled)}", flush=True)


# --- phase 5: hardware tier ---------------------------------------------------


def phase_hardware_tier() -> None:
    import pytest

    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        os.path.join(HERE, "tests", "gpu_tests"),
    ])
    assert rc == 0, f"hardware tier exit code {rc}"


# --- four cards ----------------------------------------------------------------


def phase_four_cards() -> None:
    import jax
    from jax.sharding import Mesh

    import gt4py_tpu.next as gtx
    from gt4py_tpu.cartesian import gtscript
    from gt4py_tpu.next import Dimension, DimensionKind, FieldOffset, neighbor_sum
    from gt4py_tpu.next.embedded import offset_provider_context
    from gt4py_tpu.next.mesh_utils import Renumbering, periodic_quad_mesh
    from gt4py_tpu.parallel import CartesianMesh, DistributedStencil
    from gt4py_tpu.parallel.unstructured import DistributedUnstructured
    from tests.cartesian_tests import stencil_defs as defs

    devices = jax.devices()
    assert len(devices) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devices)}"
    mesh = CartesianMesh(devices)
    assert mesh.shape == (2, 2), mesh.shape
    rng = np.random.default_rng(2)
    shape = FOUR_CARD_SHAPE

    def on_all_cards(arr, label):
        used = {s.device.id for s in arr.addressable_shards}
        assert used == {d.id for d in devices}, f"{label} sits on devices {sorted(used)}"

    st = gtscript.stencil(backend="gpu", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    inp, coeff = rng.random(shape), 0.05 * rng.random(shape)
    out = dist.apply(in_field=inp, coeff=coeff, out_field=np.zeros(shape))["out_field"]
    on_all_cards(out, "hdiff output")
    padded = np.pad(inp, ((2, 2), (2, 2), (0, 0)), mode="wrap")
    padded_c = np.pad(coeff, ((2, 2), (2, 2), (0, 0)), mode="wrap")
    check("4 cards: DistributedStencil hdiff f64 1024x1024x80, 2x2 mesh", out,
          defs.validate_horizontal_diffusion(padded, padded_c), F64)
    hlo = dist.lowered_hlo(in_field=inp, coeff=coeff, out_field=np.zeros(shape))
    assert "collective-permute" in hlo, "hdiff halo exchange missing"
    assert "all-gather" not in hlo, "hdiff field was all-gathered"
    print("PASS 4 cards: hdiff halos move by collective-permute, no all-gather", flush=True)

    tri = DistributedStencil(gtscript.stencil(backend="gpu", definition=defs.tridiagonal_solver), mesh)
    inf, sup = -0.35 + 0.1 * rng.random(shape), -0.35 + 0.1 * rng.random(shape)
    diag, rhs = 2.0 + rng.random(shape), rng.random(shape)
    ref = {"inf": inf, "diag": diag, "sup": sup.copy(), "rhs": rhs.copy(), "out": np.zeros(shape)}
    gtscript.stencil(backend="numpy", definition=defs.tridiagonal_solver)(**ref)
    got = tri.apply(inf=inf, diag=diag, sup=sup, rhs=rhs, out=np.zeros(shape))["out"]
    assert tri.last_kernel == KERNEL, tri.last_kernel
    on_all_cards(got, "tridiag output")
    check("4 cards: DistributedStencil tridiag f64 1024x1024x80 (K-sweep kernel in shards)",
          got, ref["out"], F64)

    V = Dimension("Vertex")
    E = Dimension("Edge")
    V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
    E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
    V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
    E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))

    @gtx.field_operator
    def nabla(pp, s_x, sign, vol):
        zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
        return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol

    n = NABLA_N
    nv = n * n
    e2v_np, v2e_np, signs = periodic_quad_mesh(n)
    # edge numbering ring-aligned with the vertex blocks (h/v interleaved
    # by grid row)
    ii, jj = np.divmod(np.arange(nv, dtype=np.int64), n)
    eperm = np.empty(2 * nv, dtype=np.int64)
    eperm[:nv] = ii * 2 * n + jj
    eperm[nv:] = ii * 2 * n + n + jj
    e2v = gtx.as_connectivity([E, E2VDim], V, e2v_np)
    v2e = gtx.as_connectivity([V, V2EDim], E, v2e_np)
    pp, sx, vol = rng.random(nv), rng.random(2 * nv), rng.random(nv) + 0.5
    fields = (
        gtx.as_field([V], pp), gtx.as_field([E], sx),
        gtx.as_field([V, V2EDim], signs.astype(np.float64)), gtx.as_field([V], vol),
    )
    dist_u = DistributedUnstructured(
        nabla,
        offset_provider={"E2V": e2v, "V2E": v2e},
        sizes={V: nv, E: 2 * nv},
        mesh=Mesh(np.asarray(devices), axis_names=("ring",)),
        renumberings=[Renumbering(E, eperm)],
    )
    got = dist_u(*fields)
    zavg = 0.5 * (pp[e2v_np[:, 0]] + pp[e2v_np[:, 1]]) * sx
    check("4 cards: DistributedUnstructured FVM nabla f64, 1M vertices", got.ndarray,
          (zavg[v2e_np] * signs).sum(axis=1) / vol, F64)
    with offset_provider_context({"E2V": e2v, "V2E": v2e}):
        hlo = dist_u.compiled_hlo(*fields)
    assert "collective-permute" in hlo, "nabla halo exchange missing"
    assert "all-gather" not in hlo, "nabla values were all-gathered"
    print("PASS 4 cards: nabla halos move by collective-permute, no all-gather", flush=True)


def main(argv) -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.default_backend()!r})", file=sys.stderr)
        return 1
    import bench

    from gt4py_tpu.cartesian.caching import enable_persistent_cache

    enable_persistent_cache()
    print(f"CARD {bench.card()}", flush=True)
    dev = jax.devices()[0]
    print(f"DEVICE {dev.platform} {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}",
          flush=True)
    if "--four-cards" in argv:
        phases = [("four cards", phase_four_cards)]
    else:
        assert len(jax.devices()) == 1, "one GPU expected; --four-cards runs the 4-GPU path"
        timings: dict = {}
        phases = [
            ("gtscript", lambda: phase_gtscript(timings)),
            ("field view", phase_field_view),
            ("k-sweep vs xla", lambda: phase_ksweep_vs_xla(timings)),
            ("hardware tier", phase_hardware_tier),
        ]
    failed = []
    for label, phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
            print(f"PHASE {label}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        except Exception:
            traceback.print_exc()
            print(f"PHASE {label}: FAILED ({time.perf_counter() - t0:.1f} s)", flush=True)
            failed.append(label)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
