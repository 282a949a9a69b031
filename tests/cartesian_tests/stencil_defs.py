"""Canonical stencil definitions + NumPy validation oracles.

Mirrors the reference's registry pattern
(/root/reference/tests/cartesian_tests/integration_tests/multi_feature_tests/
stencil_definitions.py): each stencil has a matching hand-written NumPy
``validate_*`` function used as the independent correctness oracle.
"""

import numpy as np

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    I,
    J,
    PARALLEL,
    __INLINED,
    ceil,
    computation,
    cos,
    exp,
    floor,
    horizontal,
    interval,
    log,
    region,
    sin,
    sqrt,
)

Field3D = gtscript.Field[np.float64]
Field2D = gtscript.Field[gtscript.IJ, np.float64]


def copy_stencil(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_b = field_a[0, 0, 0]


def arithmetic_ops(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_a = (((((field_b + 42.0) - 42.0) * +42.0) / -42.0) % 42.0) ** 2


def validate_arithmetic_ops(field_b):
    return (((((field_b + 42.0) - 42.0) * +42.0) / -42.0) % 42.0) ** 2


def scalar_inputs(field_a: Field3D, scalar_in: float):
    with computation(PARALLEL), interval(...):
        field_a = field_a * scalar_in


@gtscript.function
def _fn_sqrt_abs(b):
    return sqrt(abs(b[0, 0, 0]))


def function_call(field_a: Field3D, field_b: Field3D):
    with computation(PARALLEL), interval(...):
        field_b = _fn_sqrt_abs(field_a) + 1.0


def validate_function_call(field_a):
    return np.sqrt(np.abs(field_a)) + 1.0


def temporary_stencil(field_a: Field3D, field_b: Field2D, scalar_in: float):
    with computation(PARALLEL), interval(...):
        tmp = field_a * scalar_in

    with computation(FORWARD), interval(0, 1):
        field_b += tmp


def runtime_if(field_a: Field3D, field_b: Field3D):
    with computation(BACKWARD), interval(...):
        if field_a > 0.0:
            field_b = -1
            field_a = -field_a
        else:
            field_b = 1
            field_a = field_a


def validate_runtime_if(field_a):
    field_b = np.where(field_a > 0.0, -1.0, 1.0)
    new_a = np.where(field_a > 0.0, -field_a, field_a)
    return new_a, field_b


def while_stencil(field_a: Field3D, field_b: Field3D):
    with computation(BACKWARD), interval(...):
        while field_a > 2.0:
            field_b = -1
            field_a = -field_b


def validate_while(field_a, field_b):
    a = field_a.copy()
    b = field_b.copy()
    mask = a > 2.0
    while mask.any():
        b[mask] = -1
        a[mask] = 1.0
        mask = a > 2.0
    return a, b


def horizontal_diffusion(in_field: Field3D, out_field: Field3D, coeff: Field3D):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


def validate_horizontal_diffusion(in_field, coeff):
    """NumPy oracle for hdiff over the interior [2:-2, 2:-2]."""
    lap = 4.0 * in_field[1:-1, 1:-1] - (
        in_field[2:, 1:-1] + in_field[:-2, 1:-1] + in_field[1:-1, 2:] + in_field[1:-1, :-2]
    )
    res1 = lap[1:, 1:-1] - lap[:-1, 1:-1]
    flx = np.where(res1 * (in_field[2:-1, 2:-2] - in_field[1:-2, 2:-2]) > 0, 0.0, res1)
    res2 = lap[1:-1, 1:] - lap[1:-1, :-1]
    fly = np.where(res2 * (in_field[2:-2, 2:-1] - in_field[2:-2, 1:-2]) > 0, 0.0, res2)
    return in_field[2:-2, 2:-2] - coeff[2:-2, 2:-2] * (
        flx[1:, :] - flx[:-1, :] + fly[:, 1:] - fly[:, :-1]
    )


def tridiagonal_solver(inf: Field3D, diag: Field3D, sup: Field3D, rhs: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def validate_tridiagonal_solver(inf, diag, sup, rhs):
    """Thomas algorithm column-by-column (oracle)."""
    ni, nj, nk = inf.shape
    out = np.zeros_like(rhs)
    for i in range(ni):
        for j in range(nj):
            a, b, c, d = inf[i, j], diag[i, j].copy(), sup[i, j].copy(), rhs[i, j].copy()
            c[0] = c[0] / b[0]
            d[0] = d[0] / b[0]
            for k in range(1, nk):
                m = b[k] - c[k - 1] * a[k]
                c[k] = c[k] / m
                d[k] = (d[k] - a[k] * d[k - 1]) / m
            out[i, j, nk - 1] = d[nk - 1]
            for k in range(nk - 2, -1, -1):
                out[i, j, k] = d[k] - c[k] * out[i, j, k + 1]
    return out


def vertical_advection_dycore(
    utens_stage: Field3D,
    u_stage: Field3D,
    wcon: Field3D,
    u_pos: Field3D,
    utens: Field3D,
    *,
    dtr_stage: float,
):
    from __externals__ import BET_M, BET_P

    with computation(FORWARD):
        with interval(0, 1):
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
            cs = gcv * BET_M

            ccol = gcv * BET_P
            bcol = dtr_stage - ccol[0, 0, 0]

            correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / bcol[0, 0, 0]
            ccol = ccol[0, 0, 0] * divided
            dcol = dcol[0, 0, 0] * divided

        with interval(1, -1):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])

            as_ = gav * BET_M
            cs = gcv * BET_M

            acol = gav * BET_P
            ccol = gcv * BET_P
            bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                u_stage[0, 0, 1] - u_stage[0, 0, 0]
            )
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            ccol = ccol[0, 0, 0] * divided
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with interval(-1, None):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

    with computation(BACKWARD):
        with interval(-1, None):
            datacol = dcol[0, 0, 0]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

        with interval(0, -1):
            datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])


VADV_EXTERNALS = {"BET_M": 0.5, "BET_P": 0.5}


def validate_vertical_advection_dycore(utens_stage, u_stage, wcon, u_pos, utens, dtr_stage):
    """NumPy column-wise oracle for the vadv Thomas solve (domain excludes
    the last I row: wcon is read at [1, 0, *])."""
    BET_M, BET_P = 0.5, 0.5
    ni, nj, nk = u_stage.shape
    ni_d = ni - 1
    out = utens_stage.copy()
    for i in range(ni_d):
        for j in range(nj):
            ccol = np.zeros(nk)
            dcol = np.zeros(nk)
            # k = 0
            gcv = 0.25 * (wcon[i + 1, j, 1] + wcon[i, j, 1])
            cs = gcv * BET_M
            ccol[0] = gcv * BET_P
            bcol = dtr_stage - ccol[0]
            corr = -cs * (u_stage[i, j, 1] - u_stage[i, j, 0])
            dcol[0] = (
                dtr_stage * u_pos[i, j, 0] + utens[i, j, 0] + utens_stage[i, j, 0] + corr
            )
            divided = 1.0 / bcol
            ccol[0] *= divided
            dcol[0] *= divided
            # interior
            for k in range(1, nk - 1):
                gav = -0.25 * (wcon[i + 1, j, k] + wcon[i, j, k])
                gcv = 0.25 * (wcon[i + 1, j, k + 1] + wcon[i, j, k + 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol[k] = gcv * BET_P
                bcol = dtr_stage - acol - ccol[k]
                corr = -as_ * (u_stage[i, j, k - 1] - u_stage[i, j, k]) - cs * (
                    u_stage[i, j, k + 1] - u_stage[i, j, k]
                )
                dcol[k] = (
                    dtr_stage * u_pos[i, j, k] + utens[i, j, k] + utens_stage[i, j, k] + corr
                )
                divided = 1.0 / (bcol - ccol[k - 1] * acol)
                ccol[k] *= divided
                dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided
            # k = nk-1
            k = nk - 1
            gav = -0.25 * (wcon[i + 1, j, k] + wcon[i, j, k])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol
            corr = -as_ * (u_stage[i, j, k - 1] - u_stage[i, j, k])
            dcol[k] = (
                dtr_stage * u_pos[i, j, k] + utens[i, j, k] + utens_stage[i, j, k] + corr
            )
            divided = 1.0 / (bcol - ccol[k - 1] * acol)
            dcol[k] = (dcol[k] - dcol[k - 1] * acol) * divided
            # backward
            datacol = dcol[nk - 1]
            out[i, j, nk - 1] = dtr_stage * (datacol - u_pos[i, j, nk - 1])
            for k in range(nk - 2, -1, -1):
                datacol = dcol[k] - ccol[k] * datacol
                out[i, j, k] = dtr_stage * (datacol - u_pos[i, j, k])
    return out[:ni_d]


def large_k_interval(in_field: Field3D, out_field: Field3D):
    with computation(PARALLEL):
        with interval(0, 6):
            out_field = in_field
        with interval(6, -10):
            out_field = in_field + 1
        with interval(-10, None):
            out_field = in_field


# Generic-dtype variants of hdiff, tridiag and vadv (reference string-dtype
# pattern: resolved via the dtypes={'float_t': ...} build option), used by
# bench.py and chip_smoke.py to run each in float64 and float32.
def horizontal_diffusion_generic(
    in_field: "gtscript.Field['float_t']",
    out_field: "gtscript.Field['float_t']",
    coeff: "gtscript.Field['float_t']",
):
    with computation(PARALLEL), interval(...):
        lap_field = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0] + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
        flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
        res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
        fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx_field[0, 0, 0] - flx_field[-1, 0, 0] + fly_field[0, 0, 0] - fly_field[0, -1, 0]
        )


def tridiagonal_solver_generic(
    inf: "gtscript.Field['float_t']",
    diag: "gtscript.Field['float_t']",
    sup: "gtscript.Field['float_t']",
    rhs: "gtscript.Field['float_t']",
    out: "gtscript.Field['float_t']",
):
    with computation(FORWARD):
        with interval(0, 1):
            sup = sup / diag
            rhs = rhs / diag
        with interval(1, None):
            sup = sup / (diag - sup[0, 0, -1] * inf)
            rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
    with computation(BACKWARD):
        with interval(-1, None):
            out = rhs
        with interval(0, -1):
            out = rhs - sup * out[0, 0, 1]


def vertical_advection_dycore_generic(
    utens_stage: "gtscript.Field['float_t']",
    u_stage: "gtscript.Field['float_t']",
    wcon: "gtscript.Field['float_t']",
    u_pos: "gtscript.Field['float_t']",
    utens: "gtscript.Field['float_t']",
    *,
    dtr_stage: "float_t",
):
    from __externals__ import BET_M, BET_P

    with computation(FORWARD):
        with interval(0, 1):
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
            cs = gcv * BET_M

            ccol = gcv * BET_P
            bcol = dtr_stage - ccol[0, 0, 0]

            correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / bcol[0, 0, 0]
            ccol = ccol[0, 0, 0] * divided
            dcol = dcol[0, 0, 0] * divided

        with interval(1, -1):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])

            as_ = gav * BET_M
            cs = gcv * BET_M

            acol = gav * BET_P
            ccol = gcv * BET_P
            bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                u_stage[0, 0, 1] - u_stage[0, 0, 0]
            )
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            ccol = ccol[0, 0, 0] * divided
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with interval(-1, None):
            gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
            as_ = gav * BET_M
            acol = gav * BET_P
            bcol = dtr_stage - acol[0, 0, 0]

            correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
            dcol = (
                dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0] + utens_stage[0, 0, 0] + correction_term
            )

            divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
            dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

    with computation(BACKWARD):
        with interval(-1, None):
            datacol = dcol[0, 0, 0]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

        with interval(0, -1):
            datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
            utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])




# =============================================================================
# Canonical multi-feature registry (reference pattern:
# tests/cartesian_tests/integration_tests/multi_feature_tests/
# stencil_definitions.py:206-328 — 30+ stencils compiled and cross-checked
# on every registered backend). Each entry: definition + build options;
# the registry test runs every backend against the `numpy` oracle.
# =============================================================================

REGISTRY: dict = {}


def register(_func=None, *, externals=None, dtypes=None, scalars=None, min_k=1):
    def deco(func):
        REGISTRY[func.__name__] = {
            "definition": func,
            "externals": externals or {},
            "dtypes": dtypes or {},
            "scalars": scalars or {},
            "min_k": min_k,
        }
        return func

    return deco(_func) if _func is not None else deco


for _name, _mink in (
    ("copy_stencil", 1), ("arithmetic_ops", 1), ("function_call", 1),
    ("temporary_stencil", 1), ("runtime_if", 1), ("while_stencil", 1),
    ("horizontal_diffusion", 1), ("tridiagonal_solver", 2),
    ("large_k_interval", 16),
):
    REGISTRY[_name] = {
        "definition": globals()[_name], "externals": {}, "dtypes": {},
        "scalars": {"scalar_in": 1.5} if _name in ("scalar_inputs", "temporary_stencil") else {},
        "min_k": _mink,
    }
REGISTRY["vertical_advection_dycore"] = {
    "definition": vertical_advection_dycore, "externals": VADV_EXTERNALS,
    "dtypes": {}, "scalars": {"dtr_stage": 0.15}, "min_k": 3,
}

FieldI64 = gtscript.Field[np.int64]
FieldVec3 = gtscript.Field[(np.float64, (3,))]
FieldMat33 = gtscript.Field[(np.float64, (3, 3))]
FieldK = gtscript.Field[gtscript.K, np.float64]
Table4 = gtscript.GlobalTable[(np.float64, (4,))]
Table22 = gtscript.GlobalTable[(np.float64, (2, 2))]


@register
def shift_all_directions(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(1, -1):
        out = (
            inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
            + inp[0, 0, 1] + inp[0, 0, -1]
        )


@register
def lap_of_lap(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0] - 4.0 * inp
        out = lap[1, 0, 0] + lap[-1, 0, 0] + lap[0, 1, 0] + lap[0, -1, 0] - 4.0 * lap


@register
def native_function_zoo(a: Field3D, b: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = (
            sin(a) + cos(b) + exp(-abs(a)) + log(1.0 + abs(b))
            + min(a, b) + max(a, b) + floor(a) + ceil(b) + sqrt(abs(a) + 1.0)
        )


@register(externals={"USE_FAST": True, "WEIGHT": 0.25})
def compile_time_if(inp: Field3D, out: Field3D):
    from __externals__ import USE_FAST, WEIGHT

    with computation(PARALLEL), interval(...):
        if __INLINED(USE_FAST):
            out = inp * WEIGHT
        else:
            out = inp * 0.125


@register
def ternary_and_masks(a: Field3D, b: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        tmp = a if a > b else b
        if tmp > 0.5:
            out = tmp * 2.0
        else:
            out = tmp - b


@register
def region_interaction(inp: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = inp
        with horizontal(region[I[0]:I[2], :]):
            out = inp * 10.0
        with horizontal(region[:, J[-1]]):
            out = 0.0
        with horizontal(region[I[-1], J[0]]):
            out = -1.0


@register
def forward_cumsum(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp


@register
def backward_cumsum(inp: Field3D, out: Field3D):
    with computation(BACKWARD):
        with interval(-1, None):
            out = inp
        with interval(0, -1):
            out = out[0, 0, 1] + inp


@register(min_k=6)
def multi_section_forward(inp: Field3D, out: Field3D):
    with computation(FORWARD):
        with interval(0, 2):
            out = inp * 2.0
        with interval(2, -2):
            out = out[0, 0, -1] + inp
        with interval(-2, None):
            out = out[0, 0, -1] * 0.5


@register(min_k=2, scalars={"cs": 0.18})
def dycore_smagorinsky_like(u: Field3D, v: Field3D, out_u: Field3D, cs: float):
    """PARALLEL shear computation + FORWARD column damping (multi-loop
    dycore shape: horizontal stage feeding a sequential stage)."""
    with computation(PARALLEL), interval(...):
        shear = (u[0, 1, 0] - u[0, -1, 0]) * 0.5 + (v[1, 0, 0] - v[-1, 0, 0]) * 0.5
        tension = (u[1, 0, 0] - u[-1, 0, 0]) * 0.5 - (v[0, 1, 0] - v[0, -1, 0]) * 0.5
        smag = cs * sqrt(shear * shear + tension * tension)
    with computation(FORWARD):
        with interval(0, 1):
            out_u = u + smag
        with interval(1, None):
            out_u = u + smag + 0.1 * out_u[0, 0, -1]


@register
def variable_k_shift(a: Field3D, idx: FieldI64, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a[0, 0, idx]


@register
def absolute_k_reference(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = a - a.at(K=0)


@register
def table_lookup(idx: FieldI64, out: Field3D, table: Table4):
    with computation(PARALLEL), interval(...):
        out = table[idx]


@register
def table_lookup_2d(i0: FieldI64, i1: FieldI64, out: Field3D, table: Table22):
    with computation(PARALLEL), interval(...):
        out = table[i0, i1]


@register(scalars={"alpha": 1.75})
def vector_axpy(x: FieldVec3, y: FieldVec3, out: FieldVec3, alpha: float):
    with computation(PARALLEL), interval(...):
        out = x * alpha + y


@register
def matvec_product(mat: FieldMat33, vec: FieldVec3, out: FieldVec3):
    with computation(PARALLEL), interval(...):
        out = mat @ vec


@register
def component_extract(vec: FieldVec3, sel: FieldI64, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = vec[0, 0, 0][sel]


@register
def k_profile_scale(inp: Field3D, prof: FieldK, out: Field3D):
    with computation(PARALLEL), interval(...):
        out = inp * prof


@register
def newton_sqrt_while(a: Field3D, out: Field3D):
    with computation(PARALLEL), interval(...):
        guess = a * 0.5 + 0.5
        err = guess * guess - a
        while (err > 1e-10) or (err < -1e-10):
            guess = 0.5 * (guess + a / guess)
            err = guess * guess - a
        out = guess


@register(min_k=2, scalars={"dt": 0.1})
def heat_step(t: Field3D, out: Field3D, dt: float):
    """Explicit heat equation step with a vertical implicit-ish smoothing
    pass (PARALLEL laplacian + FORWARD/BACKWARD relaxations)."""
    with computation(PARALLEL), interval(...):
        lap = (
            t[1, 0, 0] + t[-1, 0, 0] + t[0, 1, 0] + t[0, -1, 0] - 4.0 * t
        )
        out = t + dt * lap
    with computation(FORWARD), interval(1, None):
        out = 0.75 * out + 0.25 * out[0, 0, -1]
    with computation(BACKWARD), interval(0, -1):
        out = 0.75 * out + 0.25 * out[0, 0, 1]


FieldBool = gtscript.Field[np.bool_]
FieldF32 = gtscript.Field[np.float32]
FieldI32 = gtscript.Field[np.int32]
FieldI8 = gtscript.Field[np.int8]


@register
def dtype_zoo(
    flag: FieldBool,
    tiny: FieldI8,
    idx32: FieldI32,
    big: FieldI64,
    f32: FieldF32,
    f64: Field3D,
):
    """Literal assignment across the dtype spectrum (reference data_types
    class: per-dtype fields written with in-range literals)."""
    with computation(PARALLEL), interval(...):
        flag = True
        tiny = 101
        idx32 = 1000000007
        big = 123456789012345
        f32 = 0.8125
        f64 = 0.333251953125


@register
def land_mask(height: Field3D, mask: FieldBool):
    """Boolean field computed from a comparison (reference form_land_mask)."""
    with computation(PARALLEL), interval(...):
        mask = height >= 0.5


@register(min_k=3)
def bool_elif_koffset(base: Field3D, marker: FieldBool, hi: Field3D, lo: Field3D):
    """Bool-field elif chain with K-offset reads of the condition field
    (reference set_inner_as_kord class)."""
    with computation(PARALLEL), interval(1, -1):
        gap = 0.0
        if marker and marker[0, 0, -1]:
            hi = base
        elif marker and marker[0, 0, 1]:
            lo = base
        else:
            gap = hi - lo
            hi = hi + 0.125 * gap


@register(min_k=3)
def nested_conditional_locals(src: Field3D, dst: Field3D):
    """Local scalars declared inside nested conditionals, different
    computations re-declaring the same local (reference
    local_var_inside_nested_conditional class)."""
    with computation(PARALLEL), interval(0, 2):
        fallback = 2.0
        if src[0, 0, 0] > 0.3:
            bump = 4.0
            if bump + src < dst:
                fallback = 3.0
            else:
                fallback = 4.0
            dst = bump + fallback
    with computation(FORWARD), interval(2, None):
        if src[0, 0, 0] < 0.3:
            bump = 6.0
            dst = bump


@register(scalars={"c": 0.5})
def param_multibranch(src: Field3D, dst: Field3D, c: float):
    """Scalar-parameter if/elif/else (reference multibranch_param_conditional)."""
    with computation(PARALLEL), interval(...):
        if c > 0.0:
            dst = src + src[1, 0, 0]
        elif c < -1.0:
            dst = src - src[1, 0, 0]
        else:
            dst = src


@register(externals={"EXTRA_SMOOTH": False})
def empty_computation_inlined(src: Field3D, dst: Field3D):
    """A computation emptied by __INLINED(False) must still compile
    (reference allow_empty_computation)."""
    from __externals__ import EXTRA_SMOOTH

    with computation(FORWARD), interval(...):
        dst = src
    with computation(PARALLEL), interval(...):
        if __INLINED(EXTRA_SMOOTH):
            dst = abs(src)


@register(min_k=3)
def single_level_offset(src: Field3D, dst: Field3D):
    """Single-level interval with a horizontal offset read (reference
    single_level_with_offset)."""
    with computation(PARALLEL), interval(1, 2):
        dst = 0.5 * (src[1, 0, 0] + src[-1, 0, 0])


@register
def region_conditional(src: Field3D, dst: Field3D):
    """Runtime conditional inside horizontal regions (reference
    horizontal_region_with_conditional)."""
    with computation(PARALLEL), interval(...):
        dst = src
        with horizontal(region[I[0]:I[2], :], region[I[-2]:I[-1] + 1, :]):
            if src > 0.4:
                dst = src + 1.0
            else:
                dst = 0.0


@register(min_k=2)
def region_in_sequential(inp: Field3D, out: Field3D):
    """Horizontal region restriction inside a FORWARD loop (feature
    interaction: per-column carry + edge specialization)."""
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp
            with horizontal(region[I[0], :]):
                out = 0.0


@register(min_k=2)
def staggeredish_interval_chain(inp: Field3D, out: Field3D):
    """Multi-computation chain alternating PARALLEL and BACKWARD with
    K-boundary intervals (dycore wind-solver shape)."""
    with computation(PARALLEL), interval(...):
        out = 0.5 * inp
    with computation(BACKWARD):
        with interval(-1, None):
            out = out + inp
        with interval(0, -1):
            out = out + 0.25 * out[0, 0, 1]


@register(min_k=2)
def iteration_index_parallel(inp: Field3D, out: Field3D):
    """Current-K iterator access in PARALLEL context, in values and in
    branch conditions (reference gtc/gtir.py:68 IteratorAccess)."""
    with computation(PARALLEL), interval(...):
        if K >= 1:
            out = inp + K
        else:
            out = inp - K


@register(min_k=2)
def iteration_index_sequential(inp: Field3D, out: Field3D):
    """K-dependent coefficient inside a FORWARD carry chain (the
    level-weighted cumulative-sum pattern of K-dependent physics)."""
    with computation(FORWARD):
        with interval(0, 1):
            out = inp * (K + 1)
        with interval(1, None):
            out = out[0, 0, -1] + inp * (K + 1)


@register(externals={"PHYS_TEND": True}, scalars={"dt": 0.5})
def optional_tendency(
    in_field: Field3D,
    out_field: Field3D,
    dyn_tend: Field3D,
    phys_tend: Field3D = None,
    *,
    dt: float,
):
    """Optional-field pattern (reference optional_field): the phys_tend
    parameter may be omitted entirely when __INLINED(PHYS_TEND) prunes its
    use (covered in test_features); registered here with the field live so
    every backend executes the two-tendency update."""
    from __externals__ import PHYS_TEND

    with computation(PARALLEL), interval(...):
        out_field = in_field + dt * dyn_tend
        if __INLINED(PHYS_TEND):
            out_field = out_field + dt * phys_tend
