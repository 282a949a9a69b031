"""Tests: as_offset, allocators, program formatters, bound args,
cache manager."""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next.common import Dimension, DimensionKind, FieldOffset
from gt4py_tpu.next.experimental import as_offset
from gt4py_tpu.next.field_utils import asnumpy
from gt4py_tpu.next import program_processors as pp

I = Dimension("I")
K = Dimension("K", kind=DimensionKind.VERTICAL)
Koff = FieldOffset("Koff", source=K, target=(K,))


def test_as_offset_variable_shift():
    data = np.arange(20, dtype=np.float64).reshape(4, 5)
    phi = gtx.as_field({I: 4, K: 5}, data)
    idx = gtx.as_field({I: 4, K: 5}, np.ones((4, 5), dtype=np.int32))

    @gtx.field_operator
    def shift_by(phi, idx):
        return phi(as_offset(Koff, idx))

    out = gtx.zeros({I: 4, K: 5})
    shift_by(phi, idx, out=out, offset_provider={"Koff": K})
    expected = data[:, [1, 2, 3, 4, 4]]  # +1 shift, clamped at the top
    np.testing.assert_allclose(asnumpy(out), expected)


def test_as_offset_mixed_shifts():
    data = np.arange(12, dtype=np.float64).reshape(3, 4)
    phi = gtx.as_field({I: 3, K: 4}, data)
    idx_np = np.array([[0, 1, -1, 0]] * 3, dtype=np.int32)
    idx = gtx.as_field({I: 3, K: 4}, idx_np)

    @gtx.field_operator
    def shift_by(phi, idx):
        return phi(as_offset(Koff, idx))

    out = gtx.zeros({I: 3, K: 4})
    shift_by(phi, idx, out=out, offset_provider={"Koff": K})
    cols = np.clip(np.arange(4) + idx_np[0], 0, 3)
    np.testing.assert_allclose(asnumpy(out), data[:, cols])


def test_allocators():
    from gt4py_tpu.next.allocators import (
        CPUFieldBufferAllocator,
        FieldBufferAllocatorProtocol,
        DeviceFieldBufferAllocator,
    )

    cpu = CPUFieldBufferAllocator()
    assert isinstance(cpu, FieldBufferAllocatorProtocol)
    buf = cpu.allocate((4, 8), np.float32)
    assert isinstance(buf, np.ndarray) and buf.shape == (4, 8)
    assert buf.ctypes.data % 64 == 0  # aligned host buffer
    np.testing.assert_array_equal(buf, 0)

    device = DeviceFieldBufferAllocator()
    jbuf = device.allocate((4, 8), np.float32)
    assert jbuf.shape == (4, 8)

    f = gtx.zeros({I: 4}, device="cpu")
    assert isinstance(f.ndarray, np.ndarray)


def test_program_formatters():
    @gtx.field_operator
    def op(a):
        return a * 2.0 + 1.0

    a = gtx.as_field({I: 8}, np.zeros(8))
    txt = pp.format_jaxpr(op, a)
    assert "mul" in txt and "add" in txt
    hlo = pp.format_lowered(op, a)
    assert "stablehlo" in hlo or "HloModule" in hlo or "func" in hlo


def test_program_with_bound_args():
    recorded = {}

    @gtx.field_operator
    def op(a, f: float):
        return a * f

    @gtx.program
    def prog(a, out, f: float):
        op(a, f, out=out)

    a = gtx.as_field({I: 4}, np.ones(4))
    out = gtx.zeros({I: 4})
    bound = prog.with_bound_args(f=3.0)
    bound(a, out)
    np.testing.assert_allclose(asnumpy(out), 3.0)
    with pytest.raises(TypeError):
        bound(a, out, f=4.0)


def test_cache_manager(tmp_path):
    from gt4py_tpu.cartesian import cache_manager as cm

    root = tmp_path / "cacheroot"
    (root / "native").mkdir(parents=True)
    (root / "native" / "lib.so").write_bytes(b"y" * 10)
    (root / "xla_cache").mkdir()
    (root / "xla_cache" / "blob").write_bytes(b"x" * 100)

    info = cm.cache_info(str(root))
    assert info["subsystems"]["native"]["entries"] == 1
    assert info["subsystems"]["xla_cache"] == {"bytes": 100, "entries": 1}
    assert info["total_bytes"] == 110

    cm.clean_cache(str(root), subsystem="xla_cache")
    assert not (root / "xla_cache").exists()
    cm.clean_cache(str(root))
    assert not root.exists()


def test_concat_where_tuple_overload():
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import concat_where
    from gt4py_tpu.next.common import Dimension, DimensionKind

    K = Dimension("Kc", kind=DimensionKind.VERTICAL)
    f = gtx.as_field([K], np.arange(5.0))
    top, bot = concat_where(K < 2, (f * 0.0, f + 10.0), (f, f))
    np.testing.assert_allclose(np.asarray(top.ndarray), [0, 0, 2, 3, 4])
    np.testing.assert_allclose(np.asarray(bot.ndarray), [10, 11, 2, 3, 4])


def test_format_compiled_emits_backend_hlo():
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import program_processors as pp
    from gt4py_tpu.next.common import Dimension

    If = Dimension("Ifc")

    @gtx.field_operator
    def dbl(a):
        return a * 2.0

    a = gtx.as_field([If], np.arange(4.0))
    txt = pp.format_compiled(dbl, a)
    assert "multiply" in txt or "mul" in txt


def test_concat_where_boundary_patterns():
    """Surface/top boundary-condition shapes (reference concat_where
    use-cases): every comparison operator, both orders, jit + eager."""
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import concat_where
    from gt4py_tpu.next.common import Dimension, DimensionKind

    K = Dimension("Kbc", kind=DimensionKind.VERTICAL)
    n = 7
    data = np.arange(float(n))
    f = gtx.as_field([K], data)
    zero = f * 0.0

    cases = {
        "lt": (K < 2, np.where(np.arange(n) < 2, 0.0, data)),
        "le": (K <= 2, np.where(np.arange(n) <= 2, 0.0, data)),
        "gt": (K > 4, np.where(np.arange(n) > 4, 0.0, data)),
        "ge": (K >= 4, np.where(np.arange(n) >= 4, 0.0, data)),
        "eq": (K == 3, np.where(np.arange(n) == 3, 0.0, data)),
        "ne": (K != 3, np.where(np.arange(n) != 3, 0.0, data)),
    }
    for name, (cond, expected) in cases.items():
        got = concat_where(cond, zero, f)
        np.testing.assert_allclose(np.asarray(got.ndarray), expected, err_msg=name)


def test_concat_where_in_operator_under_jit():
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import concat_where
    from gt4py_tpu.next.common import Dimension, DimensionKind

    K = Dimension("Kbc2", kind=DimensionKind.VERTICAL)

    @gtx.field_operator
    def surface_fix(phi):
        return concat_where(K < 1, phi * 0.0 + 99.0, phi)

    data = np.arange(5.0)
    out = gtx.zeros({K: 5})
    surface_fix(gtx.as_field([K], data), out=out)
    expected = data.copy(); expected[0] = 99.0
    np.testing.assert_allclose(out.asnumpy(), expected)
