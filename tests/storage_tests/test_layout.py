"""Layout registry tests (reference: storage/cartesian/layout_registry.py)."""

from gt4py_tpu.storage import LayoutInfo, layout_from_name, register_layout
from gt4py_tpu.storage.layout import is_gpu_backend


def test_builtin_backends_registered():
    for name in ("debug", "numpy", "jax", "gpu"):
        assert layout_from_name(name) is not None


def test_gpu_layout_is_k_minor():
    info = layout_from_name("gpu")
    assert info.device == "gpu"
    assert is_gpu_backend("gpu") and is_gpu_backend("jax")
    # public (I, J, K) order: K is the minor (contiguous) axis
    assert info.physical_order() == (0, 1, 2)


def test_register_custom():
    register_layout("custom", LayoutInfo(alignment=32, device="cpu", layout_map=(2, 1, 0)))
    assert layout_from_name("custom").alignment == 32
    assert not is_gpu_backend("custom")
