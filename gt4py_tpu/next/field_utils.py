"""Field utilities.

Role of the reference's ``gt4py.next.field_utils``
(/root/reference/src/gt4py/next/field_utils.py:26): conversion to NumPy
over (tuples of) fields and device verification.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gt4py_tpu.next.embedded import Field


def asnumpy(value: Any) -> Any:
    """Recursively convert (tuples of) Fields/arrays to np.ndarray."""
    if isinstance(value, tuple):
        return tuple(asnumpy(v) for v in value)
    if isinstance(value, Field):
        return np.asarray(value.ndarray)
    return np.asarray(value)


def verify_device(value: Any, platform: str) -> bool:
    """True if all backing arrays live on the given platform
    ('cpu' | 'gpu' | ...)."""
    if isinstance(value, tuple):
        return all(verify_device(v, platform) for v in value)
    arr = value.ndarray if isinstance(value, Field) else value
    devices = getattr(arr, "devices", None)
    if devices is None:
        return platform == "cpu"
    return all(d.platform == platform for d in devices())


def field_from_typespec(spec: Any, domain) -> Field:
    """Allocate a zero-filled Field matching a FieldType spec (reference
    field_utils.field_from_typespec)."""
    import jax.numpy as jnp

    from gt4py_tpu.next.type_system import FieldType

    if not isinstance(spec, FieldType):
        raise TypeError(f"expected FieldType, got {spec!r}")
    shape = tuple(len(domain[d].unit_range) for d in spec.dims)
    return Field(domain, jnp.zeros(shape, dtype=spec.dtype))
