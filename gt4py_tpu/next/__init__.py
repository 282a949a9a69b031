"""gt4py_tpu.next — declarative field-view DSL on JAX.

Counterpart of ``gt4py.next`` (reference
/root/reference/src/gt4py/next/): Dimension/Domain/Field model,
@field_operator / @scan_operator / @program entry points, neighbor
reductions over connectivities. The embedded JAX execution path is primary
(fields are pytrees; operators jit-compile whole), replacing the
reference's FOAST→ITIR→C++/DaCe toolchain with XLA.
"""

from gt4py_tpu.next.common import (  # noqa: F401
    CartesianConnectivity,
    Connectivity,
    NeighborTable,
    as_non_staggered,
    check_dims,
    connectivity_for_cartesian_shift,
    flip_staggered,
    is_staggered,
    promote_dims,
    deduce_grid_type,
    Dimension,
    DimensionKind,
    Dims,
    Domain,
    FieldOffset,
    GridType,
    Infinity,
    NamedIndex,
    NamedRange,
    UnitRange,
    domain,
    named_range,
    unit_range,
)
from gt4py_tpu.next.constructors import (  # noqa: F401
    as_connectivity,
    as_field,
    empty,
    full,
    ones,
    zeros,
)
from gt4py_tpu.next.decorators import (  # noqa: F401
    field_operator,
    program,
    scan_operator,
)
from gt4py_tpu.next.embedded import Field  # noqa: F401
from gt4py_tpu.next.foast import TransformOptions  # noqa: F401
from gt4py_tpu.next.errors import (  # noqa: F401
    DSLError,
    DSLSyntaxError,
    DSLTypeError,
    UndefinedSymbolError,
)
from gt4py_tpu.next.fbuiltins import (  # noqa: F401
    astype,
    concat_where,
    broadcast,
    max_over,
    min_over,
    neighbor_sum,
    where,
)

# Math builtins + scalar-kind aliases at package level (reference
# next/__init__.py exports every fbuiltin: gtx.sin, gtx.float64, ...).
from gt4py_tpu.next import fbuiltins as _fb  # noqa: E402

for _name in _fb.MATH_BUILTIN_NAMES + _fb.DTYPE_ALIAS_NAMES:
    globals()[_name] = getattr(_fb, _name)
del _fb, _name
from gt4py_tpu.next.field_utils import asnumpy  # noqa: F401
from gt4py_tpu.next.named_collections import named_collection  # noqa: F401
from gt4py_tpu.next.experimental import as_offset  # noqa: F401
from gt4py_tpu.next.mesh_utils import (  # noqa: F401
    Renumbering,
    shift_structure_report,
    spatial_renumbering,
)
def wait_for_compilation() -> None:
    """Join every pending async operator compilation (reference
    otf/compiled_program.wait_for_compilation — the module-level variant
    of FieldOperator.wait_for_compilation)."""
    from gt4py_tpu.next.decorators import FieldOperator as _FO  # noqa: F401
    from gt4py_tpu.next.otf import all_pools

    for pool in all_pools():
        pool.wait_for_compilation()


from gt4py_tpu.next.otf import (  # noqa: F401
    CompilationOptions,
    CompiledProgramsPool,
    MultiWorkflow,
    NamedStepSequence,
)
from gt4py_tpu.next import stages  # noqa: F401
from gt4py_tpu.next.backend import (  # noqa: F401
    Backend,
    Transforms,
    resolve as resolve_backend,
)

# Pretty, compact reporting for DSL errors reaching the top level
# (reference installs its excepthook on import, next/errors/excepthook.py:40).
from gt4py_tpu.next.errors import install_excepthook as _install_excepthook

_install_excepthook()
