"""Program processors: formatters and execution inspectors.

Counterpart of the reference's ``gt4py.next.program_processors`` formatter
family (/root/reference/src/gt4py/next/program_processors/
program_formatter.py and the ITIR pretty printer, iterator/
pretty_printer.py): processors that *render* a program instead of
executing it. Here the program IR is the traced jaxpr (XLA plays the
ITIR-optimizer role), so the formatters expose jaxpr and lowered-HLO text
for any field operator and argument signature.
"""

from __future__ import annotations

from typing import Any


def _exec_fn(op: Any):
    """The function that would actually execute: the FOAST-compiled form
    for FieldOperators (so transform effects — barriers, unrolls — are
    visible in every artifact), the object itself otherwise."""
    if hasattr(op, "definition") and hasattr(op, "transform_options"):
        from gt4py_tpu.next.foast import exec_definition

        return exec_definition(op)
    return getattr(op, "definition", op)


def format_jaxpr(op: Any, *args: Any, **kwargs: Any) -> str:
    """The traced program of a field operator applied to example args —
    the analog of formatting ITIR after transforms."""
    import jax

    definition = _exec_fn(op)
    return str(jax.make_jaxpr(lambda *a: definition(*a, **kwargs))(*args))


def format_lowered(op: Any, *args: Any, **kwargs: Any) -> str:
    """StableHLO text of the jitted operator (pre-XLA-optimization)."""
    import jax

    definition = _exec_fn(op)
    return jax.jit(lambda *a: definition(*a, **kwargs)).lower(*args).as_text()


def format_compiled(op: Any, *args: Any, **kwargs: Any) -> str:
    """Optimized backend HLO after XLA compilation (what actually runs)."""
    import jax

    definition = _exec_fn(op)
    return (
        jax.jit(lambda *a: definition(*a, **kwargs)).lower(*args).compile().as_text()
    )
