"""Typed artifact stages of the JAX compile toolchain.

Role of the reference's stage dataclasses — ``ffront/stages.py``
(``DSLFieldOperatorDef:74``, ``FOASTOperatorDef:88``) and
``otf/stages.py:71-141`` (``ProgramSource``, ``CompilableSource``,
``CompilationArtifact``): each compilation phase produces a typed,
fingerprintable artifact, so workflow steps have real input/output
contracts instead of passing opaque callables around. Here the phases
are

    OperatorDefinition --deduce--> TypedDefinition --trace--> TracedProgram
        --lower--> LoweredProgram --compile--> CompiledProgram

where the "source artifact" crossing the toolchain boundary is the traced
jaxpr / StableHLO module (playing ProgramSource's role: the thing handed
to the system compiler) and the CompiledProgram wraps the XLA executable
(CompilationArtifact's role). ``gt4py_tpu.next.backend`` assembles these
into the default workflow; ``program_processors`` formatters render any
intermediate stage.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

from gt4py_tpu.next.fingerprinting import fingerprint, fingerprint_function


__all__ = [
    "OperatorDefinition",
    "TypedDefinition",
    "TracedProgram",
    "LoweredProgram",
    "CompiledProgram",
]


@dataclasses.dataclass(frozen=True)
class OperatorDefinition:
    """The raw DSL definition (reference DSLFieldOperatorDef,
    ffront/stages.py:74): a Python function plus its operator kind and any
    statically-bound parameters."""

    definition: Callable
    kind: str = "field_operator"  # 'field_operator' | 'scan_operator' | 'program'
    static_args: tuple[tuple[str, Any], ...] = ()

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(
            fingerprint_function(self.definition), self.kind, self.static_args
        )

    @property
    def name(self) -> str:
        return getattr(self.definition, "__name__", "<operator>")


@dataclasses.dataclass(frozen=True)
class TypedDefinition:
    """Definition + deduced signature (reference FOASTOperatorDef:88 — the
    post-type-deduction stage). ``type_info`` is None for unannotated
    legacy operators (deduction off)."""

    definition_stage: OperatorDefinition
    type_info: Optional[Any] = None  # type_deduction.OperatorTypeInfo

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(self.definition_stage.fingerprint, str(self.type_info))

    @property
    def definition(self) -> Callable:
        return self.definition_stage.definition


@dataclasses.dataclass(frozen=True)
class TracedProgram:
    """The traced program for one argument signature (ProgramSource role,
    reference otf/stages.py:71: 'source code + its language'). Here the
    language is jaxpr; ``closed_jaxpr`` is the in-memory IR and ``text``
    its stable rendering (fingerprinted)."""

    typed_stage: TypedDefinition
    closed_jaxpr: Any
    arg_signature: tuple

    @functools.cached_property
    def text(self) -> str:
        return str(self.closed_jaxpr)

    @functools.cached_property
    def fingerprint(self) -> str:
        return fingerprint(self.typed_stage.fingerprint, self.text, self.arg_signature)


@dataclasses.dataclass(frozen=True)
class LoweredProgram:
    """StableHLO module handed to XLA (CompilableSource role, reference
    otf/stages.py:103: the artifact a build system consumes)."""

    traced_stage: Optional[TracedProgram]
    lowered: Any  # jax.stages.Lowered

    @functools.cached_property
    def text(self) -> str:
        return self.lowered.as_text()

    @functools.cached_property
    def fingerprint(self) -> str:
        base = self.traced_stage.fingerprint if self.traced_stage else ""
        return fingerprint(base, self.text)


@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """The executable (CompilationArtifact role, reference
    otf/stages.py:141). ``executable`` is callable with the same argument
    structure the program was traced for; ``cost_analysis`` exposes XLA's
    flop/bytes estimates for perf tooling."""

    lowered_stage: Optional[LoweredProgram]
    executable: Callable

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.executable(*args, **kwargs)

    def cost_analysis(self) -> Optional[dict]:
        ca = getattr(self.executable, "cost_analysis", None)
        if ca is None:
            return None
        try:
            out = ca()
            return out[0] if isinstance(out, (list, tuple)) else out
        except Exception:
            return None
