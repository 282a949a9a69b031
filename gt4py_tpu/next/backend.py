"""Backend assembly: the Transforms multiworkflow + backend registry.

Role of the reference's ``gt4py.next.backend``
(/root/reference/src/gt4py/next/backend.py:98-154): a ``Backend`` couples
a *transforms* workflow (DSL → typed stages → executable; reference
``Transforms`` MultiWorkflow: func_to_foast → foast_to_past → past lint →
args transform → past_to_itir) with an executor, and programs carry a
Backend object — not just a string. Here the stages are the JAX toolchain
(:mod:`gt4py_tpu.next.stages`): validate → deduce → specialize →
[trace → lower] → compile, where the default ``compile`` step produces a
lazy ``jax.jit`` callable (tracing happens on first call, XLA sees the
whole program) and the ``jax:aot`` backend runs the full explicit
trace/lower/compile chain, exposing every intermediate artifact.

The pipeline is user-controllable (the reference's Transforms-replacement
idiom): ``Backend.replace(transforms=backend.transforms.replace(...))``
swaps any step, and ``program_transforms`` is a hook for function→function
rewrites applied before jit — JAX-idiomatic transforms like
``jax.checkpoint`` (rematerialization) or custom sharding wrappers.

Decorators accept either a registered name (``backend="jax"``) or a
Backend instance (``backend=my_backend``)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

from gt4py_tpu.next import stages
from gt4py_tpu.next.otf import NamedStepSequence


__all__ = [
    "Backend",
    "CompileJob",
    "Transforms",
    "REGISTRY",
    "register",
    "resolve",
    "backend_kind",
]


@dataclasses.dataclass
class CompileJob:
    """The value threaded through the Transforms workflow: the definition
    stage plus the example arguments of the variant being compiled, with
    artifact fields filled in step by step."""

    definition_stage: stages.OperatorDefinition
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    type_info: Optional[Any] = None  # pre-deduced info from the decorator
    typed_stage: Optional[stages.TypedDefinition] = None
    fn: Optional[Callable] = None  # specialized callable
    traced_stage: Optional[stages.TracedProgram] = None
    lowered_stage: Optional[stages.LoweredProgram] = None
    compiled_stage: Optional[stages.CompiledProgram] = None
    executable: Optional[Callable] = None


def _validate(job: CompileJob) -> CompileJob:
    """Definition-time checks (idempotent; decorators already ran them for
    decorated operators, but transforms pipelines can be driven with raw
    functions too)."""
    from gt4py_tpu.next.frontend_validation import validate_definition

    validate_definition(
        job.definition_stage.definition, kind=job.definition_stage.kind
    )
    return job


def _deduce(job: CompileJob) -> CompileJob:
    from gt4py_tpu.next.type_deduction import deduce

    info = job.type_info
    if info is None:
        info = deduce(
            job.definition_stage.definition, kind=job.definition_stage.kind
        )
    job.typed_stage = stages.TypedDefinition(job.definition_stage, info)
    return job


def _specialize(job: CompileJob) -> CompileJob:
    statics = dict(job.definition_stage.static_args)
    fn = job.definition_stage.definition
    job.fn = functools.partial(fn, **statics) if statics else fn
    return job


@dataclasses.dataclass(frozen=True)
class _ProgramTransforms:
    """Apply user function→function rewrites (remat, custom wrappers)."""

    rewrites: tuple[Callable[[Callable], Callable], ...] = ()

    def __call__(self, job: CompileJob) -> CompileJob:
        for rw in self.rewrites:
            job.fn = rw(job.fn)
        return job


def _flat_call(job: CompileJob):
    """(fn over positional-only leaves, example flat args, kwarg names):
    dynamic kwargs are flattened to a positional tail so AOT executables
    never bake kwarg VALUES into the trace."""
    names = sorted(job.kwargs)
    n_pos = len(job.args)
    fn = job.fn

    def flat(*a):
        return fn(*a[:n_pos], **dict(zip(names, a[n_pos:])))

    example = (*job.args, *(job.kwargs[n] for n in names))
    return flat, example, names


def _trace(job: CompileJob) -> CompileJob:
    import jax

    flat, example, _ = _flat_call(job)
    closed = jax.make_jaxpr(flat)(*example)
    sig = tuple(
        (tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", type(a).__name__)))
        for a in jax.tree_util.tree_leaves(example)
    )
    assert job.typed_stage is not None
    job.traced_stage = stages.TracedProgram(job.typed_stage, closed, sig)
    return job


def _lower(job: CompileJob) -> CompileJob:
    import jax

    flat, example, _ = _flat_call(job)
    lowered = jax.jit(flat).lower(*example)
    job.lowered_stage = stages.LoweredProgram(job.traced_stage, lowered)
    return job


def _compile_jit(job: CompileJob) -> CompileJob:
    """Default compile step: lazy jit (identical call semantics to
    ``jax.jit(definition)`` — retraces transparently, kwargs allowed)."""
    import jax

    job.executable = jax.jit(job.fn)
    return job


def _compile_aot(job: CompileJob) -> CompileJob:
    """AOT compile step: explicit XLA compilation of the lowered module.
    The executable accepts the variant's positional args plus the dynamic
    kwargs it was lowered for (values free, structure fixed — the pool
    dispatches per signature)."""
    assert job.lowered_stage is not None
    compiled = job.lowered_stage.lowered.compile()
    job.compiled_stage = stages.CompiledProgram(job.lowered_stage, compiled)
    names = sorted(job.kwargs)

    def executable(*a, **kw):
        return compiled(*a, *(kw[n] for n in names))

    job.executable = executable
    return job


@dataclasses.dataclass(frozen=True)
class Transforms(NamedStepSequence):
    """The Transforms multiworkflow (reference backend.py:98-137).
    Fields execute in order; None steps are skipped. Customize with
    ``replace``: e.g. ``transforms.replace(program_transforms=
    _ProgramTransforms((jax.checkpoint,)))`` for rematerialization."""

    validate: Optional[Callable] = _validate
    deduce: Optional[Callable] = _deduce
    specialize: Optional[Callable] = _specialize
    program_transforms: Optional[Callable] = dataclasses.field(
        default_factory=_ProgramTransforms
    )
    trace: Optional[Callable] = None  # default path: jit traces lazily
    lower: Optional[Callable] = None
    compile: Optional[Callable] = _compile_jit

    def with_rewrites(self, *rewrites: Callable[[Callable], Callable]) -> "Transforms":
        return self.replace(program_transforms=_ProgramTransforms(tuple(rewrites)))


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named execution strategy (reference backend.py:148): ``kind``
    selects the runtime (how operators execute), ``transforms`` builds the
    executable for the jax-compiled kinds."""

    name: str
    kind: str  # 'jax' | 'numpy' | 'gpu' | 'eager'
    transforms: Transforms = dataclasses.field(default_factory=Transforms)

    def make_executable(
        self,
        definition: Callable,
        *,
        op_kind: str = "field_operator",
        static_args: tuple[tuple[str, Any], ...] = (),
        type_info: Any = None,
        args: tuple = (),
        kwargs: Optional[dict] = None,
    ) -> Callable:
        job = CompileJob(
            definition_stage=stages.OperatorDefinition(
                definition, op_kind, static_args
            ),
            args=args,
            kwargs=dict(kwargs or {}),
            type_info=type_info,
        )
        job = self.transforms(job)
        assert job.executable is not None, "transforms produced no executable"
        return job.executable

    def compile_job(self, definition: Callable, *args: Any, **kwargs: Any) -> CompileJob:
        """Run the transforms and return the full job with every artifact
        (for inspection/formatters)."""
        job = CompileJob(
            definition_stage=stages.OperatorDefinition(definition),
            args=args,
            kwargs=dict(kwargs),
        )
        return self.transforms(job)

    def replace(self, **kwargs: Any) -> "Backend":
        return dataclasses.replace(self, **kwargs)


REGISTRY: dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    REGISTRY[backend.name] = backend
    return backend


register(Backend(name="jax", kind="jax"))
register(
    Backend(
        name="jax:aot",
        kind="jax",
        transforms=Transforms(trace=_trace, lower=_lower, compile=_compile_aot),
    )
)
register(Backend(name="numpy", kind="numpy", transforms=Transforms(compile=None)))
register(Backend(name="gpu", kind="gpu"))
register(Backend(name="embedded", kind="eager", transforms=Transforms(compile=None)))


def resolve(backend: Union[str, Backend, None]) -> Optional[Backend]:
    """Name → Backend; Backend instances pass through; None (eager) stays
    None."""
    if backend is None or isinstance(backend, Backend):
        return backend
    try:
        return REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"Unknown backend {backend!r}; registered: {sorted(REGISTRY)}"
        ) from None


def backend_kind(backend: Union[str, Backend, None]) -> Optional[str]:
    """The runtime-dispatch kind of a backend spec ('jax', 'numpy',
    'gpu', 'eager') or None for eager execution."""
    if backend is None:
        return None
    if isinstance(backend, Backend):
        return backend.kind
    resolved = REGISTRY.get(backend)
    if resolved is not None:
        return resolved.kind
    return backend  # legacy free-form strings keep their own dispatch
