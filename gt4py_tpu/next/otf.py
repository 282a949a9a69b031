"""On-the-fly toolchain: compiled-programs pool, compilation options,
composable workflow steps.

Role of the reference's ``gt4py.next.otf``
(/root/reference/src/gt4py/next/otf/): the reference chains translation →
bindings → C++ compilation workflows and dispatches calls through a
``CompiledProgramsPool`` keyed by static-argument descriptors
(otf/compiled_program.py:333,495-539), compiling variants asynchronously
(otf/compilation_tasks.py). Here the toolchain is jax trace → lower →
XLA compile; this module keeps the same surface:

- :class:`CompilationOptions` — ``enable_jit``, ``static_params``
  (reference otf/options.py:23).
- :class:`CompiledProgramsPool` — executable cache keyed by (argument type
  signature, static-argument values, offset-provider id); miss triggers a
  jit lowering, optionally in a background thread (the reference's
  ThreadRunner, otf/runners.py:93); ``compile()`` AOT-compiles variants
  ahead of the first call (reference decorator.compile(), decorator.py:161).
- :class:`Workflow` / :class:`CachedStep` — minimal composable-step kit
  (reference otf/workflow.py:57,89) with persistent caching via
  :class:`gt4py_tpu.core.filecache.FileCache`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Any, Callable, Generic, Optional, Sequence, TypeVar

import numpy as np

from gt4py_tpu.next import type_system as ts
from gt4py_tpu.next.fingerprinting import fingerprint, fingerprint_function


S = TypeVar("S")
T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class CompilationOptions:
    """User-facing compilation knobs (reference otf/options.py:23).

    ``runner`` selects how cache-miss compilations execute when
    ``async_compile`` is on: ``"thread"`` (default — XLA's C++ compile
    releases the GIL, so threads parallelize it), ``"process"``
    (reference CompilationTask worker processes,
    otf/compilation_tasks.py:136 — compiles in a child process and ships
    the serialized executable back; falls back to threads when the
    target platform or the program is not process-shippable), or
    ``"sync"``. Domains are always compile-time static under XLA (static
    shapes), so the reference's ``static_domains`` knob is implied; what
    remains user-facing is variant ENUMERATION, via
    ``FieldOperator.compile(static_arg=[v1, v2], ...)`` cross products.
    """

    enable_jit: bool = True
    static_params: tuple[str, ...] = ()
    async_compile: bool = False
    compile_workers: int = 2
    runner: str = "thread"

    def replace(self, **kwargs: Any) -> "CompilationOptions":
        return dataclasses.replace(self, **kwargs)


def _static_key(value: Any) -> Any:
    """Hashable identity of a static argument VALUE (baked into the
    executable; reference ArgStaticDescriptor, otf/arguments.py:40)."""
    if isinstance(value, (int, float, bool, str, type(None))):
        return value
    if isinstance(value, tuple):
        return tuple(_static_key(v) for v in value)
    if isinstance(value, np.generic):
        return (value.dtype.str, value.item())
    raise TypeError(
        f"static_params values must be hashable scalars/tuples, got {type(value).__name__}"
    )


def _dynamic_key(value: Any) -> Any:
    """Type-signature key of a dynamic argument (shape/dtype class;
    retraces only on signature change)."""
    spec = ts.from_value(value)
    if isinstance(spec, ts.FieldType):
        from gt4py_tpu.next.embedded import Field

        assert isinstance(value, Field)
        return (spec.dims, spec.dtype.str, value.domain.shape)
    if isinstance(spec, ts.TupleType):
        from gt4py_tpu.next.named_collections import is_named_collection

        if is_named_collection(value):
            names = type(value).__named_collection_fields__
            return tuple(_dynamic_key(getattr(value, n)) for n in names)
        return tuple(_dynamic_key(v) for v in value)
    return ("scalar", spec.dtype.str)


def _provider_fingerprint(provider: Any) -> Any:
    """Content fingerprint of an offset provider (reference hashes the
    provider, otf/compiled_program.py:495-539). ``id()`` keys are unsound:
    a GC'd connectivity followed by a new allocation at the same address
    would silently reuse the wrong compiled variant. The hash is computed
    once and cached on the provider object."""
    cached = getattr(provider, "_gt4py_fingerprint", None)
    if cached is not None:
        return cached

    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(type(provider).__name__.encode())
    table = getattr(provider, "table", None)
    if table is not None:
        h.update(np.asarray(table).tobytes())
        h.update(repr(getattr(provider, "skip_value", None)).encode())
        for attr in ("source_dim", "codomain", "neighbor_dim", "domain_dim"):
            h.update(repr(getattr(provider, attr, None)).encode())
    else:
        # CartesianConnectivity-style providers: structural fields only.
        state = getattr(provider, "__dict__", None)
        h.update(repr(state if state is not None else provider).encode())
    fp = h.hexdigest()
    try:
        object.__setattr__(provider, "_gt4py_fingerprint", fp)
    except (AttributeError, TypeError):
        pass  # slots/frozen without room: recompute per call
    return fp


@dataclasses.dataclass
class _SerializedExecutable:
    """A compiled executable serialized by a worker process; loaded lazily
    in the parent (jax.experimental.serialize_executable)."""

    payload: bytes
    in_tree: Any
    out_tree: Any

    def load(self) -> Callable:
        from jax.experimental import serialize_executable as se

        return se.deserialize_and_load(self.payload, self.in_tree, self.out_tree)


def _force_cpu_in_child():
    """Pool initializer: pin the worker to the host CPU backend. Jobs are
    only shipped when the parent's target is CPU (submit() guards on
    ``jax.default_backend() == "cpu"``), but the child re-imports jax
    and would otherwise claim the parent's GPU as well. The explicit
    config (not just the env var, which site hooks may override) keeps the
    worker on the host."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def _process_compile_job(blob: bytes):
    """Worker-process entry: build, AOT-compile, and serialize one variant.
    Module-level so it is importable in the child (reference ships file
    paths to its CompilationTask workers; we ship pickled closures)."""
    import pickle

    _force_cpu_in_child()
    from jax.experimental import serialize_executable as se

    try:
        # Warm the persistent XLA cache too: even when the parent cannot
        # load the shipped executable (PJRT deserialization is per-client
        # finicky), its inline recompile becomes a disk-cache hit.
        from gt4py_tpu.cartesian.caching import enable_persistent_cache

        enable_persistent_cache()
    except Exception:
        pass
    make, args, kwargs, static_names = pickle.loads(blob)
    ex = make(args, kwargs)
    dynamic = {k: v for k, v in kwargs.items() if k not in static_names}
    # Builders with a non-plain calling convention (fused write-back puts
    # the out arrays first) expose lower_args for the AOT lowering.
    lower_args = getattr(make, "lower_args", None)
    if lower_args is not None:
        l_args, l_dyn = lower_args(args, dynamic)
    else:
        l_args, l_dyn = args, dynamic
    compiled = ex.lower(*l_args, **l_dyn).compile()
    payload, in_tree, out_tree = se.serialize(compiled)
    return _SerializedExecutable(payload, in_tree, out_tree)


class _ProcessRunner:
    """Compile variants in worker processes (reference
    otf/compilation_tasks.py:136). Only sound when the target platform is
    the host CPU (a child cannot share the parent's GPU client); GPU
    sessions and unpicklable programs fall back to the thread runner."""

    def __init__(self, workers: int):
        self.workers = workers
        self._pool: Optional[concurrent.futures.ProcessPoolExecutor] = None
        self._fallback: Optional[concurrent.futures.ThreadPoolExecutor] = None

    def submit(self, make, args, kwargs, static_names):
        import pickle
        import warnings

        import jax

        blob = None
        if jax.default_backend() == "cpu":
            def _host(v):
                # Device arrays do not pickle portably; ship host copies —
                # the child's jit re-commits them.
                return np.asarray(v) if isinstance(v, jax.Array) else v

            try:
                h_args = jax.tree_util.tree_map(_host, args)
                h_kwargs = jax.tree_util.tree_map(_host, kwargs)
                blob = pickle.dumps((make, h_args, h_kwargs, static_names))
            except Exception:
                blob = None
        if blob is not None:
            if self._pool is None:
                import multiprocessing

                # fork would inherit the parent's initialized jax runtime
                # (deadlocks); spawn re-imports cleanly in the child.
                self._pool = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_force_cpu_in_child,
                )
            return self._pool.submit(_process_compile_job, blob)
        warnings.warn(
            "process compile runner: program not process-shippable "
            "(non-CPU target or unpicklable definition); using a thread",
            stacklevel=3,
        )
        if self._fallback is None:
            self._fallback = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.workers
            )
        return self._fallback.submit(make, args, kwargs)


import weakref

_ALL_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def all_pools():
    """Live CompiledProgramsPool instances (module-level
    wait_for_compilation support, reference compiled_program.py)."""
    return list(_ALL_POOLS)


class CompiledProgramsPool:
    """Executable cache for one program definition
    (reference otf/compiled_program.py:333).

    Keys combine the dynamic signature (dims, dtype, shape per Field
    argument), the VALUES of declared static parameters, and the
    offset-provider identity. Compilation happens on miss — inline, or on
    a worker thread when ``options.async_compile`` — and
    :meth:`wait_for_compilation` joins all pending builds (reference
    compiled_program.py:164).
    """

    def __init__(self, make_executable: Callable[..., Callable], options: CompilationOptions):
        self._make = make_executable
        self.options = options
        self._programs: dict[Any, Any] = {}
        self._lock = threading.Lock()
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        _ALL_POOLS.add(self)

    def _key(self, args: Sequence[Any], kwargs: dict[str, Any], offset_provider, extra_key=None) -> Any:
        statics = []
        dynamics = []
        for name, value in kwargs.items():
            if name in self.options.static_params:
                statics.append((name, _static_key(value)))
            else:
                dynamics.append((name, _dynamic_key(value)))
        op_key = None
        if offset_provider:
            op_key = tuple(
                sorted((k, _provider_fingerprint(v)) for k, v in offset_provider.items())
            )
        return (
            tuple(_dynamic_key(a) for a in args),
            tuple(dynamics),
            tuple(statics),
            op_key,
            extra_key,
        )

    def peek(self, args, kwargs, offset_provider, extra_key=None):
        """The cached entry for this key, or None (no compile on miss)."""
        return self._programs.get(self._key(args, kwargs, offset_provider, extra_key))

    def lookup(self, args, kwargs, offset_provider, extra_key=None, make=None):
        key = self._key(args, kwargs, offset_provider, extra_key)
        entry = self._programs.get(key)
        if entry is None:
            with self._lock:
                entry = self._programs.get(key)
                if entry is None:
                    builder = make or self._make
                    if self.options.async_compile:
                        entry = self._executor_submit(args, kwargs, builder)
                    else:
                        entry = builder(args, kwargs)
                    self._programs[key] = entry
        if isinstance(entry, concurrent.futures.Future):
            try:
                entry = entry.result()
                if isinstance(entry, _SerializedExecutable):
                    # PJRT deserialization is per-client finicky AND a
                    # successfully loaded executable can still fail on
                    # first execution (device-topology mismatch between
                    # worker and parent clients) — guard the first call.
                    entry = self._guard_shipped(
                        entry.load(), key, make or self._make, args, kwargs
                    )
            except Exception as e:
                import warnings

                warnings.warn(
                    f"async variant compilation failed ({type(e).__name__}: "
                    f"{e}); recompiling inline",
                    stacklevel=2,
                )
                entry = (make or self._make)(args, kwargs)
            with self._lock:
                self._programs[key] = entry
        return entry

    def _guard_shipped(self, loaded, key, builder, args, kwargs):
        """First-call validation for a worker-shipped executable: on any
        execution failure, rebuild inline (the rebuild is cheap — the
        worker warmed the persistent XLA disk cache) and memoize the
        replacement; on success, memoize the raw loaded executable."""
        state = {"fn": loaded}

        def call(*a, **k):
            try:
                out = state["fn"](*a, **k)
            except Exception as e:
                import warnings

                warnings.warn(
                    "shipped executable is not executable in this client "
                    f"({type(e).__name__}); recompiling inline",
                    stacklevel=2,
                )
                state["fn"] = builder(args, kwargs)
                out = state["fn"](*a, **k)
            with self._lock:
                self._programs[key] = state["fn"]
            return out

        return call

    def _executor_submit(self, args, kwargs, builder=None):
        builder = builder or self._make
        runner = self.options.runner
        if runner == "process":
            if self._executor is None:
                self._executor = _ProcessRunner(self.options.compile_workers)
            return self._executor.submit(
                builder, args, kwargs, tuple(self.options.static_params)
            )
        if runner == "sync":
            done: concurrent.futures.Future = concurrent.futures.Future()
            done.set_result(builder(args, kwargs))
            return done
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.options.compile_workers
            )
        return self._executor.submit(builder, args, kwargs)

    def precompile(self, args, kwargs, offset_provider) -> None:
        """AOT-compile one variant (reference compile(), decorator.py:161)."""
        self.lookup(args, kwargs, offset_provider)

    def wait_for_compilation(self) -> None:
        with self._lock:
            futures = [e for e in self._programs.values() if isinstance(e, concurrent.futures.Future)]
        for f in futures:
            f.result()

    def __len__(self) -> int:
        return len(self._programs)


# --- minimal workflow kit ---------------------------------------------------


class Workflow(Generic[S, T]):
    """A composable step: callable S -> T with ``.chain`` (reference
    otf/workflow.py:57,89)."""

    def __init__(self, fn: Callable[[S], T], name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "step")

    def __call__(self, inp: S) -> T:
        return self.fn(inp)

    def chain(self, nxt: "Workflow[T, Any]" | Callable[[T], Any]) -> "Workflow[S, Any]":
        nxt_wf = nxt if isinstance(nxt, Workflow) else Workflow(nxt)
        return Workflow(lambda inp: nxt_wf(self(inp)), name=f"{self.name}>{nxt_wf.name}")


def step(fn: Callable[[S], T]) -> Workflow[S, T]:
    return Workflow(fn)


@dataclasses.dataclass(frozen=True)
class NamedStepSequence:
    """A workflow whose steps are the dataclass fields, executed in field
    order (reference NamedStepSequence, otf/workflow.py:97). Subclass with
    step fields; customize a pipeline with ``dataclasses.replace`` /
    :meth:`replace` — that is the user-controllable transform-pipeline
    surface (reference backend ``Transforms`` replacement idiom)."""

    def step_order(self, inp: Any) -> list[str]:
        """Step names to execute, in order. Override for per-input
        ordering (reference MultiWorkflow, otf/workflow.py:165)."""
        return [f.name for f in dataclasses.fields(self)]

    def __call__(self, inp: Any) -> Any:
        for name in self.step_order(inp):
            step_fn = getattr(self, name)
            if step_fn is None:
                continue
            inp = step_fn(inp)
        return inp

    def replace(self, **kwargs: Any) -> "NamedStepSequence":
        return dataclasses.replace(self, **kwargs)


class MultiWorkflow(NamedStepSequence):
    """Alias making the per-input-step-order variant searchable by its
    reference name (otf/workflow.py:165): override :meth:`step_order`."""


class CachedStep(Workflow[S, T]):
    """Step with persistent result caching keyed by a fingerprint of the
    input (reference CachedStep via FileCache, otf/workflow.py +
    _core/filecache.py:19)."""

    def __init__(
        self,
        fn: Callable[[S], T],
        *,
        cache_dir: str | None = None,
        key_fn: Callable[[S], str] | None = None,
        name: str | None = None,
    ):
        super().__init__(fn, name)
        from gt4py_tpu import config
        from gt4py_tpu.core.filecache import FileCache

        import os

        root = cache_dir or os.path.join(config.cache_dir(), "steps", self.name)
        self._cache = FileCache(root)
        self._key_fn = key_fn or (lambda inp: fingerprint(fingerprint_function(self.fn), inp))

    def __call__(self, inp: S) -> T:
        key = self._key_fn(inp)
        try:
            return self._cache[key]
        except KeyError:
            result = self.fn(inp)
            self._cache[key] = result
            return result
