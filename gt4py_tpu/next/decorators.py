"""Field-view entry points: @field_operator, @scan_operator, @program.

Counterpart of the reference's ``gt4py.next.ffront.decorator``
(/root/reference/src/gt4py/next/ffront/decorator.py:749,825,515). The
reference parses these functions into FOAST/PAST and compiles via ITIR to
C++/DaCe; here the embedded JAX path *is* the compiled path: the definition
executes on pytree Fields, optionally under ``jax.jit`` (``backend="jax"``,
the default), so XLA sees the whole program. ``backend=None`` runs eagerly
for debugging — same numerics, no compilation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from gt4py_tpu.next.common import Dimension, Domain, NamedRange, UnitRange
from gt4py_tpu.next.embedded import Field, offset_provider_context


def _restrict_result(result: "Field", target: Domain, out_dtype, xp) -> Any:
    """Slice/permute/cast/broadcast an operator result to ``target``
    (shared by the eager write-out and the traced write-back). A
    broadcast-placeholder axis (unbounded range, size-1 array axis —
    fbuiltins.broadcast) keeps its single element in the slice and
    expands at the end."""
    slices = []
    for nr in target.ranges:
        if nr.dim not in result.domain:
            raise ValueError(
                f"Output dimension {nr.dim} missing from result {result.domain}"
            )
        rr = result.domain[nr.dim].unit_range
        if not rr.is_finite:
            slices.append(slice(0, 1))
        else:
            if nr.unit_range.start < rr.start or nr.unit_range.stop > rr.stop:
                raise ValueError(
                    f"Output range {nr.dim.value}={nr.unit_range} exceeds the "
                    f"operator result domain {nr.dim.value}={rr} (shifts shrink "
                    "the result; size the out field/domain accordingly)"
                )
            slices.append(slice(nr.unit_range.start - rr.start, nr.unit_range.stop - rr.start))
    perm = [result.domain.index(nr.dim) for nr in target.ranges]
    arr = result.ndarray
    if perm != sorted(perm):
        arr = arr.transpose(perm)
        arr = arr[tuple(slices[i] for i in range(len(slices)))]
    else:
        arr = arr[tuple(slices)]
    value = arr.astype(out_dtype)
    target_shape = tuple(len(nr.unit_range) for nr in target.ranges)
    if tuple(value.shape) != target_shape:
        value = xp.broadcast_to(value, target_shape)
    return value


def _out_slices(target: Domain, out_domain: Domain) -> tuple:
    return tuple(
        slice(
            nr.unit_range.start - out_domain[nr.dim].unit_range.start,
            nr.unit_range.stop - out_domain[nr.dim].unit_range.start,
        )
        for nr in target.ranges
    )


def _write_out(result: Any, out: Any, domain: Optional[Domain]) -> None:
    """Write an operator result into the ``out`` field(s) (functional
    rebind of the underlying array, restricted to the out/result domain
    intersection, or to ``domain`` if given)."""
    if isinstance(result, tuple):
        if not isinstance(out, tuple) or len(out) != len(result):
            raise ValueError("Mismatched tuple outputs")
        doms = (
            domain
            if isinstance(domain, tuple)
            else (domain,) * len(result)
        )
        if len(doms) != len(result):
            raise ValueError(
                "domain tuple must match the output tuple structure"
            )
        for r, o, d in zip(result, out, doms):
            _write_out(r, o, d)
        return
    assert isinstance(result, Field) and isinstance(out, Field)
    import jax.numpy as jnp

    target = out.domain if domain is None else domain
    xp_v = np if _xp_of(out) is np else jnp
    value = _restrict_result(result, target, out.dtype, xp_v)
    if domain is not None and target is not out.domain:
        # Partial write: update the sub-block of out.
        sl = _out_slices(target, out.domain)
        if xp_v is np:
            buf = np.array(out.ndarray, copy=True)
            buf[sl] = np.asarray(value)
            out._rebind(buf)
        else:
            out._rebind(jnp.asarray(out.ndarray).at[sl].set(value))
    else:
        out._rebind(
            np.asarray(value) if xp_v is np else jnp.asarray(value)
        )


# --- fused (in-jit) write-back ----------------------------------------------
# The eager _write_out costs 3 XLA dispatches per call (slice, astype,
# asarray) — the dominant field-operator call overhead. For the default
# jax backend the write-back geometry is static per (signature, out
# geometry), so it traces INTO the pooled executable: one dispatch total.


def _out_meta(out: Any):
    if isinstance(out, tuple):
        return tuple(_out_meta(o) for o in out)
    return (out.domain, out.dtype)


def _out_key(out: Any, dom: Optional[Domain]):
    def meta_key(m):
        if isinstance(m, tuple) and m and isinstance(m[0], tuple):
            return tuple(meta_key(x) for x in m)
        domain_, dtype_ = m
        return (
            tuple(
                (nr.dim.value, nr.dim.kind.value, nr.unit_range.start, nr.unit_range.stop)
                for nr in domain_.ranges
            ),
            np.dtype(dtype_).str,
        )

    def dkey(d):
        if d is None:
            return None
        if isinstance(d, tuple):
            return tuple(dkey(x) for x in d)
        return tuple(
            (nr.dim.value, nr.unit_range.start, nr.unit_range.stop)
            for nr in d.ranges
        )

    return ("out", meta_key(_out_meta(out)), dkey(dom))


def _out_arrays(out: Any):
    if isinstance(out, tuple):
        return tuple(_out_arrays(o) for o in out)
    return out.ndarray


@dataclasses.dataclass
class _FusedBuilder:
    """Picklable fused-writeback variant builder: the process compile
    runner ships it to a worker (a bare lambda closure is not picklable,
    which silently demoted fused variants to the thread runner). Exposes
    ``lower_args`` so the worker can AOT-lower with the fused calling
    convention (out_arrays first)."""

    op: Any
    out_meta: Any
    dom: Any
    backend: Any

    def __call__(self, args, kwargs):
        from gt4py_tpu.next.backend import Backend, resolve

        be = (
            resolve(self.backend)
            if isinstance(self.backend, (str, Backend))
            else self.backend
        )
        return self.op._make_fused(args, kwargs, self.out_meta, self.dom, be)

    def lower_args(self, args, dynamic):
        def zeros(meta):
            if isinstance(meta, tuple) and meta and isinstance(meta[0], tuple):
                return tuple(zeros(m) for m in meta)
            domain_, dtype_ = meta
            shape = tuple(len(nr.unit_range) for nr in domain_.ranges)
            return np.zeros(shape, dtype_)

        return (zeros(self.out_meta),) + tuple(args), dynamic


def _rebind_out(out: Any, new: Any) -> None:
    if isinstance(out, tuple):
        for o, n in zip(out, new):
            _rebind_out(o, n)
        return
    out._rebind(new)


def _writeback_traced(result: Any, meta: Any, dom: Optional[Domain], out_arrays: Any):
    import jax.numpy as jnp

    if isinstance(result, tuple):
        doms = dom if isinstance(dom, tuple) else (dom,) * len(result)
        return tuple(
            _writeback_traced(r, m, d, oa)
            for r, m, d, oa in zip(result, meta, doms, out_arrays)
        )
    assert isinstance(result, Field)
    out_domain, out_dtype = meta
    target = out_domain if dom is None else dom
    value = _restrict_result(result, target, out_dtype, jnp)
    if dom is not None and target is not out_domain:
        return jnp.asarray(out_arrays).at[_out_slices(target, out_domain)].set(value)
    return jnp.asarray(value)


def _first_domain(out: Any) -> Optional[Domain]:
    if isinstance(out, tuple):
        for o in out:
            d = _first_domain(o)
            if d is not None:
                return d
        return None
    return out.domain if isinstance(out, Field) else None


def _xp_of(f: Field):
    from gt4py_tpu.next.embedded import _xp

    return _xp(f.ndarray)


def _xp_of_tree(out: Any):
    while isinstance(out, tuple):
        out = out[0]
    return _xp_of(out)


def _collect_fields(tree: Any) -> list:
    """Field leaves of an args/kwargs structure, in deterministic order
    (tuples/lists in sequence, dict keys sorted)."""
    acc: list = []

    def walk(node: Any) -> None:
        if isinstance(node, Field):
            acc.append(node)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])

    walk(tree)
    return acc


def _under_trace(*trees: Any) -> bool:
    """Whether any Field leaf holds a JAX tracer (an enclosing jit is
    tracing us — e.g. a whole-Program jit): dispatch machinery must get
    out of the way and let the trace inline the computation."""
    import jax

    for tree in trees:
        for leaf in jax.tree_util.tree_leaves(tree):
            if isinstance(leaf, jax.core.Tracer):
                return True
    return False


def _as_numpy(obj: Any) -> Any:
    """Convert Field pytrees to NumPy-backed Fields: the independent-oracle
    execution mode (reference "roundtrip" embedded-NumPy backend) — all
    arithmetic then runs through NumPy, never XLA."""
    if isinstance(obj, Field):
        return Field(
            obj.domain,
            np.asarray(obj.ndarray),
            None if obj.mask is None else np.asarray(obj.mask),
        )
    if isinstance(obj, tuple):
        return tuple(_as_numpy(o) for o in obj)
    return obj


@dataclasses.dataclass
class FieldOperator:
    """Callable field operator (reference decorator.py:561).

    Dispatches through a :class:`CompiledProgramsPool` keyed by argument
    signature + static-parameter values + offset-provider identity
    (reference otf/compiled_program.py:333); ``compile()`` AOT-builds
    variants (reference decorator.py:161)."""

    definition: Callable
    backend: Optional[str] = "jax"
    options: Any = None  # CompilationOptions; None -> defaults
    # Deduced signature (next/type_deduction.py) when the definition is
    # annotated; None = legacy unannotated operator (deduction off).
    type_info: Any = None
    # FOAST transform knobs (next/foast.TransformOptions); None -> the
    # env-resolved default pipeline (folding + CSE + DCE on).
    transform_options: Any = None

    def __post_init__(self):
        from gt4py_tpu.next.otf import CompilationOptions, CompiledProgramsPool

        if self.options is None:
            self.options = CompilationOptions()
        self._pool = CompiledProgramsPool(self._make_executable, self.options)

    def __getstate__(self):
        # Picklable for the process compile runner (reference ships its
        # programs to CompilationTask workers); the pool (locks, futures)
        # rebuilds empty in the child, as does the FOAST compile cache
        # (generated function objects do not pickle).
        state = self.__dict__.copy()
        state.pop("_pool", None)
        state.pop("_foast_cache", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__post_init__()

    def with_backend(self, backend: Optional[str]) -> "FieldOperator":
        return FieldOperator(
            self.definition, backend, self.options, self.type_info,
            self.transform_options,
        )

    def with_transforms(self, options: Any = None, **kwargs: Any) -> "FieldOperator":
        """Select FOAST transform options (the analog of the reference
        pass-manager knobs, iterator/transforms/pass_manager.py:135-144):
        ``op.with_transforms(unroll_reduce=True)``,
        ``op.with_transforms(extract_temporaries=True)``,
        ``op.with_transforms(enabled=False)`` (run the raw definition)."""
        from gt4py_tpu.next.foast import default_options

        base = options if options is not None else (
            self.transform_options or default_options()
        )
        opts = base.replace(**kwargs) if kwargs else base
        return FieldOperator(
            self.definition, self.backend, self.options, self.type_info, opts
        )

    def inspect(
        self, *args, stage: str = "jaxpr", offset_provider: Optional[dict] = None,
        **kwargs,
    ) -> str:
        """Textual program artifact for example arguments — the
        observability analog of the reference's ITIR formatters / transform
        dumps (program_formatter.py): ``stage`` selects ``"jaxpr"`` (the
        traced program), ``"stablehlo"`` (lowered, pre-XLA-optimization) or
        ``"hlo"`` (optimized — what actually runs). Steering happens
        through ``Transforms.with_rewrites`` (e.g. ``jax.checkpoint`` as
        the global_tmps/rematerialization analog)."""
        from gt4py_tpu.next import program_processors as pp
        from gt4py_tpu.next.embedded import offset_provider_context

        if stage == "foast":
            from gt4py_tpu.next.foast import foast_source

            with offset_provider_context(offset_provider):
                return foast_source(self)
        fmt = {
            "jaxpr": pp.format_jaxpr,
            "stablehlo": pp.format_lowered,
            "hlo": pp.format_compiled,
        }.get(stage)
        if fmt is None:
            raise ValueError(
                f"Unknown stage {stage!r} (expected foast | jaxpr | stablehlo | hlo)"
            )
        with offset_provider_context(offset_provider):
            return fmt(self, *args, **kwargs)

    def with_compilation_options(self, options=None, **kwargs) -> "FieldOperator":
        """Reference decorator.py:111 (`with_compilation_options`)."""
        opts = options if options is not None else self.options.replace(**kwargs)
        return FieldOperator(
            self.definition, self.backend, opts, self.type_info,
            self.transform_options,
        )

    def _make_executable(self, args, kwargs) -> Callable:
        from gt4py_tpu.next.backend import Backend, resolve
        from gt4py_tpu.next.foast import exec_definition

        definition = exec_definition(self)
        statics = {k: v for k, v in kwargs.items() if k in self.options.static_params}
        dynamic = {k: v for k, v in kwargs.items() if k not in statics}
        be = resolve(self.backend) if isinstance(self.backend, (str, Backend)) else None
        if be is not None and be.kind == "jax":
            # Build through the backend's Transforms workflow (reference
            # backend.py:154 Backend.compile): user-replaced steps apply.
            return be.make_executable(
                definition,
                op_kind="field_operator",
                static_args=tuple(sorted(statics.items())),
                type_info=self.type_info,
                args=args,
                kwargs=dynamic,
            )
        import jax

        fn = functools.partial(definition, **statics) if statics else definition
        return jax.jit(fn)

    def _make_fused(self, args, kwargs, out_meta, dom, be) -> Callable:
        """Executable with the out-field write-back traced in (one XLA
        dispatch per call instead of four — see the module comment)."""
        import jax

        from gt4py_tpu.next.foast import exec_definition

        definition = exec_definition(self)
        statics = {k: v for k, v in kwargs.items() if k in self.options.static_params}
        fn = functools.partial(definition, **statics) if statics else definition
        pt = getattr(be.transforms, "program_transforms", None)
        for rw in getattr(pt, "rewrites", ()) or ():
            fn = rw(fn)

        def wrapped(out_arrays, *a, **dyn):
            result = fn(*a, **dyn)
            return _writeback_traced(result, out_meta, dom, out_arrays)

        return jax.jit(wrapped)

    def compile(self, *args, offset_provider: Optional[dict] = None, **kwargs) -> "FieldOperator":
        """AOT-compile variants for the given example arguments (reference
        AOT compile(), decorator.py:161). A LIST value for a declared
        static parameter enumerates variants — the cross product of all
        such lists is compiled (reference compiled_program.py:
        static-descriptor cross products; domains need no enumeration here
        because XLA shapes are always compile-time static). Returns self.
        """
        import itertools

        list_params = {
            k: v
            for k, v in kwargs.items()
            if k in self.options.static_params and isinstance(v, list)
        }
        with offset_provider_context(offset_provider):
            if not list_params:
                self._pool.precompile(args, kwargs, offset_provider)
                return self
            names = sorted(list_params)
            for combo in itertools.product(*(list_params[n] for n in names)):
                variant = dict(kwargs)
                variant.update(dict(zip(names, combo)))
                self._pool.precompile(args, variant, offset_provider)
        return self

    def wait_for_compilation(self) -> None:
        self._pool.wait_for_compilation()

    def __call__(
        self,
        *args,
        out: Any = None,
        offset_provider: Optional[dict] = None,
        domain: Optional[Union[Domain, dict]] = None,
        **kwargs,
    ):
        if out is None:
            # Called from inside another field operator: plain application
            # (through the callee's own FOAST pipeline, so transforms
            # compose across nested operator calls).
            from gt4py_tpu.next.foast import exec_definition

            return exec_definition(self)(*args, **kwargs)
        if self.type_info is not None:
            from gt4py_tpu.next.type_deduction import check_call_args, check_out_arg

            op_name = getattr(self.definition, "__name__", "field_operator")
            check_call_args(self.type_info, args, kwargs, name=op_name)
            check_out_arg(self.type_info, out, name=op_name)
        from gt4py_tpu.instrumentation.hooks import stencil_call
        from gt4py_tpu.instrumentation.metrics import MetricsCollector
        from gt4py_tpu.next.common import domain as make_domain

        if isinstance(domain, tuple):
            # per-output domains for tuple outputs (reference
            # test_multiple_output_domains.py: domain=({J: ...}, {I: ...}))
            dom = tuple(
                make_domain(d) if d is not None else None for d in domain
            )
        else:
            dom = make_domain(domain) if domain is not None else None
        name = getattr(self.definition, "__name__", "field_operator")
        # Hook point + leveled metrics around the program call (reference
        # ffront/decorator.py:62-83, instrumentation/metrics.py:240).
        with stencil_call.wrap(name), MetricsCollector(name, "total"):
            with offset_provider_context(offset_provider):
                from gt4py_tpu.next.backend import backend_kind

                if _under_trace(args, out, kwargs):
                    # Inside an enclosing jit (whole-program trace): the
                    # outer trace owns execution — inline regardless of
                    # this operator's declared backend.
                    from gt4py_tpu.next.foast import exec_definition

                    result = exec_definition(self)(*args, **kwargs)
                    _write_out(result, out, dom)
                    return
                kind = backend_kind(self.backend)
                if kind == "numpy":
                    # Independent oracle: run the definition on NumPy-backed
                    # fields (reference roundtrip backend role — foreign
                    # arithmetic to validate the jax path against).
                    np_args = tuple(_as_numpy(a) for a in args)
                    np_kwargs = {k: _as_numpy(v) for k, v in kwargs.items()}
                    result = self.definition(*np_args, **np_kwargs)
                    _write_out(result, out, dom)
                    return
                if kind == "gpu":
                    # Structured (cartesian-offset) operators execute on the
                    # cartesian ``gpu`` backend (SURVEY §7 step 8);
                    # unstructured signatures fall through to embedded.
                    from gt4py_tpu.next.cartesian_bridge import try_call

                    if dom is None and try_call(
                        self, args, kwargs, out, offset_provider
                    ):
                        return
                    from gt4py_tpu.next.foast import exec_definition

                    result = exec_definition(self)(*args, **kwargs)
                    _write_out(result, out, dom)
                    return
                if kind == "jax" and self.options.enable_jit:
                    from gt4py_tpu.next.backend import Backend, resolve, _compile_jit

                    dynamic = {
                        k: v
                        for k, v in kwargs.items()
                        if k not in self.options.static_params
                    }
                    be = (
                        resolve(self.backend)
                        if isinstance(self.backend, (str, Backend))
                        else None
                    )
                    default_pipeline = (
                        be is not None
                        and be.transforms.compile is _compile_jit
                        and be.transforms.trace is None
                    )
                    raw_ready = self._pool.peek(args, kwargs, offset_provider)
                    if (
                        default_pipeline
                        and raw_ready is None
                        and _xp_of_tree(out) is not np
                    ):
                        # Fused write-back: out geometry is part of the key.
                        out_meta = _out_meta(out)
                        ex = self._pool.lookup(
                            args, kwargs, offset_provider,
                            extra_key=_out_key(out, dom),
                            make=_FusedBuilder(self, out_meta, dom, self.backend),
                        )
                        _rebind_out(out, ex(_out_arrays(out), *args, **dynamic))
                        return
                    ex = self._pool.lookup(args, kwargs, offset_provider)
                    result = ex(*args, **dynamic)
                else:
                    from gt4py_tpu.next.foast import exec_definition

                    result = exec_definition(self)(*args, **kwargs)
                _write_out(result, out, dom)

    def __get__(self, obj, objtype=None):
        return self


def field_operator(definition: Optional[Callable] = None, *, backend: str | None = "jax"):
    """Declare a field operator (reference decorator.py:749)."""
    from gt4py_tpu.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="field_operator")
        from gt4py_tpu.next.type_deduction import deduce

        info = deduce(fn, kind="field_operator")
        _publish_definition(fn)
        return functools.wraps(fn)(FieldOperator(fn, backend, None, info))

    return wrap(definition) if definition is not None else wrap


def _publish_definition(fn: Callable) -> None:
    """Make the raw definition pickle-by-reference: the decorator rebinds
    the module attribute to the FieldOperator, so pickle's name lookup
    would resolve to the wrong object. Stash the function under a mangled
    module alias and point its __qualname__ there (needed by the process
    compile runner, reference otf/compilation_tasks.py workers)."""
    import sys

    mod = sys.modules.get(getattr(fn, "__module__", None))
    if mod is None or "<locals>" in fn.__qualname__:
        return
    alias = f"_gt4py_defn__{fn.__name__}"
    if getattr(mod, alias, None) is not fn:
        setattr(mod, alias, fn)
    fn.__qualname__ = alias


@dataclasses.dataclass
class ScanOperator:
    """Vertical scan operator (reference decorator.py:825): the definition
    is a per-level function ``f(carry, *args) -> carry`` (or tuple carry),
    executed along ``axis`` with ``lax.scan``, vectorized over all other
    dimensions."""

    definition: Callable
    axis: Dimension
    forward: bool
    init: Any
    backend: Optional[str] = "jax"
    # Deduced signature (next/type_deduction.py); params[0] is the carry.
    type_info: Any = None
    # FOAST transform knobs for the per-level body (next/foast).
    transform_options: Any = None

    def with_backend(self, backend: Optional[str]) -> "ScanOperator":
        return ScanOperator(
            self.definition, self.axis, self.forward, self.init, backend,
            self.type_info, self.transform_options,
        )

    def with_transforms(self, options: Any = None, **kwargs: Any) -> "ScanOperator":
        """FOAST transform options for the per-level body — see
        FieldOperator.with_transforms (folding/CSE/DCE apply level-wise;
        reductions/temporaries knobs are meaningless inside a scan body
        but harmless)."""
        from gt4py_tpu.next.foast import default_options

        base = options if options is not None else (
            self.transform_options or default_options()
        )
        opts = base.replace(**kwargs) if kwargs else base
        return ScanOperator(
            self.definition, self.axis, self.forward, self.init, self.backend,
            self.type_info, opts,
        )

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_exec_cache", None)  # jitted executables do not pickle
        state.pop("_foast_cache", None)  # generated functions do not pickle
        return state

    def __call__(
        self,
        *args,
        out: Any = None,
        offset_provider: Optional[dict] = None,
        domain: Optional[Union[Domain, dict]] = None,
        **kwargs,
    ):
        # Called on symbolic values inside a cartesian-bridge trace: inline
        # as a sequential vertical loop of the enclosing stencil (the
        # composition fusion that keeps scan temporaries in registers).
        symbolic = [
            a
            for a in (*args, *kwargs.values())
            if getattr(a, "_gt_symbolic_", False)
        ]
        if symbolic:
            return symbolic[0].tr.trace_scan(self, args, kwargs)
        if self.type_info is not None and out is not None:
            from gt4py_tpu.next.type_deduction import OperatorTypeInfo, check_call_args

            names = list(self.type_info.params)
            trimmed = OperatorTypeInfo(
                params={n: self.type_info.params[n] for n in names[1:]},
                returns=self.type_info.returns,
            )
            check_call_args(
                trimmed, args, kwargs,
                name=getattr(self.definition, "__name__", "scan_operator"),
                element_only=True,
            )
        from gt4py_tpu.next.backend import backend_kind
        from gt4py_tpu.next.common import domain as make_domain

        if isinstance(domain, tuple):
            # per-output domains for tuple outputs (reference
            # test_multiple_output_domains.py: domain=({J: ...}, {I: ...}))
            dom = tuple(
                make_domain(d) if d is not None else None for d in domain
            )
        else:
            dom = make_domain(domain) if domain is not None else None
        kind = backend_kind(self.backend)
        if (
            kind == "gpu"
            and out is not None
            and dom is None
            and not _under_trace(args, out, kwargs)
        ):
            # Structured scans lower onto the cartesian K-sweep kernel (the
            # one that serves GTScript FORWARD/BACKWARD loops); unsupported
            # shapes fall through to embedded.
            from gt4py_tpu.next.cartesian_bridge import try_call_scan

            with offset_provider_context(offset_provider):
                if try_call_scan(self, args, kwargs, out, offset_provider):
                    return None
        jit_ok = (
            kind == "jax"
            and out is not None
            and not any(
                isinstance(a, Field) and _xp_of(a) is np for a in args
            )
            and _xp_of_tree(out) is not np
            and not _under_trace(args, out, kwargs)
        )
        if jit_ok:
            # Pooled jitted scan with the write-back traced in (the eager
            # path re-traces lax.scan EVERY call) — same design as
            # FieldOperator's fused write-back.
            import jax

            cache = self.__dict__.setdefault("_exec_cache", {})
            key = _out_key(out, dom)
            fn = cache.get(key)
            if fn is None:
                out_meta = _out_meta(out)

                _odom = _first_domain(out)

                def fn(out_arrays, a, kw, _meta=out_meta, _dom=dom, _od=_odom):
                    result = self._apply(a, kw, out_domain=_od)
                    return _writeback_traced(result, _meta, _dom, out_arrays)

                fn = jax.jit(fn)
                cache[key] = fn
            with offset_provider_context(offset_provider):
                _rebind_out(out, fn(_out_arrays(out), args, kwargs))
            return None
        with offset_provider_context(offset_provider):
            result = self._apply(
                args, kwargs,
                out_domain=_first_domain(out) if out is not None else None,
            )
        if out is None:
            return result
        _write_out(result, out, dom)
        return None

    def _apply(self, args, kwargs, out_domain: Optional[Domain] = None):
        import jax
        import jax.numpy as jnp
        from jax import lax

        from gt4py_tpu.next.backend import backend_kind
        from gt4py_tpu.next.foast import exec_definition

        definition = exec_definition(self)

        is_field = lambda x: isinstance(x, Field)  # noqa: E731
        np_mode = backend_kind(self.backend) == "numpy" and not _under_trace(args)
        if np_mode:
            args = jax.tree_util.tree_map(_as_numpy, args, is_leaf=is_field)
        # Arguments are pytrees: nested tuples of Fields and scalars ride
        # as single scan arguments (reference test_tuple_scalar_scan,
        # test_scan_nested_tuple_input).
        field_args = [
            leaf
            for a in args
            for leaf in jax.tree_util.tree_leaves(a, is_leaf=is_field)
            if isinstance(leaf, Field)
        ]
        from gt4py_tpu.next.embedded import _promote_dims

        if field_args:
            dims = field_args[0].dims
            for f in field_args[1:]:
                dims = _promote_dims(dims, f.dims)
        elif out_domain is not None:
            # No field inputs (pure carry iteration, reference
            # test_scan_nested_tuple_output): the out field supplies the
            # iteration domain.
            dims = out_domain.dims
        else:
            raise ValueError(
                "scan operator without Field arguments needs an out= field "
                "to define its domain"
            )
        if self.axis not in dims:
            raise ValueError(f"scan axis {self.axis} not present in arguments")
        # Common domain: per promoted dim, intersect the ranges of every
        # field that HAS the dim (a K-only column + an (I, K) plane must
        # broadcast the column across I, so no single argument can serve
        # as the alignment reference).
        common_ranges = []
        for d in dims:
            r = None
            for f in field_args:
                if d in f.domain:
                    rr = f.domain[d].unit_range
                    r = rr if r is None else r.intersection(rr)
            if r is None:
                r = out_domain[d].unit_range
            common_ranges.append(NamedRange(d, r))
        ref = Field.__new__(Field)
        ref.domain = Domain(tuple(common_ranges))
        aligned = []
        dom = None if field_args else ref.domain

        def align_leaf(leaf):
            nonlocal dom
            if isinstance(leaf, Field):
                d, arr = leaf._aligned(dims, ref)
                dom = d if dom is None else dom.intersection(d)
                return arr
            return leaf

        for a in args:
            aligned.append(
                jax.tree_util.tree_map(align_leaf, a, is_leaf=is_field)
            )
        k_axis = dims.index(self.axis)
        nk = dom.shape[k_axis]
        non_k_shape = tuple(s for i, s in enumerate(dom.shape) if i != k_axis)

        def body(carry, per_level):
            # xs=None (no-argument scans) delivers None per level.
            new = definition(carry, *(per_level or ()), **kwargs)
            return new, new

        def broadcast_init(value):
            return jnp.broadcast_to(jnp.asarray(value), non_k_shape)

        def leaf_to_xs(xp):
            def conv(a):
                if hasattr(a, "ndim") and a.ndim == len(dims):
                    return xp.moveaxis(a, k_axis, 0)
                return xp.broadcast_to(xp.asarray(a), (nk,) + non_k_shape)

            return conv

        from gt4py_tpu.next.embedded import _xp

        use_np = bool(field_args) and _xp(field_args[0].ndarray) is np
        if not field_args:
            use_np = np_mode
        if use_np:
            # NumPy oracle mode: plain Python level loop (reference
            # embedded scan semantics, no lax.scan — foreign arithmetic).
            def np_bcast(value):
                return np.broadcast_to(np.asarray(value), non_k_shape)

            carry = jax.tree_util.tree_map(np_bcast, self.init)
            xs = tuple(
                jax.tree_util.tree_map(leaf_to_xs(np), a) for a in aligned
            )
            levels = []
            order = range(nk) if self.forward else range(nk - 1, -1, -1)
            for k in order:
                per_level = tuple(
                    jax.tree_util.tree_map(lambda l: l[k], x) for x in xs
                )
                # Oracle independence: the NumPy level loop always runs the
                # RAW definition (FOAST-equivalence is what oracle tests check).
                carry = self.definition(carry, *per_level, **kwargs)
                levels.append(carry)
            if not self.forward:
                levels.reverse()
            stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *levels)
        else:
            init = jax.tree_util.tree_map(broadcast_init, self.init)

            scan_xs = tuple(
                jax.tree_util.tree_map(leaf_to_xs(jnp), a) for a in aligned
            )
            _, stacked = lax.scan(
                body, init, scan_xs if scan_xs else None,
                length=None if scan_xs else nk,
                reverse=not self.forward,
            )
        # stacked: pytree of (nk, *non_k_shape)

        def to_field(arr):
            xp = np if isinstance(arr, np.ndarray) else jnp
            return Field(dom, xp.moveaxis(arr, 0, k_axis))

        return jax.tree_util.tree_map(to_field, stacked)

    def __get__(self, obj, objtype=None):
        return self


def scan_operator(
    definition: Optional[Callable] = None,
    *,
    axis: Dimension,
    forward: bool = True,
    init: Any = 0.0,
    backend: str | None = "jax",
):
    """Declare a column scan operator (reference decorator.py:825)."""

    from gt4py_tpu.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="scan_operator")
        _validate_scan_signature(fn, init)
        from gt4py_tpu.next.type_deduction import deduce

        info = deduce(fn, kind="scan_operator")
        return functools.wraps(fn)(ScanOperator(fn, axis, forward, init, backend, info))

    return wrap(definition) if definition is not None else wrap


def _validate_scan_signature(fn: Callable, init: Any) -> None:
    """Decoration-time scan checks (reference foast_passes type
    deduction: carry/return/init agreement, at least one argument)."""
    import inspect

    from gt4py_tpu.next import errors
    from gt4py_tpu.next import type_system as ts

    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    if not params:
        raise errors.DSLTypeError(
            None,
            f"Scan operator '{fn.__name__}' must have at least one "
            "argument (the carry/state)",
        )
    globalns = getattr(fn, "__globals__", {})

    def spec_of(ann):
        if ann is inspect.Parameter.empty or ann is inspect.Signature.empty:
            return None
        try:
            return ts.from_annotation(ann, globalns)
        except Exception:
            return None

    def skeleton(t):
        """tuple structure + scalar kind — loose enough to permit what
        deduction cannot prove, strict on provable mismatches."""
        if isinstance(t, ts.TupleType):
            return tuple(skeleton(x) for x in t.types)
        if isinstance(t, ts.ScalarType):
            return t.dtype.kind
        if isinstance(t, ts.FieldType):
            return t.dtype.kind
        return "?"

    carry_t = spec_of(params[0].annotation)
    ret_t = spec_of(sig.return_annotation)
    if carry_t is not None and ret_t is not None:
        if skeleton(carry_t) != skeleton(ret_t):
            raise errors.DSLTypeError(
                None,
                f"Argument '{params[0].name}' to scan operator "
                f"'{fn.__name__}' must have same type as its return "
                f"(got {carry_t} vs {ret_t})",
            )
    if carry_t is not None and init is not None:
        try:
            init_t = ts.from_value(init)
        except Exception:
            init_t = None
        if init_t is not None and skeleton(init_t) != skeleton(carry_t):
            raise errors.DSLTypeError(
                None,
                f"Argument 'init' to scan operator '{fn.__name__}' must "
                f"have same type as '{params[0].name}' argument "
                f"(got {init_t} vs {carry_t})",
            )


@dataclasses.dataclass
class Program:
    """Declarative program: a function whose body calls field operators
    with ``out=`` arguments (reference decorator.py:226). Embedded: the
    body executes directly; operators handle their own jit."""

    definition: Callable
    backend: Optional[str] = "jax"
    bound_args: Optional[dict] = None

    def with_backend(self, backend: Optional[str]) -> "Program":
        return Program(self.definition, backend, self.bound_args)

    def with_bound_args(self, **bound: Any) -> "Program":
        """Bind keyword arguments ahead of time (reference
        ProgramWithBoundArgs, decorator.py:431). Unknown names are
        rejected at bind time (reference decorator.py raises for
        parameters not in the program signature)."""
        params = set(self._param_order())
        for name in bound:
            if name not in params:
                raise TypeError(
                    f"Keyword argument {name!r} is not a valid program parameter"
                )
        merged = {**(self.bound_args or {}), **bound}
        return Program(self.definition, self.backend, merged)

    def _param_order(self) -> list:
        """Parameter names in signature order (positional then kwonly)."""
        order = self.__dict__.get("_sig_params")
        if order is None:
            import inspect

            order = list(inspect.signature(self.definition).parameters)
            self.__dict__["_sig_params"] = order
        return order

    def _static_param_names(self) -> frozenset:
        """Parameters that must be baked per compiled variant (feed
        ``domain=`` bounds or ``if`` conditions); empty when the program
        is outside the PAST subset."""
        names = self.__dict__.get("_static_names")
        if names is None:
            from gt4py_tpu.next.past import exec_program, static_scalar_params

            exec_program(self)  # populates _past_cache
            cache = self.__dict__.get("_past_cache")
            ir = getattr(cache, "ir", None)
            names = (
                static_scalar_params(ir) if ir is not None else frozenset()
            )
            self.__dict__["_static_names"] = names
        return names

    def inspect(self, stage: str = "past") -> str:
        """The program's PAST-generated source after passes (reference
        past pretty printing; see FieldOperator.inspect for the
        expression-level stages)."""
        if stage != "past":
            raise ValueError(f"Unknown stage {stage!r} (expected past)")
        from gt4py_tpu.next.past import past_source

        return past_source(self)

    def __call__(self, *args, offset_provider: Optional[dict] = None, **kwargs):
        if self.bound_args:
            overlap = set(self.bound_args) & set(kwargs)
            if overlap:
                raise TypeError(
                    f"Arguments {sorted(overlap)} are already bound on this program"
                )
            kwargs = {**self.bound_args, **kwargs}
        from gt4py_tpu.next.backend import backend_kind

        kind = backend_kind(self.backend)
        fields = _collect_fields(args) + _collect_fields(kwargs)
        jit_ok = (
            kind == "jax"
            and fields
            and all(_xp_of(f) is not np for f in fields)
            and not _under_trace(args, kwargs)
        )
        # Scalars that feed ``domain=`` bounds or ``if`` conditions must
        # stay concrete under the whole-program jit (domain bounds are
        # XLA shapes): bake them per compiled variant, keyed by value
        # (reference otf/arguments.py static-arg descriptors).
        static_items: tuple = ()
        if jit_ok:
            static_names = self._static_param_names()
            if static_names:
                sigmap = self._param_order()
                picked = {}
                for name in static_names:
                    i = sigmap.index(name) if name in sigmap else -1
                    if 0 <= i < len(args):
                        v = args[i]
                    elif name in kwargs:
                        v = kwargs[name]
                    else:
                        continue
                    try:
                        v = v.item() if hasattr(v, "item") else v
                        hash(v)
                    except Exception:
                        # untraceable AND unbakeable (e.g. an abstract
                        # value) -> the eager path below stays correct
                        jit_ok = False
                        break
                    picked[name] = v
                static_items = tuple(sorted(picked.items()))
        if jit_ok:
            # Whole-program jit (reference Backend.compile on PAST): ONE
            # XLA dispatch for the full operator pipeline. Operator calls
            # inside the trace bypass their pools (_under_trace) and
            # mutate the traced Field copies; their final arrays are
            # harvested as the jit outputs and rebound to the originals.
            import jax

            from gt4py_tpu.next.otf import _provider_fingerprint

            cache = self.__dict__.setdefault("_exec_cache", {})
            pkey = (
                tuple(
                    sorted(
                        (k, _provider_fingerprint(v))
                        for k, v in (offset_provider or {}).items()
                    )
                )
                if offset_provider
                else None,
                static_items,
            )
            fn = cache.get(pkey)
            if fn is None:
                from gt4py_tpu.next.past import exec_program

                provider = offset_provider
                definition = exec_program(self)
                sigmap = self._param_order()
                pos = {n: sigmap.index(n) for n, _ in static_items}

                def fn(a, kw):
                    a = list(a)
                    kw = dict(kw)
                    for name, v in static_items:
                        i = pos[name]
                        if i < len(a):
                            a[i] = v
                        elif name in kw:
                            kw[name] = v
                    with offset_provider_context(provider):
                        definition(*a, **kw)
                    return tuple(
                        f.ndarray for f in _collect_fields(a) + _collect_fields(kw)
                    )

                fn = jax.jit(fn)
                cache[pkey] = fn
            call_args, call_kwargs = args, kwargs
            if static_items:
                # Baked statics need not cross the host->device boundary:
                # blank their leaves (None is an empty pytree node, so
                # nothing is transferred or traced); fn substitutes the
                # baked values at the same positions.
                sigmap = self._param_order()
                call_args = list(args)
                call_kwargs = dict(kwargs)
                for name, _ in static_items:
                    i = sigmap.index(name)
                    if i < len(call_args):
                        call_args[i] = None
                    elif name in call_kwargs:
                        call_kwargs[name] = None
                call_args = tuple(call_args)
            new_arrays = fn(call_args, call_kwargs)
            for f, arr in zip(fields, new_arrays):
                f.ndarray = arr
            return
        from gt4py_tpu.next.past import exec_program

        with offset_provider_context(offset_provider):
            exec_program(self)(*args, **kwargs)

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_exec_cache", None)  # jitted executables do not pickle
        state.pop("_past_cache", None)  # generated functions do not pickle
        return state


def program(definition: Optional[Callable] = None, *, backend: str | None = "jax"):
    from gt4py_tpu.next.frontend_validation import validate_definition

    def wrap(fn):
        validate_definition(fn, kind="program")
        # Decoration-time PAST compile: program type errors (bad operator
        # arguments, mismatched out= fields) surface here, before any call
        # (reference past_passes type deduction). The result is discarded —
        # exec_program re-compiles lazily so closure cells filled after
        # decoration are honored.
        from gt4py_tpu.next.past import compile_to_python

        compile_to_python(fn)
        return functools.wraps(fn)(Program(fn, backend))

    return wrap(definition) if definition is not None else wrap
