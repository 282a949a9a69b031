"""Runtime stencil callable.

Counterpart of the reference's ``StencilObject``
(/root/reference/src/gt4py/cartesian/stencil_object.py:146): argument
binding, origin normalization (:489), max-domain computation (:288),
validation (:334), the domain/origin call cache (:568-582) and ``freeze()``
(:596). The execution step dispatches to a JAX backend instead of a
generated extension module; written fields are rebound on the passed
storages (JAX arrays are immutable, see storage/storage.py).
"""

from __future__ import annotations

import collections.abc
import inspect
import sys
import time
from typing import Any, Optional

import numpy as np

from gt4py_tpu.cartesian.definitions import AccessKind, FieldInfo
from gt4py_tpu.storage.storage import Storage


class ArgsInfo:
    """Per-argument call info; ``array`` reads a storage's array lazily."""

    __slots__ = ("original", "origin", "dimensions")

    def __init__(self, original, origin, dimensions):
        self.original = original
        self.origin = origin
        self.dimensions = dimensions

    @property
    def array(self):
        if isinstance(self.original, Storage):
            return self.original.array
        return self.original

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.original.shape)

    @property
    def dtype(self):
        return np.dtype(self.original.dtype)


def _extract_array(value: Any):
    if isinstance(value, Storage):
        return value.array
    return value


def _arg_info(value: Any) -> ArgsInfo:
    return ArgsInfo(
        original=value,
        origin=getattr(value, "__gt_origin__", None),
        dimensions=getattr(value, "__gt_dims__", None),
    )


def _spec_key(origin) -> Any:
    """Hashable canonical form of a user 'origin' argument (dict / iterable
    / int / None) for the validation cache."""
    if origin is None or isinstance(origin, int):
        return origin
    if isinstance(origin, dict):
        return tuple(sorted((str(k), tuple(v)) for k, v in origin.items()))
    if isinstance(origin, collections.abc.Iterable):
        return tuple(int(i) for i in origin)
    raise TypeError(f"unhashable origin spec {origin!r}")


class StencilObject:
    """Callable stencil implementation (one per definition+backend+options)."""

    def __init__(self, analyzed, backend, options: dict, definition):
        self._analyzed = analyzed
        self._backend = backend
        self.options = options
        self.definition_func = definition
        self.backend = backend.name
        self.field_info: dict[str, FieldInfo] = analyzed.field_infos
        self.parameter_info = analyzed.parameter_infos
        self.domain_info = analyzed.domain_info
        self._signature = inspect.signature(definition)
        # Fast-binder tables: inspect.Signature.bind costs ~15 us per call;
        # plain stencil signatures (positional-or-keyword / keyword-only,
        # no *args/**kwargs) bind with a zip + dict update instead.
        _params = self._signature.parameters
        self._arg_names = tuple(_params)
        self._arg_name_set = frozenset(_params)
        self._arg_defaults = {
            n: p.default
            for n, p in _params.items()
            if p.default is not inspect.Parameter.empty
        }
        self._simple_signature = all(
            p.kind
            in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY,
            )
            for p in _params.values()
        )
        # Keyword-only params must never be filled positionally — the fast
        # binder only accepts up to this many positional args, matching
        # Signature.bind's "too many positional arguments" behavior.
        self._max_positional = sum(
            1
            for p in _params.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD
        )
        self.__doc__ = analyzed.stencil.docstring
        import threading

        self._compile_lock = threading.Lock()
        self._compile_threads: list = []
        self._compile_errors: list = []
        #: (origin-spec, domain, field shapes/dtypes/origins, param types)
        #: -> (normalized origins, resolved domain); see _call_run
        self._validation_cache: dict = {}

    @property
    def name(self) -> str:
        return self._analyzed.name

    def pretty_ir(self) -> str:
        """Canonical text form of the analyzed GTIR (cartesian/gtir_pretty.py
        — the reference's pretty-printer role: IR snapshots for debugging,
        golden tests, bug reports). Round-trips through
        ``gtir_pretty.parse``."""
        from gt4py_tpu.cartesian.gtir_pretty import pretty

        return pretty(self._analyzed.stencil)

    # -- origin/domain machinery (parity with reference :263-530) -----------

    @staticmethod
    def _make_origin_dict(origin) -> dict[str, tuple[int, ...]]:
        if isinstance(origin, dict):
            return {str(k): tuple(v) for k, v in origin.items()}
        if origin is None:
            return {}
        if isinstance(origin, collections.abc.Iterable):
            return {"_all_": tuple(int(i) for i in origin)}
        if isinstance(origin, int):
            return {"_all_": (0, 0, int(origin))}
        raise ValueError(f"Invalid 'origin' value ({origin})")

    def _normalize_origins(
        self, arg_infos: dict[str, Optional[ArgsInfo]], origin
    ) -> dict[str, tuple[int, ...]]:
        origin = self._make_origin_dict(origin)
        all_origin = origin.get("_all_", None)
        for name, field_info in self.field_info.items():
            field_origin = origin.get(name, None)
            if field_origin is not None:
                if len(field_origin) == field_info.domain_ndim:
                    origin[name] = (*field_origin, *((0,) * len(field_info.data_dims)))
                elif len(field_origin) != field_info.ndim:
                    raise ValueError(
                        f"Invalid origin specification ({field_origin}) for '{name}' field."
                    )
            elif all_origin is not None:
                masked = tuple(
                    o for o, m in zip(all_origin, field_info.domain_mask) if m
                )
                origin[name] = (*masked, *((0,) * len(field_info.data_dims)))
            elif (info := arg_infos.get(name)) is not None and info.origin is not None:
                origin[name] = tuple(info.origin)
            else:
                origin[name] = (0,) * field_info.ndim
        origin.pop("_all_", None)
        return origin

    def _get_max_domain(
        self,
        arg_infos: dict[str, Optional[ArgsInfo]],
        origin: dict[str, tuple[int, ...]],
        *,
        squeeze: bool = True,
    ) -> tuple[int, ...]:
        max_size = sys.maxsize
        max_domain = [max_size] * 3
        for name, field_info in self.field_info.items():
            if field_info.access == AccessKind.NONE or not field_info.axes:
                continue
            info = arg_infos.get(name)
            if info is None:
                raise ValueError(f"Missing value for '{name}' field.")
            mask = field_info.domain_mask
            upper = tuple(u for u, m in zip(field_info.boundary.upper, mask) if m)
            field_origin = origin[name]
            if len(info.shape) < field_info.domain_ndim:
                # Wrong-rank arrays get the dedicated ndim diagnostic in
                # _validate_args — don't crash the max-domain scan first.
                raise ValueError(
                    f"Storage for '{name}' has {len(info.shape)} dimensions but "
                    f"the API signature expects "
                    f"{field_info.domain_ndim + len(field_info.data_dims)}"
                )
            pos = 0
            for ax_idx, present in enumerate(mask):
                if not present:
                    continue
                size = info.shape[pos] - field_origin[pos] - upper[pos]
                max_domain[ax_idx] = min(max_domain[ax_idx], size)
                pos += 1
        if squeeze:
            return tuple(d if d != max_size else 1 for d in max_domain)
        return tuple(max_domain)

    def _validate_args(self, arg_infos, param_args, domain, origin) -> None:
        if len(domain) != 3:
            raise ValueError(f"Invalid 'domain' value '{domain}'")
        if not all(d > 0 for d in domain):
            raise ValueError(f"Compute domain contains zero sizes '{domain}')")
        max_domain = self._get_max_domain(arg_infos, origin, squeeze=False)
        if not all(d <= m for d, m in zip(domain, max_domain)):
            raise ValueError(
                f"Compute domain too large for stencil {self.name}: domain {domain} "
                f"exceeds max domain {tuple(max_domain)} given the passed fields/origins."
            )
        if domain[2] < self.domain_info.min_sequential_axis_size:
            raise ValueError(
                f"Compute domain too small. Sequential axis is {domain[2]}, but must "
                f"be at least {self.domain_info.min_sequential_axis_size}."
            )

        for name, field_info in self.field_info.items():
            if field_info.access == AccessKind.NONE:
                continue
            info = arg_infos.get(name)
            if info is None:
                raise ValueError(f"Missing value for '{name}' field.")
            array = info  # shape/dtype metadata; no array materialization
            if np.dtype(array.dtype) != field_info.dtype:
                raise TypeError(
                    f"The dtype of field '{name}' is '{array.dtype}' instead of "
                    f"'{field_info.dtype}'"
                )
            expected_ndim = field_info.domain_ndim + len(field_info.data_dims)
            if len(array.shape) != expected_ndim:
                raise ValueError(
                    f"Storage for '{name}' has {len(array.shape)} dimensions but the API "
                    f"signature expects {expected_ndim}"
                )
            if field_info.data_dims:
                if tuple(array.shape[field_info.domain_ndim:]) != field_info.data_dims:
                    raise ValueError(
                        f"Field '{name}' expects data dimensions {field_info.data_dims} "
                        f"but got {tuple(array.shape[field_info.domain_ndim:])}"
                    )
            mask = field_info.domain_mask
            lower = tuple(b for b, m in zip(field_info.boundary.lower, mask) if m)
            upper = tuple(b for b, m in zip(field_info.boundary.upper, mask) if m)
            spatial_domain = tuple(d for d, m in zip(domain, mask) if m)
            field_origin = origin[name][: field_info.domain_ndim]
            if any(o < lo for o, lo in zip(field_origin, lower)):
                raise ValueError(
                    f"Origin for field {name} too small. Must be at least {lower}, "
                    f"is {field_origin}"
                )
            min_shape = tuple(
                lb + d + ub for lb, d, ub in zip(lower, spatial_domain, upper)
            )
            spatial_shape = array.shape[: field_info.domain_ndim]
            if any(s < m for s, m in zip(spatial_shape, min_shape)):
                raise ValueError(
                    f"Shape of field {name} is {tuple(array.shape)} but must be at "
                    f"least {min_shape} for given domain and origin."
                )

        for name, parameter_info in self.parameter_info.items():
            if parameter_info.access == AccessKind.NONE:
                continue
            if name not in param_args or param_args[name] is None:
                raise ValueError(f"Missing value for '{name}' parameter.")
            value = param_args[name]
            if np.dtype(type(value)) != parameter_info.dtype:
                raise TypeError(
                    f"The type of parameter '{name}' is '{type(value)}' instead of "
                    f"'{parameter_info.dtype}'"
                )

    # -- call path ----------------------------------------------------------

    def __call__(
        self,
        *args,
        domain=None,
        origin=None,
        validate_args: bool = True,
        exec_info: Optional[dict] = None,
        **kwargs,
    ) -> None:
        if exec_info is not None:
            exec_info["call_start_time"] = time.perf_counter()
        field_args, param_args = self._bind_arguments(args, kwargs)
        self._call_run(
            field_args,
            param_args,
            domain,
            origin,
            validate_args=validate_args,
            exec_info=exec_info,
        )

    def _bind_arguments(self, args, kwargs):
        """Bind call args to (field_args, param_args) with the fast binder
        when the signature allows it (Signature.bind costs ~15 us)."""
        arguments = None
        if self._simple_signature and len(args) <= self._max_positional:
            arguments = dict(zip(self._arg_names, args))
            for k, v in kwargs.items():
                if k in arguments or k not in self._arg_name_set:
                    arguments = None  # duplicate / unknown: slow path raises
                    break
                arguments[k] = v
            if arguments is not None:
                for k, v in self._arg_defaults.items():
                    arguments.setdefault(k, v)
                if len(arguments) != len(self._arg_names):
                    arguments = None  # missing required: slow path raises
        if arguments is None:
            bound = self._signature.bind(*args, **kwargs)
            bound.apply_defaults()
            arguments = bound.arguments
        field_args = {name: arguments.get(name) for name in self.field_info}
        param_args = {
            name: arguments.get(name) for name in self.parameter_info
        }
        return field_args, param_args

    def _call_run(
        self,
        field_args,
        param_args,
        domain,
        origin,
        *,
        validate_args: bool = True,
        exec_info: Optional[dict] = None,
    ) -> None:
        if exec_info is not None:
            exec_info["call_run_start_time"] = time.perf_counter()

        arg_infos = {
            name: (_arg_info(v) if v is not None else None)
            for name, v in field_args.items()
        }
        used_infos = {
            n: i
            for n, i in arg_infos.items()
            if self.field_info[n].access != AccessKind.NONE and i is not None
        }

        # Validation caching (reference stencil_object.py:568-582): repeat
        # calls with the same shapes/dtypes/origins/domain skip origin
        # normalization, max-domain scanning, and the full argument
        # validation — the warm validated path then costs about the same
        # as an explicit freeze(). The key is identity-free (pure shape/
        # dtype/origin tuples), so any same-shaped arrays hit.
        try:
            key = (
                _spec_key(origin),
                None if domain is None else tuple(int(d) for d in domain),
                tuple(
                    (n, i.shape, i.dtype, i.origin)
                    for n, i in sorted(used_infos.items())
                ),
                tuple(
                    (n, type(v).__name__)
                    for n, v in sorted(param_args.items())
                    if v is not None
                ),
            )
        except TypeError:
            key = None
        cached = self._validation_cache.get(key) if key is not None else None
        if cached is not None:
            origins, domain_t = cached
        else:
            origins = self._normalize_origins(used_infos, origin)
            domain_t = (
                self._get_max_domain(used_infos, origins)
                if domain is None
                else domain
            )
            domain_t = tuple(int(d) for d in domain_t)
            if validate_args:
                self._validate_args(used_infos, param_args, domain_t, origins)
                if key is not None:
                    if len(self._validation_cache) >= 64:
                        self._validation_cache.clear()
                    self._validation_cache[key] = (origins, domain_t)

        self._run_backend(
            used_infos, param_args, domain_t, origins, exec_info, cache_key=key
        )

        if exec_info is not None:
            exec_info["call_run_end_time"] = time.perf_counter()

    def _run_backend(
        self, used_infos, param_args, domain, origins, exec_info, cache_key=None
    ) -> None:
        scalars = {}
        for name, pinfo in self.parameter_info.items():
            if pinfo.access == AccessKind.NONE:
                continue
            value = param_args.get(name)
            scalars[name] = np.asarray(value, dtype=pinfo.dtype)[()]

        origins3: dict[str, tuple[int, int, int]] = {}
        for name, info in used_infos.items():
            finfo = self.field_info[name]
            mask = finfo.domain_mask
            o = list(origins[name][: finfo.domain_ndim])
            full = [0, 0, 0]
            pos = 0
            for ax in range(3):
                if mask[ax]:
                    full[ax] = o[pos]
                    pos += 1
            origins3[name] = tuple(full)

        from gt4py_tpu.instrumentation import MetricsCollector, metrics_level
        from gt4py_tpu.instrumentation.hooks import stencil_call

        if exec_info is not None:
            exec_info["run_start_time"] = time.perf_counter()
        # Hot path: with no registered call hooks and metrics off (the
        # defaults), skip both context managers entirely (~8 us/call).
        if not stencil_call.factories and not metrics_level():
            results = self._backend.run_from_infos(
                used_infos, scalars, domain, origins3, cache_key=cache_key
            )
        else:
            with stencil_call.wrap(self), MetricsCollector(self.name, "compute"):
                results = self._backend.run_from_infos(
                    used_infos, scalars, domain, origins3, cache_key=cache_key
                )
        if exec_info is not None:
            exec_info["run_end_time"] = time.perf_counter()
            kernel = getattr(self._backend, "last_kernel", None)
            if kernel is not None:
                exec_info["kernel"] = kernel

        self._write_back(results, used_infos)

    def _write_back(self, results, used_infos) -> None:
        """Rebind written results on the passed objects."""
        for name, new_array in results.items():
            info = used_infos[name]
            original = info.original
            if isinstance(original, Storage):
                import jax.numpy as jnp

                original.array = (
                    jnp.asarray(new_array)
                    if isinstance(new_array, np.ndarray)
                    else new_array
                )
            elif isinstance(original, np.ndarray):
                np.copyto(original, np.asarray(new_array))
            else:
                raise TypeError(
                    f"Field '{name}' is written by stencil '{self.name}' but was "
                    f"passed as an immutable {type(original).__name__}; pass a "
                    "gt4py_tpu.storage Storage (or a NumPy array) instead."
                )

    def run(self, *, _domain_, _origin_, exec_info=None, **kwargs) -> None:
        """Low-level entry point (reference generated-module contract,
        backend/python_common.py:34-37): no validation, explicit domain and
        per-field origins."""
        field_args = {name: kwargs.get(name) for name in self.field_info}
        param_args = {name: kwargs.get(name) for name in self.parameter_info}
        self._call_run(
            field_args,
            param_args,
            _domain_,
            _origin_,
            validate_args=False,
            exec_info=exec_info,
        )

    def freeze(self, *, origin, domain) -> "FrozenStencil":
        return FrozenStencil(self, origin, domain)

    def chain(
        self,
        n_steps: int,
        *args,
        swap: Optional[dict] = None,
        domain=None,
        origin=None,
        validate_args: bool = True,
        exec_info: Optional[dict] = None,
        **kwargs,
    ) -> None:
        """Run ``n_steps`` applications as ONE on-device executable with
        buffer rotation between steps — the time-stepping loop a model
        driver would otherwise write in Python, without the per-call
        dispatch overhead (the loop is a compiled ``fori_loop``; PERF.md
        compares a call with a chain step).

        ``swap`` maps each field role to the role whose buffer serves it
        in the NEXT step: ``swap={"in_field": "out_field", "out_field":
        "in_field"}`` is the classic ping-pong. It must be a permutation
        (every name appears exactly once as key and once as value);
        swapped roles must agree in shape, dtype, and origin. Fields
        outside ``swap`` keep their buffer (read-only coefficients).

        Equivalent semantics (the correctness oracle)::

            fields = {...}
            for _ in range(n_steps):
                stencil(**fields, domain=domain, origin=origin)
                fields = {r: fields[swap.get(r, r)] for r in fields}

        After the chain, every passed storage holds the final content of
        its role.
        Scalar parameters are fixed across steps. Reference analog:
        ``FrozenStencil`` (stencil_object.py:95) removes validation from
        each call; ``chain`` removes the calls themselves."""
        if exec_info is not None:
            exec_info["call_start_time"] = time.perf_counter()
        n_steps = int(n_steps)
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        swap = dict(swap or {})
        field_args, param_args = self._bind_arguments(args, kwargs)

        arg_infos = {
            name: (_arg_info(v) if v is not None else None)
            for name, v in field_args.items()
        }
        used_infos = {
            n: i
            for n, i in arg_infos.items()
            if self.field_info[n].access != AccessKind.NONE and i is not None
        }
        origins = self._normalize_origins(used_infos, origin)
        domain_t = (
            self._get_max_domain(used_infos, origins)
            if domain is None
            else domain
        )
        domain_t = tuple(int(d) for d in domain_t)
        if validate_args:
            self._validate_args(used_infos, param_args, domain_t, origins)

        # swap must be a permutation over known, compatible roles.
        names = set(used_infos)
        unknown = (set(swap) | set(swap.values())) - names
        if unknown:
            raise ValueError(
                f"swap names {sorted(unknown)} are not fields of stencil "
                f"'{self.name}' (fields: {sorted(names)})"
            )
        if set(swap.keys()) != set(swap.values()) or len(
            set(swap.values())
        ) != len(swap):
            raise ValueError(
                f"swap must be a permutation (each role exactly once as "
                f"key and as value), got {swap!r}"
            )
        for dst, src in swap.items():
            a, b = used_infos[dst], used_infos[src]
            fa, fb = self.field_info[dst], self.field_info[src]
            if (
                a.shape != b.shape
                or a.dtype != b.dtype
                or origins[dst] != origins[src]
                or fa.axes != fb.axes
                or fa.data_dims != fb.data_dims
            ):
                raise ValueError(
                    f"swapped roles '{dst}' <- '{src}' must agree in shape/"
                    f"dtype/origin/axes: {a.shape}/{a.dtype}/{origins[dst]} "
                    f"vs {b.shape}/{b.dtype}/{origins[src]}"
                )

        scalars = {}
        for name, pinfo in self.parameter_info.items():
            if pinfo.access == AccessKind.NONE:
                continue
            scalars[name] = np.asarray(param_args.get(name), dtype=pinfo.dtype)[()]
        origins3: dict[str, tuple[int, int, int]] = {}
        for name, info in used_infos.items():
            finfo = self.field_info[name]
            mask = finfo.domain_mask
            o = list(origins[name][: finfo.domain_ndim])
            full = [0, 0, 0]
            pos = 0
            for ax in range(3):
                if mask[ax]:
                    full[ax] = o[pos]
                    pos += 1
            origins3[name] = tuple(full)

        if n_steps == 0:
            return
        if exec_info is not None:
            exec_info["run_start_time"] = time.perf_counter()
        results = self._backend.run_chained_from_infos(
            used_infos, scalars, domain_t, origins3, n_steps, swap
        )
        if exec_info is not None:
            exec_info["run_end_time"] = time.perf_counter()
            kernel = getattr(self._backend, "last_kernel", None)
            if kernel is not None:
                exec_info["kernel"] = kernel
        self._write_back(results, used_infos)
        if exec_info is not None:
            exec_info["call_run_end_time"] = time.perf_counter()

    def precompile(self, *, domain, origin=None, wait: bool = False) -> None:
        """Warm the kernel path for a concrete (domain, origin) in a
        background thread: a full build + compile, exercised by one call on
        zero-filled placeholder fields so the exact executable the first
        real call dispatches is already cached.

        Reference analog: asynchronous worker builds
        (otf/compilation_tasks.py:136) and the next-side AOT
        ``compile()``/``wait_for_compilation()`` pair. Exceptions are
        deferred to :meth:`wait_for_compilation`; a failed warm-up never
        poisons the stencil (the real call rebuilds on its own)."""
        import threading

        domain = tuple(int(d) for d in domain)
        field_args: dict[str, Any] = {}
        for name, fi in self.field_info.items():
            if fi.access == AccessKind.NONE:
                continue
            if not fi.axes:  # GlobalTable
                field_args[name] = np.zeros(tuple(fi.data_dims), fi.dtype)
                continue
            spatial = [
                lo + d + hi
                for lo, d, hi, m in zip(
                    fi.boundary.lower, domain, fi.boundary.upper, fi.domain_mask
                )
                if m
            ]
            field_args[name] = np.zeros(
                tuple(spatial) + tuple(fi.data_dims), fi.dtype
            )
        if origin is None:
            origin = {
                name: tuple(
                    b for b, m in zip(fi.boundary.lower, fi.domain_mask) if m
                )
                for name, fi in self.field_info.items()
                if fi.axes and fi.access != AccessKind.NONE
            }
        param_args = {
            name: pi.dtype.type(1)
            for name, pi in self.parameter_info.items()
            if pi.access != AccessKind.NONE
        }

        def work():
            try:
                self._call_run(
                    field_args, param_args, domain, origin, validate_args=False
                )
            except Exception as e:  # surfaced by wait_for_compilation
                with self._compile_lock:
                    self._compile_errors.append(e)

        t = threading.Thread(target=work, daemon=True, name=f"precompile-{self.name}")
        with self._compile_lock:
            # start under the lock: every thread in the list is started,
            # so wait_for_compilation can join() unconditionally
            t.start()
            self._compile_threads.append(t)
        if wait:
            self.wait_for_compilation()

    def wait_for_compilation(self) -> None:
        """Block until every :meth:`precompile` worker started so far has
        finished (including ones started while joining); re-raise the
        first deferred build error (if any)."""
        while True:
            with self._compile_lock:
                pending = [t for t in self._compile_threads if t.is_alive()]
                if not pending:
                    self._compile_threads = []
                    errors, self._compile_errors = self._compile_errors, []
                    break
            for t in pending:
                t.join()
        if errors:
            raise errors[0]

    def __repr__(self) -> str:
        return f"<StencilObject {self.name} backend={self.backend}>"


class FrozenStencil:
    """Stencil with pre-resolved origin/domain (reference
    stencil_object.py:95): origins are normalized ONCE at freeze time and
    the call path goes straight to the backend — no signature binding, no
    per-call validation/normalization, no instrumentation hooks. This is
    the hot-loop entry point for model drivers calling the same stencil
    with fixed geometry every timestep."""

    __slots__ = (
        "stencil_object", "origin", "domain",
        "_origins3", "_used_fields", "_scalar_info",
    )

    def __init__(self, stencil_object: StencilObject, origin, domain):
        so = stencil_object
        self.stencil_object = so
        self.domain = tuple(int(d) for d in domain)
        self.origin = so._normalize_origins({}, origin)

        # Pre-resolve per-field full (i, j, k) origins (the mask expansion
        # _run_backend does per call).
        self._origins3: dict[str, tuple[int, int, int]] = {}
        self._used_fields: list[str] = []
        for name, finfo in so.field_info.items():
            if finfo.access == AccessKind.NONE:
                continue
            self._used_fields.append(name)
            mask = finfo.domain_mask
            o = list(self.origin[name][: finfo.domain_ndim])
            full = [0, 0, 0]
            pos = 0
            for ax in range(3):
                if mask[ax]:
                    full[ax] = o[pos]
                    pos += 1
            self._origins3[name] = tuple(full)
        self._scalar_info = [
            (name, pinfo.dtype)
            for name, pinfo in so.parameter_info.items()
            if pinfo.access != AccessKind.NONE
        ]

    def __call__(self, **kwargs) -> None:
        so = self.stencil_object
        used_infos = {n: _arg_info(kwargs[n]) for n in self._used_fields}
        scalars = {
            n: np.asarray(kwargs[n], dtype=dt)[()] for n, dt in self._scalar_info
        }
        results = so._backend.run_from_infos(
            used_infos, scalars, self.domain, self._origins3
        )
        so._write_back(results, used_infos)
