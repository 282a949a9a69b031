"""Build orchestration object with a build-data cache.

Counterpart of the reference's ``StencilBuilder``
(/root/reference/src/gt4py/cartesian/stencil_builder.py:27 — ``build():71``,
``gtir_pipeline:253``, chainable ``with_*`` setters, per-build
``backend_data`` store): one object owns the whole definition→executable
thread — frontend parse + analysis pipeline (cached per builder), backend
instantiation, StencilObject assembly — and records build phases in a
crash-consistent persistent *build-data* record (FileCache keyed by the
stencil fingerprint), so tooling can ask "what was built, when, through
which backend" without rebuilding.

``loader.load_stencil`` is a thin veneer over this class; use the builder
directly for staged builds (syntax-check only, inspect the analyzed IR,
swap the backend and rebuild)."""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from gt4py_tpu.cartesian.caching import stencil_fingerprint


_MEMO: dict[str, Any] = {}  # fingerprint -> StencilObject (in-process)


def _build_data_cache():
    import os

    from gt4py_tpu import config
    from gt4py_tpu.core.filecache import FileCache

    return FileCache(os.path.join(config.cache_dir(), "build_data"))


class StencilBuilder:
    """Thread a stencil definition through frontend → analysis → backend.

    Chainable configuration (reference stencil_builder.py builder idiom)::

        obj = (
            StencilBuilder(defn)
            .with_backend("gpu")
            .with_externals({"K": 3})
            .build()
        )
    """

    def __init__(
        self,
        definition: Callable,
        *,
        backend: Optional[str] = None,
        options: Optional[dict] = None,
    ):
        self.definition = definition
        self.options: dict = dict(options or {})
        if backend is not None:
            self.options["backend"] = backend
        self.options.setdefault("externals", {})
        self.options.setdefault("dtypes", {})
        # Per-build artifact store backends may stash data in (reference
        # builder.backend_data / with_backend_data).
        self.backend_data: dict = {}
        self._analyzed = None
        self._backend_obj = None
        self._fingerprint: Optional[str] = None

    # -- chainable setters -------------------------------------------------

    def _dirty(self) -> "StencilBuilder":
        self._analyzed = None
        self._backend_obj = None
        self._fingerprint = None
        return self

    def with_backend(self, backend: str) -> "StencilBuilder":
        self.options["backend"] = backend
        return self._dirty()

    def with_externals(self, externals: dict) -> "StencilBuilder":
        self.options["externals"] = {**self.options.get("externals", {}), **externals}
        return self._dirty()

    def with_options(self, **options: Any) -> "StencilBuilder":
        self.options.update(options)
        return self._dirty()

    def with_backend_data(self, **data: Any) -> "StencilBuilder":
        self.backend_data.update(data)
        return self

    # -- cached pipeline stages (reference gtir_pipeline:253) --------------

    @property
    def stencil_id(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = stencil_fingerprint(self.definition, self.options)
        return self._fingerprint

    @property
    def gtir(self):
        """The analyzed stencil (GTIR + extents/access/dtype analyses);
        parsed once per builder configuration."""
        if self._analyzed is None:
            from gt4py_tpu.cartesian.passes import analyze

            self._analyzed = analyze(self.definition, self.options)
        return self._analyzed

    @property
    def backend_cls(self):
        from gt4py_tpu.cartesian import backend as backend_module

        return backend_module.from_name(self.options["backend"])

    @property
    def backend_obj(self):
        if self._backend_obj is None:
            self._backend_obj = self.backend_cls(self.gtir, self.options)
        return self._backend_obj

    # -- build-data record (reference build_data / backend caching) --------

    def build_data(self) -> dict:
        """The persisted record of the last completed build of this
        fingerprint ({} if never built or the build crashed mid-way —
        FileCache writes are atomic, so a torn record is impossible)."""
        try:
            return _build_data_cache()[self.stencil_id]
        except KeyError:
            return {}

    def _record_build(self, *, parse_time: float, module_time: float) -> None:
        record = {
            "status": "done",
            "name": getattr(self.definition, "__name__", "<stencil>"),
            "backend": self.options.get("backend"),
            "fingerprint": self.stencil_id,
            "parse_time": parse_time,
            "module_time": module_time,
            "built_at": time.time(),
            # Backend-contributed artifacts (``with_backend_data``).
            "backend_data": {
                k: v
                for k, v in self.backend_data.items()
                if isinstance(v, (str, int, float, bool, tuple, list, dict, type(None)))
            },
        }
        try:
            _build_data_cache()[self.stencil_id] = record
        except Exception:
            pass  # cache dir unwritable: build-data is advisory

    # -- build (reference build():71) --------------------------------------

    def check_syntax(self) -> None:
        """Run frontend + analysis only (reference LazyStencil.check_syntax
        path through the builder)."""
        self.gtir

    def build(self):
        """Load-or-build the StencilObject (reference build():71:
        backend.load() cache hit, else backend.generate())."""
        from gt4py_tpu.cartesian.stencil_object import StencilObject

        build_info = self.options.get("build_info")
        start = time.perf_counter()

        if not self.options.get("rebuild") and self.stencil_id in _MEMO:
            cached = _MEMO[self.stencil_id]
            if build_info is not None:
                build_info["load_time"] = time.perf_counter() - start
            return cached

        if self.options.get("raise_if_not_cached") and not self.build_data():
            raise RuntimeError(
                f"Stencil '{getattr(self.definition, '__name__', '?')}' is not "
                "cached (raise_if_not_cached=True)"
            )

        analyzed = self.gtir
        parse_done = time.perf_counter()

        obj = StencilObject(analyzed, self.backend_obj, self.options, self.definition)
        module_done = time.perf_counter()

        if build_info is not None:
            build_info["parse_time"] = parse_done - start
            build_info["module_time"] = module_done - parse_done
            build_info["codegen_time"] = 0.0

        self._record_build(
            parse_time=parse_done - start, module_time=module_done - parse_done
        )
        _MEMO[self.stencil_id] = obj
        return obj
