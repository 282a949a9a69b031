from gt4py_tpu.instrumentation.metrics import (  # noqa: F401
    Metric,
    MetricCollectionLevel,
    MetricsCollector,
    collect_metrics,
    dump_metrics_json,
    dump_metrics_table,
    metrics_level,
)
from gt4py_tpu.instrumentation.hooks import (  # noqa: F401
    ContextHook,
    EventHook,
    register_context_hook,
    register_event_hook,
)
from gt4py_tpu.instrumentation.profiler import gpu_trace, named_scope  # noqa: F401
