"""``repro_torch.obs`` — serving-wide observability (see docs/OBSERVABILITY.md).

Three stdlib-only pieces, copied from the JAX package's ``repro.obs``
(nothing here imports torch or touches a device):

* ``obs.trace``   — ``SpanTracer``: nested spans on a bounded ring with
  Chrome-trace-event export, plus ``attribute_steps`` (the per-step
  host-vs-device wall-time split behind ``engine.attribution()``);
* ``obs.metrics`` — ``MetricsRegistry``: counters / gauges /
  fixed-bucket histograms with Prometheus text exposition and a JSON
  snapshot; ``MetricsDict`` keeps the engine's historical metrics-dict
  idiom backed by the registry;
* ``obs.http``    — ``start_obs_server``: ``/metrics`` + ``/health``
  (+ ``/trace``) on a daemon-threaded stdlib HTTP server.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsDict,
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, Span, SpanTracer,
                                   attribute_steps, validate_chrome_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsDict",
           "MetricsRegistry", "NULL_TRACER", "Span", "SpanTracer",
           "attribute_steps", "validate_chrome_trace"]
