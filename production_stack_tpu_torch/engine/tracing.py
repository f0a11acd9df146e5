"""Engine-side distributed tracing, a copy of
production_stack_tpu/engine/tracing.py: engine spans JOIN the router's
trace instead of ending at the proxy. The router injects a W3C
``traceparent`` into the backend request; the server extracts it and opens
a child SERVER span around the request's admission -> queue -> prefill ->
decode lifecycle.

OpenTelemetry is imported inside ``initialize_tracing`` only. Without the
``opentelemetry`` API every call here is a no-op and ``trace_id_hex()`` is
None; with the API alone trace context propagates; spans are recorded and
exported when the SDK and the OTLP exporter are installed too.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("engine.tracing")

_tracer = None
_propagator = None
_enabled = False


def initialize_tracing(endpoint: Optional[str], service_name: str = "tpu-engine",
                       secure: bool = False) -> bool:
    """Returns True when spans will actually be recorded and exported."""
    global _tracer, _propagator, _enabled
    try:
        from opentelemetry import trace
        from opentelemetry.trace.propagation.tracecontext import (
            TraceContextTextMapPropagator,
        )
    except ImportError:
        # no opentelemetry API: tracing is a no-op, the engine boots anyway
        if endpoint:
            logger.warning(
                "--otel-endpoint set but opentelemetry-api is not installed; "
                "tracing disabled"
            )
        _enabled = False
        return False

    _propagator = TraceContextTextMapPropagator()
    exporting = False
    if endpoint:
        try:
            from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                OTLPSpanExporter,
            )
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor

            provider = TracerProvider(
                resource=Resource.create({"service.name": service_name})
            )
            provider.add_span_processor(
                BatchSpanProcessor(
                    OTLPSpanExporter(endpoint=endpoint, insecure=not secure)
                )
            )
            trace.set_tracer_provider(provider)
            exporting = True
            logger.info("OTel tracing exporting to %s", endpoint)
        except ImportError:
            logger.warning(
                "--otel-endpoint set but opentelemetry-sdk/exporter not "
                "installed; running with W3C propagation only"
            )
    _tracer = trace.get_tracer("production_stack_tpu_torch.engine")
    _enabled = True
    return exporting


def is_enabled() -> bool:
    return _enabled


def extract_context(headers) -> Optional[object]:
    if not _enabled or _propagator is None:
        return None
    return _propagator.extract(carrier=dict(headers))


def inject_headers(headers: dict, context=None) -> dict:
    if _enabled and _propagator is not None:
        _propagator.inject(carrier=headers, context=context)
    return headers


def trace_id_hex(context=None) -> Optional[str]:
    """32-hex trace id of the current (or given) context, or None when
    tracing is off or there is no active trace: the flight recorder's
    cross-reference into the exported trace."""
    if not _enabled:
        return None
    from opentelemetry import trace

    span = trace.get_current_span(context)
    ctx = span.get_span_context()
    if not ctx.trace_id:
        return None
    return format(ctx.trace_id, "032x")


class request_span:
    """SERVER (or CLIENT) span context manager; no-op when tracing is off."""

    def __init__(self, name: str, context=None, kind: str = "server",
                 attributes: Optional[dict] = None):
        self.name = name
        self.context = context
        self.kind = kind
        self.attributes = attributes or {}
        self._cm = None
        self.span = None

    def __enter__(self):
        if not _enabled or _tracer is None:
            return None
        from opentelemetry.trace import SpanKind

        kind = SpanKind.SERVER if self.kind == "server" else SpanKind.CLIENT
        self._cm = _tracer.start_as_current_span(
            self.name, context=self.context, kind=kind,
            attributes=self.attributes,
        )
        self.span = self._cm.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self._cm is not None:
            return self._cm.__exit__(*exc)
        return False
