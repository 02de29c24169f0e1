"""Serving runtime of the port: samplers, request scheduling, the batched
speculative server (see server.py), the cascade's draft bank, telemetry and
its exporters."""
from repro_torch.serving.draft_bank import DraftBank, DraftLevel
from repro_torch.serving.exporters import JsonlSink, MetricsHTTPServer
from repro_torch.serving.sampler import sample_token
from repro_torch.serving.scheduler import Request, RequestScheduler, ServeLoop
from repro_torch.serving.server import BatchedSpecServer
from repro_torch.serving.telemetry import MetricsRegistry, StatsView, TraceRecorder

__all__ = [
    "sample_token", "Request", "RequestScheduler", "ServeLoop",
    "BatchedSpecServer", "DraftBank", "DraftLevel",
    "MetricsRegistry", "StatsView", "TraceRecorder",
    "JsonlSink", "MetricsHTTPServer",
]
