"""Request scheduling for the batched server, a copy of the reference's
``serving/scheduler.py``: FIFO admission into fixed batch slots with
continuous batching (a finished slot is refilled on the
next step boundary). ``ServeLoop`` is the admit/step/retire glue between a
``RequestScheduler`` and a ``BatchedSpecServer`` — examples, benchmarks and
tests all drive serving through it. Scheduling is orthogonal to the
server's proposal mode (``chain_fused`` / ``legacy`` / ``tree_fused``):
every mode exposes the same add_request/step/release slot contract.

Observability: the loop measures what only IT can
see — per-request TTFT/TPOT/ITL (token arrivals are logged as the loop
routes them, so pipelined sync batches are attributed at their real drain
times), queue depth and slot occupancy gauges, and Chrome-trace spans for
the host-loop phases (admit / dispatch / drain / route / retire). Overshoot
tokens trimmed at retire are EXCLUDED from per-request token counts and
TPOT (they were never delivered), and counted separately so drained device
telemetry reconciles exactly with the routed streams."""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.telemetry import (
    Histogram,
    MetricsRegistry,
    TraceRecorder,
    maybe_span,
)

_ids = itertools.count()

# per-request latency buckets: 100us .. ~512s (geometric, base 2)
_LAT_EDGES = Histogram.log_edges(1e-4, 512.0)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int
    # per-request sampling override; None inherits the server build's
    # default. The loop forwards it verbatim at admission — a stochastic
    # request on a greedy server build raises there.
    sampling: Optional[SamplingParams] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # --- measured by the loop (perf_counter timestamps; only deltas
    # between them are ever reported)
    submitted_at: Optional[float] = None
    # (timestamp, cumulative tokens routed) per routed batch — pipelined
    # servers deliver several rounds at one sync point, which is ONE
    # arrival here: attribution follows what the caller could observe
    arrivals: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    # --- computed at retire (seconds; None when not measurable)
    ttft: Optional[float] = None
    tpot: Optional[float] = None
    overshoot: int = 0

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def record_arrival(self, n: int) -> None:
        if n <= 0:
            return
        prev = self.arrivals[-1][1] if self.arrivals else 0
        self.arrivals.append((time.perf_counter(), prev + n))

    def finalize_latency(self) -> None:
        """TTFT/TPOT from the arrival log, counting only DELIVERED tokens:
        the arrival that crossed ``max_new_tokens`` is the effective last
        one — overshoot routed beyond it (in-flight rounds at the finish
        line) never contributes to per-request throughput."""
        if not self.arrivals or self.submitted_at is None:
            return
        delivered = min(self.arrivals[-1][1], self.max_new_tokens)
        t_first = self.arrivals[0][0]
        self.ttft = t_first - self.submitted_at
        t_eff = next(t for t, cum in self.arrivals if cum >= delivered)
        if delivered > 1 and t_eff > t_first:
            self.tpot = (t_eff - t_first) / (delivered - 1)

    def itl_gaps(self) -> List[float]:
        """Inter-arrival gaps (seconds) between delivered-token batches."""
        delivered = min(
            self.arrivals[-1][1] if self.arrivals else 0, self.max_new_tokens
        )
        ts = []
        for t, cum in self.arrivals:
            ts.append(t)
            if cum >= delivered:
                break
        return [b - a for a, b in zip(ts, ts[1:])]


class RequestScheduler:
    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}   # slot -> request
        self.finished: List[Request] = []

    def submit(self, req: Request) -> None:
        if req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def admit(self) -> List[int]:
        """Fill free slots from the queue; returns newly admitted slots."""
        new = []
        for slot in range(self.max_batch):
            if slot not in self.active and self.queue:
                self.active[slot] = self.queue.popleft()
                new.append(slot)
        return new

    def retire(self) -> List[Request]:
        done = [s for s, r in self.active.items() if r.done or r.remaining <= 0]
        out = []
        for s in done:
            r = self.active.pop(s)
            r.done = True
            self.finished.append(r)
            out.append(r)
        return out

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.active)


class ServeLoop:
    """Continuous-batching loop: admits queued requests into server slots,
    steps the server, routes per-slot tokens back to their requests, and
    releases slots of finished requests (freeing their per-slot adaptive
    draft-length estimators for the next admission).

    Pipelined servers (``round_mode="single"`` with ``sync_every > 1``)
    return tokens lazily: a ``step()`` may return nothing (rounds still in
    flight) or several rounds' worth at a sync point. The loop stays
    correct under that contract by draining the server *before* re-binding
    any slot: in-flight tokens are routed under the slot→request mapping
    they were produced under, and only then does admission rebind the slot.
    A finished request may overshoot ``max_new_tokens`` by the rounds that
    were in flight when it crossed the line — the surplus is trimmed at
    retire, exactly like the synchronous path trims a long accepted chain.

    ``metrics`` defaults to the server's own registry (so loop metrics and
    server telemetry land on one /metrics endpoint); ``trace`` (a
    ``TraceRecorder``) turns on Chrome-trace spans for the loop phases."""

    def __init__(
        self,
        server,
        scheduler: RequestScheduler,
        metrics: Optional[MetricsRegistry] = None,
        trace: Optional[TraceRecorder] = None,
    ):
        self.server = server
        self.scheduler = scheduler
        self.metrics = (
            metrics if metrics is not None
            else getattr(server, "metrics", None)
        ) or MetricsRegistry()
        self.trace = trace
        self._slot_req: Dict[int, Request] = {}
        self._req_slot: Dict[int, int] = {}   # request_id -> slot

    def _route(self, out: Dict[int, List[int]]) -> None:
        for slot, toks in out.items():
            req = self._slot_req.get(slot)
            if req is not None and not req.done:
                req.generated.extend(toks)
                req.record_arrival(len(toks))
            elif toks:
                # committed for a slot with no live request to credit
                # (request already done, or drained after an unmapped
                # release) — counted so telemetry reconciliation closes
                self.metrics.counter("serve_unrouted_tokens_total").inc(
                    len(toks)
                )

    def _observe_retired(self, req: Request, trimmed: int) -> None:
        req.overshoot = trimmed
        req.finalize_latency()
        m = self.metrics
        m.counter("serve_requests_finished_total").inc()
        # delivered tokens only — the trimmed surplus goes to its own
        # counter (and is what device-telemetry reconciliation adds back)
        m.counter("serve_request_tokens_total").inc(len(req.generated))
        if trimmed:
            m.counter("serve_overshoot_tokens_total").inc(trimmed)
        if req.ttft is not None:
            m.histogram(
                "serve_request_ttft_seconds", edges=_LAT_EDGES
            ).observe(req.ttft)
        if req.tpot is not None:
            m.histogram(
                "serve_request_tpot_seconds", edges=_LAT_EDGES
            ).observe(req.tpot)
        for gap in req.itl_gaps():
            m.histogram(
                "serve_request_itl_seconds", edges=_LAT_EDGES
            ).observe(gap)

    def step_once(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        will_admit = bool(self.scheduler.queue) and (
            len(self.scheduler.active) < self.scheduler.max_batch
        )
        if will_admit:
            # sync-on-admit: drain in-flight rounds and route them under the
            # OLD slot mapping before any slot is re-bound
            flush = getattr(self.server, "flush", None)
            if flush is not None:
                with maybe_span(self.trace, "drain"):
                    out = flush()
                self._route(out)
        with maybe_span(self.trace, "admit"):
            for slot in self.scheduler.admit():
                req = self.scheduler.active[slot]
                # the request's token budget rides admission so paged
                # servers can size the slot's KV page allocation to
                # prompt + budget instead of a full max_len reservation
                if req.sampling is not None:
                    self.server.add_request(
                        slot, req.prompt, sampling=req.sampling,
                        max_new_tokens=req.max_new_tokens,
                    )
                else:
                    self.server.add_request(
                        slot, req.prompt,
                        max_new_tokens=req.max_new_tokens,
                    )
                self._slot_req[slot] = req
                self._req_slot[req.request_id] = slot
        # the "dispatch" span times the HOST side of a round (pipelined
        # rounds return before the device finishes; device completion is
        # accounted by the server's device_wait counter at drain points)
        with maybe_span(self.trace, "dispatch"):
            step_out = self.server.step()
        with maybe_span(self.trace, "route"):
            self._route(step_out)
            for slot, toks in step_out.items():
                out.setdefault(slot, []).extend(toks)
        with maybe_span(self.trace, "retire"):
            for req in self.scheduler.retire():
                trimmed = max(len(req.generated) - req.max_new_tokens, 0)
                req.generated = req.generated[: req.max_new_tokens]
                slot = self._req_slot.pop(req.request_id)
                del self._slot_req[slot]
                self.server.release(slot)
                self._observe_retired(req, trimmed)
        self.metrics.gauge("serve_queue_depth").set(len(self.scheduler.queue))
        self.metrics.gauge("serve_slots_occupied").set(
            len(self.scheduler.active)
        )
        return out

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Serve until the queue drains (or ``max_steps``); returns the
        finished requests in completion order."""
        steps = 0
        while self.scheduler.busy and (max_steps is None or steps < max_steps):
            self.step_once()
            steps += 1
        return self.scheduler.finished
