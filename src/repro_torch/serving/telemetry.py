"""Serving telemetry of the port: the host registry and the device buffer.

A copy of the reference's ``serving/telemetry.py``, with the device half in
PyTorch.

Host half: ``MetricsRegistry``
    Counters, gauges and log-bucketed histograms with Prometheus text
    exposition (``render_prometheus``) and a JSON-able ``snapshot``. The
    server's ``stats`` dict is a ``StatsView`` over registry counters keyed
    by the old names, so every ``srv.stats["round_dispatches"]`` read keeps
    working while the same numbers become scrapeable. ``TraceRecorder``
    records host-loop phase spans (admit / dispatch / drain / route /
    retire) as Chrome trace-event JSON.

Device half: the round telemetry buffer
    A single round is one launch of a captured CUDA graph with no host read
    between rounds, so its instrumentation must read nothing back either.
    The buffer is a fixed-shape dict of small int32 tensors on the device
    (per-slot accepted / drafted token counts, chosen draft budgets, PLD
    hits, per-(level, slot) cascade routing and acceptance tallies), views
    of one flat tensor. ``accumulate_round`` and ``accumulate_cascade``
    update it in place (``add_`` and one-hot adds, no scatter), so the
    update is captured into the round's graph on static tensors. The host
    reads the buffer, in one copy, only at the drain points the server
    already has (``flush``, admission, ``telemetry_totals``), after the
    rounds' own outputs were read: no launch and no host sync is added.

Rounds that read the host anyway (split, ``legacy`` and cascade rounds,
whose verify reads its verdict to the host in the port) accumulate the
same schema on the host from arrays they already read. ``merge_totals``
folds the two halves into one cumulative view, drained as deltas into the
registry.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsView",
    "STATS_METRICS",
    "TraceRecorder",
    "maybe_span",
    "profiler_trace",
    "telemetry_schema",
    "init_device_telemetry",
    "init_host_telemetry",
    "accumulate_round",
    "accumulate_cascade",
    "merge_totals",
    "fold_telemetry",
]


# =========================================================== host registry
def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """A monotonically increasing value (fractional increments allowed:
    the legacy ``*_time`` stats are second-counters)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """A point-in-time value (queue depth, slot occupancy)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A log-bucketed histogram with left-closed buckets.

    ``edges`` are the finite bucket boundaries; observations land in
    ``(-inf, e0), [e0, e1), ..., [e_{n-1}, +inf)`` via ``bisect_right`` on
    the precomputed edge list — no float ``log`` at observe time, so a
    value exactly equal to an edge deterministically lands in the bucket
    the edge OPENS (never lost, never double-counted; pinned by the
    property tests). Prometheus exposition
    renders the standard cumulative ``le`` form.
    """

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: List[float]) -> None:
        if sorted(edges) != list(edges) or len(set(edges)) != len(edges):
            raise ValueError("histogram edges must be strictly increasing")
        self.edges = list(edges)
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    @staticmethod
    def log_edges(lo: float, hi: float, base: float = 2.0) -> List[float]:
        """Geometric bucket edges ``lo, lo*base, ...`` up to (and
        including the first edge >=) ``hi``."""
        if lo <= 0 or base <= 1 or hi <= lo:
            raise ValueError("need 0 < lo < hi and base > 1")
        edges, e = [], lo
        # ~ceil(log_base(hi/lo)) + 1 edges, built multiplicatively so the
        # edge values are stable products (no log/pow roundtrip)
        for _ in range(int(math.log(hi / lo, base)) + 2):
            edges.append(e)
            if e >= hi:
                break
            e *= base
        return edges

    def bucket_index(self, v: float) -> int:
        return bisect.bisect_right(self.edges, v)

    def observe(self, v: float) -> None:
        self.counts[self.bucket_index(v)] += 1
        self.sum += v
        self.count += 1


# legacy BatchedSpecServer.stats key -> registry counter name. StatsView
# keeps every existing stats read/mutation working against the registry.
STATS_METRICS: Dict[str, str] = {
    "steps": "serve_rounds_total",
    "tokens": "serve_tokens_total",
    "target_calls": "serve_target_calls_total",
    "draft_dispatches": "serve_draft_dispatches_total",
    "draft_time": "serve_draft_seconds_total",
    "verify_time": "serve_verify_seconds_total",
    "drafted_tokens": "serve_drafted_tokens_total",
    "rescore_dispatches": "serve_rescore_dispatches_total",
    "rescore_time": "serve_rescore_seconds_total",
    "round_dispatches": "serve_round_dispatches_total",
    "host_syncs": "serve_host_syncs_total",
    "device_wait": "serve_device_wait_seconds_total",
    # the port's own: single rounds that ran the gated draft / chunked
    # prefill segment, and launches of the captured round's graph
    "draft_rounds": "serve_draft_rounds_total",
    "prefill_rounds": "serve_prefill_rounds_total",
    "graph_replays": "serve_graph_replays_total",
}

# integer-semantics stats keys: reads come back as int so existing
# ``== 8``-style pins and dict reprs stay exact
_INT_STATS = {
    "steps", "tokens", "target_calls", "draft_dispatches", "drafted_tokens",
    "rescore_dispatches", "round_dispatches", "host_syncs",
    "draft_rounds", "prefill_rounds", "graph_replays",
}

_LATENCY_EDGES = Histogram.log_edges(1e-4, 512.0)   # 100us .. ~512s


class MetricsRegistry:
    """Counters + gauges + histograms, keyed by (name, labels).

    One registry per server; exporters (``serving.exporters``) render it
    as Prometheus text or JSONL snapshots. Creation is get-or-create so
    hot paths just call ``registry.counter(...).inc()``."""

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Counter] = {}
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Gauge] = {}
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}

    # ------------------------------------------------------------- factories
    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(
        self, name: str, edges: Optional[List[float]] = None, **labels: Any
    ) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram(
                list(_LATENCY_EDGES) if edges is None else edges
            )
        return h

    # --------------------------------------------------------------- export
    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4), stable ordering."""
        lines: List[str] = []
        typed: set = set()

        def _head(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, labels), c in sorted(self._counters.items()):
            _head(name, "counter")
            lines.append(f"{name}{_render_labels(labels)} {_num(c.value)}")
        for (name, labels), g in sorted(self._gauges.items()):
            _head(name, "gauge")
            lines.append(f"{name}{_render_labels(labels)} {_num(g.value)}")
        for (name, labels), h in sorted(self._hists.items()):
            _head(name, "histogram")
            # prometheus 'le' buckets are right-closed cumulative; our raw
            # buckets are left-closed — le=edges[i] accumulates every raw
            # bucket strictly below edge i (counts[0..i]), and since a
            # sample exactly ON an edge lands in the bucket the edge opens,
            # it is excluded from that le and included in the next: the
            # exposition stays a valid monotone cumulative either way
            for i, e in enumerate(h.edges):
                lines.append(
                    f"{name}_bucket{_merge_le(labels, e)} {sum(h.counts[: i + 1])}"
                )
            lines.append(f'{name}_bucket{_merge_le(labels, "+Inf")} {h.count}')
            lines.append(f"{name}_sum{_render_labels(labels)} {_num(h.sum)}")
            lines.append(f"{name}_count{_render_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able snapshot: rendered-name -> value/summary."""

        def nm(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
            return name + _render_labels(labels)

        return {
            "counters": {
                nm(n, la): c.value for (n, la), c in sorted(self._counters.items())
            },
            "gauges": {
                nm(n, la): g.value for (n, la), g in sorted(self._gauges.items())
            },
            "histograms": {
                nm(n, la): {
                    "edges": h.edges, "counts": h.counts,
                    "sum": h.sum, "count": h.count,
                }
                for (n, la), h in sorted(self._hists.items())
            },
        }


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _merge_le(labels: Tuple[Tuple[str, str], ...], le: Any) -> str:
    return _render_labels(tuple(sorted(labels + (("le", str(le)),))))


class StatsView:
    """MutableMapping facade: the legacy ``server.stats`` dict, backed by
    registry counters (``STATS_METRICS``). Reads, ``+=`` mutations, and
    dict-style iteration all operate on the live registry, so the stats
    the tests pin and the /metrics endpoint exports cannot drift apart."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self._registry = registry
        for name in STATS_METRICS.values():
            registry.counter(name)          # materialize at zero

    def __getitem__(self, key: str):
        v = self._registry.counter(STATS_METRICS[key]).value
        return int(v) if key in _INT_STATS else v

    def __setitem__(self, key: str, value: float) -> None:
        self._registry.counter(STATS_METRICS[key]).value = float(value)

    def __contains__(self, key: str) -> bool:
        return key in STATS_METRICS

    def __iter__(self) -> Iterator[str]:
        return iter(STATS_METRICS)

    def keys(self):
        return list(STATS_METRICS)

    def __len__(self) -> int:
        return len(STATS_METRICS)

    def get(self, key: str, default=None):
        return self[key] if key in STATS_METRICS else default

    def items(self):
        return [(k, self[k]) for k in STATS_METRICS]

    def copy(self) -> Dict[str, float]:
        return {k: self[k] for k in STATS_METRICS}

    def __repr__(self) -> str:
        return f"StatsView({self.copy()!r})"


# ============================================================ trace spans
class TraceRecorder:
    """Chrome trace-event recorder for host-loop phases.

    ``span(name)`` records one complete ("ph": "X") event; ``save`` writes
    the ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
    (https://ui.perfetto.dev) open directly. Timestamps are microseconds
    relative to recorder creation (``time.perf_counter`` deltas only). Host-phase spans deliberately do
    NOT force device syncs: a "dispatch" span times the host-side dispatch
    of a pipelined round (device completion is accounted separately by the
    ``device_wait`` counter at the drain points)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            ev = {
                "name": name, "ph": "X", "pid": self._pid, "tid": 0,
                "ts": (t0 - self._t0) * 1e6, "dur": (t1 - t0) * 1e6,
            }
            if args:
                ev["args"] = args
            self.events.append(ev)

    def instant(self, name: str, **args: Any) -> None:
        ev = {
            "name": name, "ph": "i", "s": "t", "pid": self._pid, "tid": 0,
            "ts": (time.perf_counter() - self._t0) * 1e6,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_json(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def maybe_span(trace: Optional[TraceRecorder], name: str, **args: Any):
    """``with maybe_span(trace, "drain"):`` — a no-op when tracing is off,
    so call sites don't branch."""
    if trace is None:
        return contextlib.nullcontext()
    return trace.span(name, **args)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the wrapped region with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write its Chrome trace
    (``*.pt.trace.json``) into ``log_dir`` when a directory is given; a
    no-op otherwise. The counterpart of the reference's
    ``jax.profiler.trace``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


# ====================================================== device telemetry
def telemetry_schema(
    batch: int, budget_max: int, levels: int = 0
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """The fixed-shape buffer layout, shared by the device buffer and its
    host-side numpy twin:

      rounds          (B,)            live rounds per slot
      accepted        (B,)            committed tokens per slot (n_acc sums)
      drafted         (B,)            neural drafted tokens per slot
      pld_tokens      (B,)            PLD-proposed tokens per slot
      pld_hit_rounds  (B,)            rounds with >= 1 PLD proposal
      budget_hist     (B, budget_max+1)  chosen draft budget / tree
                                      expansion count histogram (column j =
                                      rounds the Eq. 5 routing picked j)
      casc_routed     (L, B)          rounds level l participated in
      casc_obs        (L, B)          Eq. 4 observations of level l's first
                                      token (row 0 = the target judging the
                                      strongest level)
      casc_accept     (L, B)          ... of which accepted

    Every array is int32. Cascade rows exist only for cascade servers
    (``levels > 0``)."""
    B, K = batch, budget_max
    schema: Dict[str, Tuple[Tuple[int, ...], Any]] = {
        "rounds": ((B,), np.int32),
        "accepted": ((B,), np.int32),
        "drafted": ((B,), np.int32),
        "pld_tokens": ((B,), np.int32),
        "pld_hit_rounds": ((B,), np.int32),
        "budget_hist": ((B, K + 1), np.int32),
    }
    if levels:
        schema["casc_routed"] = ((levels, B), np.int32)
        schema["casc_obs"] = ((levels, B), np.int32)
        schema["casc_accept"] = ((levels, B), np.int32)
    return schema


class DeviceTelemetry(dict):
    """The device buffer: schema name -> int32 tensor, every tensor a view
    of the one flat tensor ``flat``, so the host reads it in one copy."""

    flat: torch.Tensor

    def to_host(self) -> Dict[str, np.ndarray]:
        flat = self.flat.cpu().numpy()
        return {k: flat[v.storage_offset(): v.storage_offset() + v.numel()].reshape(v.shape).copy()
                for k, v in self.items()}

    def zero_(self) -> None:
        self.flat.zero_()


def init_device_telemetry(schema: Dict[str, Tuple[Tuple[int, ...], Any]],
                          device) -> DeviceTelemetry:
    """A fresh all-zero device buffer on ``device``."""
    sizes = [int(np.prod(shape)) for shape, _ in schema.values()]
    flat = torch.zeros((sum(sizes),), dtype=torch.int32, device=device)
    out = DeviceTelemetry()
    out.flat = flat
    at = 0
    for (name, (shape, _)), n in zip(schema.items(), sizes):
        out[name] = flat[at: at + n].view(shape)
        at += n
    return out


def init_host_telemetry(
    schema: Dict[str, Tuple[Tuple[int, ...], Any]]
) -> Dict[str, np.ndarray]:
    """The numpy twin, accumulated by rounds that read the host anyway."""
    return {k: np.zeros(shape, dtype) for k, (shape, dtype) in schema.items()}


def _budget_onehot(budget: torch.Tensor, live_i: torch.Tensor, K1: int) -> torch.Tensor:
    """(B, K1) one-hot of the clipped budget, weighted by the live flags:
    a broadcast compare, not a scatter."""
    col = torch.clamp(budget.to(torch.int32), 0, K1 - 1)
    hit = col[:, None] == torch.arange(K1, dtype=torch.int32, device=col.device)[None, :]
    return hit.to(torch.int32) * live_i[:, None]


def accumulate_round(telem: dict, out: dict, live: torch.Tensor) -> dict:
    """Add one ``chain_fused`` / ``tree_fused`` single round to the device
    buffer, in place: inside the round's captured graph it reads and writes
    only static tensors. ``out`` is the round's output dict (``n_acc``,
    ``drafted``, ``pld_have``, ``budget``); dead slots contribute zeros by
    the engine's masking. Returns ``telem``."""
    li = live.to(torch.int32)
    telem["rounds"].add_(li)
    telem["accepted"].add_(out["n_acc"].to(torch.int32))
    telem["drafted"].add_(out["drafted"].to(torch.int32))
    telem["pld_tokens"].add_(out["pld_have"].to(torch.int32))
    telem["pld_hit_rounds"].add_(((out["pld_have"] > 0) & live).to(torch.int32))
    telem["budget_hist"].add_(_budget_onehot(out["budget"], li, telem["budget_hist"].shape[1]))
    return telem


def accumulate_cascade(
    telem: dict,
    *,
    live: torch.Tensor,
    n_acc: torch.Tensor,
    count: torch.Tensor,
    pld_have: torch.Tensor,
    budget: torch.Tensor,
    routed: torch.Tensor,
    probe_ok: torch.Tensor,
    probe_valid: torch.Tensor,
    rescorer_rows: Tuple[int, ...],
    drafter_row: int,
    obs_row: int,
) -> dict:
    """Add one cascade round to the device buffer, in place, after its last
    dispatch (``cascade_rescore_verify``, which carries the target verify).

    Row bookkeeping (``DraftBank``): ``rescorer_rows`` are the level indices
    that rescored this round (they share one routing decision),
    ``drafter_row`` participates whenever a neural budget was granted, and
    ``obs_row`` is the level whose first token this dispatch judged (the
    strongest rescorer prices level ``its index + 1``). Intermediate
    rescorers' verdicts and the target-facing row 0 are tallied on the host
    by the server from the arrays it already reads for the Eq. 4 trackers.
    The port's server tallies its cascade rounds on the host instead: its
    verify hands ``n_acc`` back as host arrays, so this update would only
    copy them back to the device. Returns ``telem``."""
    li = live.to(torch.int32)
    pld = pld_have.to(torch.int32)
    telem["rounds"].add_(li)
    telem["accepted"].add_(n_acc.to(torch.int32))
    telem["drafted"].add_(torch.clamp(count.to(torch.int32) - pld - 1, min=0) * li)
    telem["pld_tokens"].add_(pld * li)
    telem["pld_hit_rounds"].add_(((pld_have > 0) & live).to(torch.int32))
    telem["budget_hist"].add_(_budget_onehot(budget, li, telem["budget_hist"].shape[1]))
    routed_i = (routed & live).to(torch.int32)
    for r in rescorer_rows:
        telem["casc_routed"][r].add_(routed_i)
    telem["casc_routed"][drafter_row].add_(((budget > 0) & live).to(torch.int32))
    telem["casc_obs"][obs_row].add_(probe_valid.to(torch.int32))
    telem["casc_accept"][obs_row].add_((probe_valid & probe_ok).to(torch.int32))
    return telem


def merge_totals(
    device: Optional[DeviceTelemetry], host: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Cumulative totals = device buffer + host twin. Call only at a drain
    point, where the rounds that wrote the buffer were already read."""
    out = {k: v.copy() for k, v in host.items()}
    if device is not None:
        for k, v in device.to_host().items():
            out[k] = out[k] + v
    return out


def fold_telemetry(
    registry: MetricsRegistry,
    delta: Dict[str, np.ndarray],
    prefix: str = "serve",
) -> None:
    """Fold a drained per-slot delta into labeled registry counters."""
    per_slot = {
        "rounds": f"{prefix}_slot_rounds_total",
        "accepted": f"{prefix}_slot_accepted_tokens_total",
        "drafted": f"{prefix}_slot_drafted_tokens_total",
        "pld_tokens": f"{prefix}_slot_pld_tokens_total",
        "pld_hit_rounds": f"{prefix}_slot_pld_hit_rounds_total",
    }
    for key, name in per_slot.items():
        arr = delta.get(key)
        if arr is None:
            continue
        for b, v in enumerate(arr):
            if v:
                registry.counter(name, slot=b).inc(int(v))
    bh = delta.get("budget_hist")
    if bh is not None:
        for b in range(bh.shape[0]):
            for j in range(bh.shape[1]):
                if bh[b, j]:
                    registry.counter(
                        f"{prefix}_draft_budget_rounds_total", slot=b, budget=j
                    ).inc(int(bh[b, j]))
    per_level = {
        "casc_routed": f"{prefix}_cascade_routed_rounds_total",
        "casc_obs": f"{prefix}_cascade_obs_total",
        "casc_accept": f"{prefix}_cascade_accept_total",
    }
    for key, name in per_level.items():
        arr = delta.get(key)
        if arr is None:
            continue
        for lvl in range(arr.shape[0]):
            for b in range(arr.shape[1]):
                if arr[lvl, b]:
                    registry.counter(name, level=lvl, slot=b).inc(
                        int(arr[lvl, b])
                    )
