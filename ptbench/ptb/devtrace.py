"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of serving right after the window, reduced to the seconds the device was busy, the
device operations that took most time, and the longest idle gaps by what
the host was doing (the loop's spans, recorded as profiler ranges).

``reduce`` works on plain tuples, so the tests hold its arithmetic on the
CPU; ``Profiled`` is the only part that needs the card."""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
TOP = 10

Event = Tuple[str, str, int, int]      # (where: "device" | "host", name, start_ns, end_ns)


def _merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: Sequence[Event], span_names: Sequence[str], window_s: float) -> Optional[Dict]:
    """Busy seconds, the top device operations and the idle gaps between
    the device's first and last operation, each gap named by the host span
    that overlaps it most ("host" where none does); None without a device
    operation. ``window_s`` is the traced stretch's length on the host
    clock (the device synchronised at both ends)."""
    dev = [(name, s, e) for where, name, s, e in events if where == "device"]
    if not dev:
        return None
    busy = _merge((s, e) for _, s, e in dev)
    by_name: Dict[str, int] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    host = [(name, s, e) for where, name, s, e in events
            if where == "host" and name in span_names]
    named = []
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        best, over = "host", 0
        for name, s, e in host:
            o = min(e, g1) - max(s, g0)
            if o > over:
                best, over = name, o
        named.append((best, (g1 - g0) / 1e9))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9, "window_s": float(window_s),
            "device_ops": [[n[:96], t / 1e9] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in sorted(named, key=lambda x: -x[1])[:TOP]]}


def _events(prof, span_names: Sequence[str]) -> List[Event]:
    """The profiler's events as tuples: the device's kernels, copies and
    sets (never its copies of host ranges), and the host's named ranges."""
    out: List[Event] = []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""
        name = ev.name()
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if str(ev.device_type()).endswith("CUDA"):
            if "annotation" in kind or name in span_names:
                continue
            if kind and not any(kind.endswith(k) for k in DEVICE_KINDS):
                continue
            out.append(("device", name, s, e))
        elif name in span_names:
            out.append(("host", name, s, e))
    return out


class Profiled:
    """``start()`` / ``stop()`` around a stretch of serving; ``stop``
    returns ``reduce``'s dict. Host spans that want to be seen enter
    ``torch.profiler.record_function`` themselves."""

    def __init__(self, span_names: Sequence[str]):
        self.span_names = tuple(span_names)
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[Dict]:
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self.prof.stop()
        out = reduce(_events(self.prof, self.span_names), self.span_names, window_s)
        self.prof = None
        return out
