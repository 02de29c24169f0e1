"""The arithmetic that metric readers share, over a finished window.

A run's record (``Window``) holds each request's log of deliveries (host
time, cumulative tokens routed; overshoot past its budget dropped), the
loop's spans, the server's counters at the window's two step boundaries,
and the device trace of a traced run. Every end-to-end number is taken
over all the work and all the time of the window ``[w0, w1]``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ptb import counts


@dataclasses.dataclass
class Window:
    cfg: dict
    mix: dict
    w0: float                      # the window's start and end, host clock
    w1: float
    requests: List[dict]           # index, prompt_len, max_new, due, admitted_at, arrivals, ...
    spans: List[Tuple[str, float, float]]
    c0: Dict[str, float]           # server counters at the first step boundary >= w0
    c1: Dict[str, float]           # ... and at the last boundary (>= w1)
    t_c0: float
    t_c1: float
    setup_s: float
    profile: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def delta(self, name: str) -> float:
        return self.c1[name] - self.c0[name]


def deliveries(req: dict) -> List[Tuple[float, int]]:
    """(time, cumulative delivered tokens) up to the request's budget: the
    arrival that crosses it is its last, counted at the budget."""
    out = []
    for t, cum in req["arrivals"]:
        out.append((t, min(cum, req["max_new"])))
        if cum >= req["max_new"]:
            break
    return out


def in_window(w: Window, t: float) -> bool:
    return w.w0 <= t <= w.w1


def window_gaps(w: Window) -> Tuple[List[float], List[int]]:
    """Over every request, each gap between consecutive deliveries that both
    fall in the window, and the tokens the later one brought."""
    gaps, toks = [], []
    for r in w.requests:
        d = deliveries(r)
        for (ta, ca), (tb, cb) in zip(d, d[1:]):
            if in_window(w, ta) and in_window(w, tb):
                gaps.append(tb - ta)
                toks.append(cb - ca)
    return gaps, toks


def window_token_spans(w: Window) -> List[Tuple[dict, int, int]]:
    """(request, first, last): the served tokens (1-based) each request was
    delivered inside the window."""
    out = []
    for r in w.requests:
        prev = 0
        for t, cum in deliveries(r):
            if in_window(w, t) and cum > prev:
                out.append((r, prev + 1, cum))
            prev = cum
    return out


def window_tokens(w: Window) -> int:
    return sum(last - first + 1 for _, first, last in window_token_spans(w))


def admissions(w: Window) -> List[dict]:
    return [r for r in w.requests if r.get("admitted_at") is not None
            and in_window(w, r["admitted_at"])]


def span_seconds(w: Window, names, t0: float, t1: float) -> float:
    """Seconds of the named spans inside [t0, t1]."""
    return sum(max(0.0, min(e, t1) - max(s, t0)) for n, s, e in w.spans if n in names)


def ttfts(w: Window) -> List[float]:
    """Due time to first delivery, of the requests first served in the
    window."""
    out = []
    for r in w.requests:
        d = deliveries(r)
        if d and r.get("due") is not None and in_window(w, d[0][0]):
            out.append(d[0][0] - r["due"])
    return out


def request_tpots(w: Window) -> List[float]:
    """Per request finished in the window: (last delivery - first) over its
    tokens after the first."""
    out = []
    for r in w.requests:
        d = deliveries(r)
        if not d or d[-1][1] < r["max_new"] or not in_window(w, d[-1][0]):
            continue
        if r["max_new"] > 1 and d[-1][0] > d[0][0]:
            out.append((d[-1][0] - d[0][0]) / (r["max_new"] - 1))
    return out


def target_flops(w: Window) -> float:
    """What an autoregressive target forward needs for the window's work:
    every token delivered in it, and every prompt admitted in it."""
    total = sum(counts.generated_flops(w.cfg, r["prompt_len"], a, b)
                for r, a, b in window_token_spans(w))
    return total + sum(counts.prefill_flops(w.cfg, r["prompt_len"]) for r in admissions(w))


# ------------------------------------------------------ per-layer readings
def round_ms(w: Window) -> Optional[float]:
    """Time between the window's two step boundaries outside the loop's
    admission spans (drain, admit) and its waits for arrivals (idle), over
    the rounds run between them."""
    rounds = w.delta("steps")
    if rounds <= 0:
        return None
    busy = (w.t_c1 - w.t_c0) - span_seconds(w, ("drain", "admit", "idle"), w.t_c0, w.t_c1)
    return 1000.0 * busy / rounds


def tokens_per_slot_round(w: Window) -> Optional[float]:
    """Accepted tokens over live slot-rounds, from the drained ring."""
    rounds = w.delta("ring_rounds")
    return w.delta("ring_accepted") / rounds if rounds > 0 else None


def draft_round_share(w: Window) -> Optional[float]:
    """Per cent of rounds whose graph ran the draft segment."""
    steps = w.delta("steps")
    return 100.0 * w.delta("draft_rounds") / steps if steps > 0 else None


def step_mfu(w: Window, peak: float) -> Optional[float]:
    """Per cent of ``peak`` that the window's autoregressive target work
    would take over its seconds."""
    f = target_flops(w)
    return 100.0 * f / w.seconds / peak if f > 0 else None


def idle_share(w: Window) -> Optional[float]:
    """Per cent of the traced stretch with no operation on the device."""
    pr = w.profile
    if not pr or pr["window_s"] <= 0 or pr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - pr["busy_s"] / pr["window_s"])


def admit_ms(w: Window) -> Optional[float]:
    """Drain and admit span time in the window, over its admissions."""
    n = len(admissions(w))
    return 1000.0 * span_seconds(w, ("drain", "admit"), w.w0, w.w1) / n if n else None
