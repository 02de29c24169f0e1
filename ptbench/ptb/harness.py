"""One cell, once: the served model built from its configuration file, its
traffic driven through the program's ``ServeLoop`` for the window, the
metrics read, and the served tokens judged against the plain reference.

The program is ``repro_torch``: ``BatchedSpecServer`` in the
configuration's server build (single rounds captured as one CUDA graph
each, greedy), fed by ``ServeLoop.step_once``. The harness takes from it
only the system under test, its spans (the loop's ``trace`` recorder),
its counters (``stats``, ``ring_totals``) and the device trace's kernel
names."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import time
from typing import Callable, Dict, List, Optional

from ptb import judge, measures, traffic, weights
from ptb.devtrace import Profiled
from ptb.spec import Cell, metric_file

LOOP_SPANS = ("drain", "admit", "dispatch", "route", "retire")
SPAN_NAMES = LOOP_SPANS + ("harness", "idle")
MAX_LEN_SLACK = 32          # positions past prompt + budget: the rounds in flight
SIZE_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
             "vocab_size", "rope_theta", "norm_eps", "act", "mlp_gated", "tie_embeddings",
             "dtype")


class Spans:
    """The loop's trace recorder (``ServeLoop(trace=)`` calls ``span``):
    each span kept as (name, start, end) on the host clock and, while
    ``ranges`` is on, entered as a profiler range too."""

    def __init__(self):
        self.events: List[tuple] = []
        self.ranges = False

    @contextlib.contextmanager
    def span(self, name: str, **_):
        rf = None
        if self.ranges:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.events.append((name, t0, t1))


def program_config(cfg: dict):
    """The program's ``ModelConfig`` with every size of the file."""
    from repro_torch.config import get_config

    base = get_config(cfg["arch"])
    kw = {k: cfg[k] for k in SIZE_KEYS if k in cfg}
    if cfg.get("moe"):
        kw["moe"] = dataclasses.replace(base.moe, **cfg["moe"])
    return dataclasses.replace(base, **kw)


def prefill_classes(table_) -> List[int]:
    """The longest prompt of each power-of-two length class: one warm-up
    prefill a class."""
    best: Dict[int, int] = {}
    for s in table_:
        c = max(16, 1 << (s.prompt_len - 1).bit_length())
        best[c] = max(best.get(c, 0), s.prompt_len)
    return [best[c] for c in sorted(best)]


def load_reader(name: str) -> Callable:
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"ptbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _counters(srv) -> Dict[str, float]:
    s = srv.stats
    rt = srv.ring_totals
    return {"steps": s["steps"], "draft_rounds": s["draft_rounds"],
            "graph_replays": s["graph_replays"], "host_syncs": s["host_syncs"],
            "ring_accepted": float(rt["accepted"].sum()), "ring_rounds": float(rt["rounds"].sum())}


class CellRun:
    """Build once (weights, server, warm-up), then serve one window a seed."""

    def __init__(self, cell: Cell, device: str = "cuda"):
        self.device = device
        self.cfg, self.mix, self.rate = cell.config, cell.traffic, cell.rate_per_s
        self.table = traffic.table(self.mix, self.rate)
        need = traffic.longest(self.table) + MAX_LEN_SLACK
        self.max_len = -(-need // 64) * 64
        self.srv = None

    # ------------------------------------------------------------- set-up
    def build(self) -> None:
        import torch
        from repro_torch.core.dsia import layer_sparsity
        from repro_torch.serving import BatchedSpecServer

        dev = torch.device(self.device)
        self.params = weights.make(self.cfg, dev, int(self.cfg["weight_seed"]))
        self.mcfg = program_config(self.cfg)
        s = self.cfg["server"]
        self.B = int(s["max_batch"])
        self.srv = BatchedSpecServer(
            self.mcfg, self.params, mode=s["mode"], round_mode=s["round_mode"],
            draft_spec=layer_sparsity(self.mcfg, float(s["draft_sparsity"])),
            draft_k=int(s["draft_k"]), tree_expansions=int(s["tree_expansions"]),
            max_batch=self.B, max_len=self.max_len, sync_every=int(s["sync_every"]),
            paged=bool(s.get("paged", False)), device=self.device)
        self.warm()

    def warm(self) -> None:
        """The cell's own shapes: one admission prefill a prompt-length
        class, then every slot admitted and a few rounds, all on fixed
        tokens; every slot released after."""
        V = int(self.cfg["vocab_size"])
        srv = self.srv
        for n in prefill_classes(self.table):
            srv.add_request(0, traffic.warm_tokens(n, V), max_new_tokens=16)
            srv.flush()
            srv.release(0)
        short = min(s.prompt_len for s in self.table)
        for b in range(self.B):
            srv.add_request(b, traffic.warm_tokens(short, V, salt=b + 1), max_new_tokens=16)
        for _ in range(4):
            srv.step()
        srv.flush()
        for b in range(self.B):
            srv.release(b)
        self._sync()

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    # ------------------------------------------------------------- window
    def serve(self, seed: int, seconds: float, trace: bool = False,
              setup_now: Optional[Callable] = None,
              profile: Optional[bool] = None) -> measures.Window:
        """Drive the mix through ``ServeLoop`` until the window has closed;
        returns the window's record (``setup_now()`` read at its start).
        ``trace`` records the loop's spans and, on the card, serves the
        mix's ``trace_s`` more seconds under the profiler once the window
        has closed (``profile=False``: spans alone)."""
        from repro_torch.serving import Request, RequestScheduler, ServeLoop

        V = int(self.cfg["vocab_size"])
        spans = Spans() if trace else None
        sched = RequestScheduler(self.B)
        loop = ServeLoop(self.srv, sched, trace=spans)
        recs: Dict[int, dict] = {}
        by_rid: Dict[int, dict] = {}
        done: List = []
        profile = trace if profile is None else profile
        prof = Profiled(SPAN_NAMES) if profile and self.device != "cpu" else None
        tr_s = float(self.mix["trace_s"])
        span = (lambda name: spans.span(name)) if spans else (lambda name: contextlib.nullcontext())

        def submit(spec, due):
            req = Request(prompt=traffic.prompt_tokens(self.mix, spec, V),
                          max_new_tokens=spec.output_len)
            req.submitted_at = due
            rec = {"index": spec.index, "prompt_len": spec.prompt_len,
                   "max_new": spec.output_len, "due": due, "admitted_at": None,
                   "arrivals": req.arrivals, "rounds": 0, "req": req}
            recs[spec.index] = rec
            by_rid[req.request_id] = rec
            sched.submit(req)

        def step():
            t = time.perf_counter()
            loop.step_once()
            with span("harness"):
                for req in list(sched.active.values()) + sched.finished[len(done):]:
                    rec = by_rid[req.request_id]
                    if rec["admitted_at"] is None:
                        rec["admitted_at"] = t
                    rec["rounds"] += 1
                done.extend(sched.finished[len(done):])

        nxt = [0]
        order = traffic.served(self.mix, seed, self.rate)
        if self.mix["kind"] == "open":
            t_sched = time.perf_counter()
            due = [t_sched + s.due_s for s in order]

            def until(t_end):
                while True:
                    now = time.perf_counter()
                    if now >= t_end:
                        return
                    while nxt[0] < len(due) and due[nxt[0]] <= now:
                        submit(order[nxt[0]], due[nxt[0]])
                        nxt[0] += 1
                    if sched.busy:
                        step()
                        continue
                    wake = min(due[nxt[0]] if nxt[0] < len(due) else t_end, t_end)
                    with span("idle"):
                        time.sleep(max(0.0, wake - time.perf_counter()))

            until(t_sched + float(self.mix["lead_s"]))
        else:
            def refill_and_step():
                while len(sched.queue) < self.B and nxt[0] < len(order):
                    submit(order[nxt[0]], time.perf_counter())
                    nxt[0] += 1
                if not sched.queue:
                    raise RuntimeError(f"mix {self.mix['name']!r}: the table of "
                                       f"{len(self.table)} requests ran out")
                step()

            def until(t_end):
                while time.perf_counter() < t_end:
                    refill_and_step()

            full = 0
            while full < int(self.mix["open_after_rounds"]):
                refill_and_step()
                full += len(sched.active) == self.B
        w0 = t_c0 = time.perf_counter()
        c0 = _counters(self.srv)
        setup_s = setup_now() if setup_now else None
        w1 = w0 + seconds
        until(w1)
        t_c1 = time.perf_counter()
        c1 = _counters(self.srv)
        profiled = None
        if prof is not None:
            spans.ranges = True
            prof.start()
            until(time.perf_counter() + tr_s)
            profiled = prof.stop()
            spans.ranges = False
        self._sync()
        for rec in recs.values():
            req = rec["req"]
            rec["served"] = list(req.generated) if req.done else None
            rec["prompt"] = req.prompt
        self._loop_left = (loop, sched)
        return measures.Window(
            cfg=self.cfg, mix=self.mix, w0=w0, w1=w1,
            requests=[{k: v for k, v in r.items() if k != "req"} for r in recs.values()],
            spans=list(spans.events) if spans else [], c0=c0, c1=c1, t_c0=t_c0, t_c1=t_c1,
            setup_s=setup_s, profile=profiled)

    def reset(self) -> None:
        """Every slot drained and released, for another window on the same
        server."""
        loop, sched = self._loop_left
        self.srv.flush()
        for slot in list(sched.active):
            self.srv.release(slot)
        self._loop_left = None
        self._sync()

    def free(self) -> None:
        """Drop the program's state (the server, its cache and graph); the
        weights stay, for the reference."""
        self._loop_left = None
        self.srv = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()


# ------------------------------------------------------------------ judging
def finished(window: measures.Window, before: Optional[float] = None) -> List[dict]:
    """Requests served to their budget (by ``before``, the window's close)."""
    out = []
    for r in window.requests:
        if r["served"] is None:
            continue
        d = measures.deliveries(r)
        if before is not None and (not d or d[-1][0] > before):
            continue
        out.append(r)
    return out


def stalled(window: measures.Window) -> int:
    """Requests that saw two rounds or more and got no token: every round
    delivers at least its pending token to each live slot."""
    return sum(1 for r in window.requests if r["rounds"] >= 2 and not r["arrivals"])


def verdict(cfg: dict, nums: Dict[str, float], side: str, extra: Dict[str, dict]) -> Dict:
    """``side``'s numbers, each beside its limit from the configuration,
    with the checks of the run itself (``extra``), and whether all hold."""
    checks = {name: {"value": nums.get(f"{side}_{judge.NUMBERS[name]}"), "limit": float(limit)}
              for name, limit in cfg["limits"].items()}
    checks.update(extra)
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks}


def check(params, cfg: dict, window: measures.Window, seed: int,
          sides=("served",)) -> Dict:
    """The comparison's numbers, each beside its limit, and the verdict on
    the served tokens; with more ``sides`` (``judge.SIDES``), the verdict
    on each by the same limits, under ``by_side``."""
    done = finished(window, window.w1)
    sample = judge.sample(done, seed)
    short = [r["index"] for r in sample if len(r["served"]) != r["max_new"]]
    extra = {"stalled_requests": {"value": stalled(window), "limit": 0},
             "short_requests": {"value": len(short), "limit": 0},
             "empty_sample": {"value": int(not sample), "limit": 0}}
    nums = judge.compare(params, cfg, sample, sides=sides) if sample else {}
    by_side = {side: verdict(cfg, nums, side, extra) for side in sides}
    served = by_side.get("served") or verdict(cfg, {}, "served", extra)
    return {"correct": served["correct"], "checks": served["checks"],
            "sampled": [r["index"] for r in sample], "numbers": nums, "by_side": by_side}


def read_metrics(window: measures.Window, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = load_reader(m["name"])(window)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def attempted(window: measures.Window) -> int:
    return sum(1 for r in window.requests
               if r["due"] is not None and r["due"] <= window.w1)
