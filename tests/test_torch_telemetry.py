"""The port's serving telemetry against the JAX reference's, on the CPU.

The host half (``MetricsRegistry``, ``Histogram``, ``StatsView``,
``TraceRecorder``, the exporters) behaves as the reference's on the same
observations: equal snapshots, byte-equal Prometheus text and JSONL lines,
the same bucket of every observation. The device half's in-place updates
(``accumulate_round``, ``accumulate_cascade``) equal the reference's pure
ones. On shared inputs the port's batched server drains the same
``telemetry_totals()``, the same non-timing ``metrics_summary()`` keys and
the same registry counters as the reference server in every proposal mode
of ``tests/test_telemetry.py``, and in chunked prefill with a prompt
admitted mid-stream (a slot still prefilling is credited no round).
Port-only: telemetry on and off give the same tokens, dispatches, syncs
and target calls; a single-round server's device buffer equals the fold of
its drained ring rows; a re-bound slot's undrained tokens are counted as
discarded; the sampled-request counter and the free-pages gauge follow
admissions and releases.
"""
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import exporters as JX  # noqa: E402
from repro.serving import telemetry as JT  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import layer_sparsity  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402
from repro_torch.serving import exporters as PX  # noqa: E402
from repro_torch.serving import telemetry as PT  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
SPEC, J_SPEC = layer_sparsity(CFG, 0.5), j_layer_sparsity(J_CFG, 0.5)
_rng = np.random.default_rng(0)
PROMPTS = [np.tile(_rng.integers(2, CFG.vocab_size, 5), 3).astype(np.int32),
           _rng.integers(2, CFG.vocab_size, 11).astype(np.int32)]
ROUNDS = 5
# the proposal modes of tests/test_telemetry.py
MODES = {
    "chain_single": ("chain_fused", {"round_mode": "single", "sync_every": 2}),
    "chain_split": ("chain_fused", {"round_mode": "split"}),
    "tree_single": ("tree_fused", {"round_mode": "single"}),
    "legacy": ("legacy", {}),
    "cascade": ("cascade_fused", {}),
    # chunked prefill: both prompts span several chunks, and slot 1 is
    # admitted mid-stream, so it prefills while slot 0 decodes
    "chain_chunked": ("chain_fused", {"round_mode": "single", "sync_every": 2, "paged": True,
                                      "page_size": 16, "prefill_chunk": 4}),
}
TIMING = ("device_wait_s",)
LATE = 2        # a chunked server admits slot 1 after this many rounds


def _server(mode, kw, ref=False, **extra):
    """A port (or reference) server at tests/test_telemetry.py's settings,
    its cost trackers held at their priors (split rounds price the draft by
    the wall clock)."""
    kwargs = dict(max_batch=2, max_len=64, draft_k=4, tree_expansions=3, adaptive=False)
    if mode != "cascade_fused":
        kwargs["draft_spec"] = J_SPEC if ref else SPEC
    kwargs.update(kw, **extra)
    srv = (JServer(J_CFG, J_PARAMS, mode=mode, **kwargs) if ref
           else BatchedSpecServer(CFG, PARAMS, mode=mode, device="cpu", **kwargs))
    srv.costs.observe = lambda *a, **k: None
    srv.costs.observe_target = lambda *a, **k: None
    return srv


def _rounds(srv):
    """Rounds served: a chunked server serves more, for its prefill rounds."""
    return 3 * ROUNDS if srv.prefill_chunk else ROUNDS


def _serve(srv, rounds=None):
    """Serve ``PROMPTS`` for ``rounds`` rounds and flush; a chunked server
    admits the second prompt only after ``LATE`` rounds."""
    late = LATE if srv.prefill_chunk else 0
    toks = {i: [] for i in range(len(PROMPTS))}
    for r in range(rounds or _rounds(srv)):
        for i, p in enumerate(PROMPTS):
            if r == (late if i else 0):
                srv.add_request(i, p)
        for b, t in srv.step().items():
            toks[b] += t
    for b, t in srv.flush().items():
        toks[b] += t
    return toks


# ------------------------------------------------------------------ host half
def _observe_both(fn):
    regs = (PT.MetricsRegistry(), JT.MetricsRegistry())
    for reg in regs:
        fn(reg)
    return regs


def test_counters_gauges_snapshot_and_text_equal_reference():
    def fill(reg):
        reg.counter("hits", slot=0).inc()
        reg.counter("hits", slot=0).inc(2)
        reg.counter("hits", slot=1).inc()
        reg.counter("secs", mode="x").inc(0.25)
        reg.gauge("depth").set(7)
        reg.gauge("occ", slot=3).set(0.5)

    port, ref = _observe_both(fill)
    assert port.counter("hits", slot=0).value == 3
    assert port.snapshot() == ref.snapshot()
    assert port.render_prometheus() == ref.render_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_buckets_and_render_equal_reference(seed):
    """Random observations and every edge exactly: the same bucket for each
    (left-closed, ``bisect_right``), and byte-equal Prometheus text."""
    rng = np.random.default_rng(seed)
    edges = PT.Histogram.log_edges(1e-4, 512.0)
    assert edges == JT.Histogram.log_edges(1e-4, 512.0)
    vals = list(rng.uniform(0, 600, 64)) + list(10 ** rng.uniform(-5, 3, 64)) + list(edges) + [0.0]

    def fill(reg):
        h = reg.histogram("lat_seconds", mode="m")
        for v in vals:
            h.observe(float(v))
        reg.histogram("small", edges=[0.1, 1.0, 10.0]).observe(1.0)

    port, ref = _observe_both(fill)
    hp, hr = port.histogram("lat_seconds", mode="m"), ref.histogram("lat_seconds", mode="m")
    assert hp.counts == hr.counts and hp.count == len(vals) == sum(hp.counts)
    assert [hp.bucket_index(e) for e in edges] == list(range(1, len(edges) + 1))
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("lo,hi,base", [(1e-4, 512.0, 2.0), (1e-3, 8.0, 2.0), (0.5, 100.0, 3.0)])
def test_log_edges_equal_reference(lo, hi, base):
    assert PT.Histogram.log_edges(lo, hi, base) == JT.Histogram.log_edges(lo, hi, base)
    with pytest.raises(ValueError):
        PT.Histogram([1.0, 1.0])


def test_stats_view_equals_reference():
    """The reference's keys read back alike (ints stay ints); the port's
    three extra keys are registry counters too, and the view converts to a
    dict."""
    views = [(reg, mod.StatsView(reg)) for reg, mod in ((PT.MetricsRegistry(), PT),
                                                        (JT.MetricsRegistry(), JT))]
    for _, sv in views:
        sv["steps"] += 3
        sv["draft_time"] += 0.25
        sv["host_syncs"] += 2
    (preg, psv), (jreg, jsv) = views
    for key in jsv:
        assert psv[key] == jsv[key] and type(psv[key]) is type(jsv[key]), key
    assert psv.get("not_a_stat", "d") == jsv.get("not_a_stat", "d") == "d"
    for key, name in (("draft_rounds", "serve_draft_rounds_total"),
                      ("prefill_rounds", "serve_prefill_rounds_total"),
                      ("graph_replays", "serve_graph_replays_total")):
        psv[key] += 1
        assert psv[key] == 1 and isinstance(psv[key], int)
        assert preg.counter(name).value == 1
    d = dict(psv)
    assert set(d) == set(jsv) | {"draft_rounds", "prefill_rounds", "graph_replays"}
    assert d == psv.copy() and dict(psv.items()) == d


def test_jsonl_sink_and_trace_equal_reference(tmp_path):
    """The same records give byte-equal JSONL files; a trace holds the same
    event fields as the reference's and loads back."""
    for name, mod, tmod in (("port", PX, PT), ("ref", JX, JT)):
        reg = tmod.MetricsRegistry()
        reg.counter("c").inc()
        reg.histogram("h", edges=[1.0, 2.0]).observe(1.5)
        with mod.JsonlSink(str(tmp_path / f"{name}.jsonl")) as sink:
            sink.write({"kind": "round", "n": 1})
            sink.write_registry(reg, step=2)
    port_lines = (tmp_path / "port.jsonl").read_text()
    assert port_lines == (tmp_path / "ref.jsonl").read_text()
    lines = [json.loads(x) for x in port_lines.splitlines()]
    assert lines[1]["kind"] == "metrics_snapshot" and lines[1]["metrics"]["counters"]["c"] == 1

    events = []
    for tmod in (PT, JT):
        trace = tmod.TraceRecorder()
        with trace.span("dispatch", round=1):
            with tmod.maybe_span(trace, "route"):
                pass
        with tmod.maybe_span(None, "noop"):
            pass
        trace.instant("sync")
        events.append(trace.to_json()["traceEvents"])
    assert [sorted(e) for e in events[0]] == [sorted(e) for e in events[1]]
    assert [(e["name"], e["ph"]) for e in events[0]] == [("route", "X"), ("dispatch", "X"),
                                                         ("sync", "i")]
    path = tmp_path / "trace.json"
    PX.write_chrome_trace(trace, str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """``profiler_trace`` (the counterpart of ``jax.profiler.trace``) writes
    a Chrome trace into the directory; without one it is a no-op."""
    with PT.profiler_trace(None):
        pass
    with PT.profiler_trace(str(tmp_path / "prof")):
        torch.ones(8).add_(1)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())


def test_metrics_http_endpoint():
    reg = PT.MetricsRegistry()
    reg.counter("serve_rounds_total").inc(4)
    reg.histogram("lat", edges=[1.0]).observe(0.5)
    with PX.MetricsHTTPServer(reg, port=0) as srv:
        assert srv.port > 0
        base = f"http://127.0.0.1:{srv.port}"
        assert srv.url == base + "/metrics"
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.status == 200 and "text/plain" in r.headers["Content-Type"]
            assert r.read().decode() == reg.render_prometheus()
        with urllib.request.urlopen(base + "/metrics.json", timeout=10) as r:
            assert json.loads(r.read().decode()) == json.loads(json.dumps(reg.snapshot()))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)


# ---------------------------------------------------------------- device half
def _round_out(rng, B, K):
    live = rng.random(B) < 0.7
    return live, {"n_acc": np.where(live, rng.integers(1, 6, B), 0).astype(np.int32),
                  "drafted": np.where(live, rng.integers(0, 4, B), 0).astype(np.int32),
                  "pld_have": np.where(live, rng.integers(0, 3, B), 0).astype(np.int32),
                  "budget": rng.integers(-1, K + 3, B).astype(np.int32)}


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_round_in_place_equals_reference(seed):
    rng = np.random.default_rng(seed)
    B, K = 4, 5
    schema = PT.telemetry_schema(B, K)
    assert schema == JT.telemetry_schema(B, K)
    dev = PT.init_device_telemetry(schema, "cpu")
    tensors = dict(dev)
    ref = JT.init_device_telemetry(schema)
    for _ in range(6):
        live, out = _round_out(rng, B, K)
        got = PT.accumulate_round(dev, {k: torch.as_tensor(v) for k, v in out.items()},
                                  torch.as_tensor(live))
        ref = JT.accumulate_round(ref, {k: jnp.asarray(v) for k, v in out.items()},
                                  jnp.asarray(live))
        assert got is dev and all(got[k] is tensors[k] for k in tensors)     # in place
    host = dev.to_host()
    for k, v in ref.items():
        np.testing.assert_array_equal(host[k], np.asarray(v), err_msg=k)
    assert dev.flat.numel() == sum(int(np.prod(s)) for s, _ in schema.values())


def test_accumulate_cascade_and_merge_equal_reference():
    rng = np.random.default_rng(3)
    B, K, L = 3, 5, 3
    schema = PT.telemetry_schema(B, K, levels=L)
    assert schema == JT.telemetry_schema(B, K, levels=L)
    dev, ref = PT.init_device_telemetry(schema, "cpu"), JT.init_device_telemetry(schema)
    for _ in range(5):
        live = rng.random(B) < 0.8
        kw = dict(live=live, n_acc=np.where(live, rng.integers(1, 6, B), 0),
                  count=rng.integers(1, 12, B), pld_have=rng.integers(0, 4, B),
                  budget=rng.integers(0, K + 1, B), routed=rng.random(B) < 0.5,
                  probe_ok=rng.random(B) < 0.5, probe_valid=rng.random(B) < 0.7)
        rows = dict(rescorer_rows=(0, 1), drafter_row=2, obs_row=2)
        PT.accumulate_cascade(dev, **{k: torch.as_tensor(v) for k, v in kw.items()}, **rows)
        ref = JT.accumulate_cascade(ref, **{k: jnp.asarray(v) for k, v in kw.items()}, **rows)
    host = PT.init_host_telemetry(schema)
    host["rounds"] += 1
    got, want = PT.merge_totals(dev, host), JT.merge_totals(ref, JT.init_host_telemetry(schema))
    want["rounds"] += 1
    for k in schema:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    preg, jreg = PT.MetricsRegistry(), JT.MetricsRegistry()
    PT.fold_telemetry(preg, got)
    JT.fold_telemetry(jreg, want)
    assert preg.snapshot() == jreg.snapshot()
    assert preg.render_prometheus() == jreg.render_prometheus()


# ----------------------------------------------------- the server, reference
def _counters(srv):
    return {k: v for k, v in srv.metrics.snapshot()["counters"].items()
            if not k.endswith("_seconds_total")}


@pytest.mark.parametrize("name", list(MODES))
def test_server_telemetry_equals_reference(name):
    """Shared params and prompts: equal streams, ``telemetry_totals()``,
    non-timing ``metrics_summary()`` keys and registry counters (the port's
    three extra counters aside)."""
    mode, kw = MODES[name]
    port, ref = _server(mode, kw), _server(mode, kw, ref=True)
    assert _serve(port) == _serve(ref)
    tp, tr = port.telemetry_totals(), ref.telemetry_totals()
    assert set(tp) == set(tr)
    for k in tr:
        np.testing.assert_array_equal(tp[k], np.asarray(tr[k]), err_msg=k)
    sp, sr = port.metrics_summary(), ref.metrics_summary()
    assert set(sp) == set(sr)
    assert {k: v for k, v in sp.items() if k not in TIMING} == {
        k: v for k, v in sr.items() if k not in TIMING}
    cp, cr = _counters(port), _counters(ref)
    assert {k: cp[k] for k in cr} == cr
    assert set(cp) - set(cr) <= {"serve_draft_rounds_total", "serve_prefill_rounds_total",
                                 "serve_graph_replays_total"}
    if port.round_mode == "single":
        for k, v in port.ring_totals.items():
            np.testing.assert_array_equal(tp[k], v, err_msg=k)


# ------------------------------------------------------------ the server, port
@pytest.mark.parametrize("name", list(MODES))
def test_telemetry_on_off_parity(name):
    """The buffer changes no token, dispatch, sync or target call; with it
    on, every accepted token is counted once, and a round is counted for a
    slot only once its prefill is done."""
    mode, kw = MODES[name]
    runs = {}
    for telem in (True, False):
        srv = _server(mode, kw, telemetry=telem)
        toks = _serve(srv)
        runs[telem] = (toks, *(srv.stats[k] for k in ("round_dispatches", "host_syncs",
                                                      "target_calls", "steps", "tokens")))
        if telem:
            tot = srv.telemetry_totals()
            assert [int(a) for a in tot["accepted"]] == [len(toks[b]) for b in sorted(toks)]
            assert (tot["budget_hist"].sum(axis=1) == tot["rounds"]).all()
            if srv.prefill_chunk:
                # each prompt takes several chunks: its prefill rounds go uncounted
                live = np.array([_rounds(srv), _rounds(srv) - LATE])
                assert (tot["rounds"] > 0).all() and (tot["rounds"] < live).all()
            else:
                assert tot["rounds"].tolist() == [ROUNDS] * len(PROMPTS)
    assert runs[True] == runs[False]


def test_device_buffer_equals_ring_fold_across_drains():
    """A single-round server checks its buffer against the drained ring at
    every telemetry drain: at sync_every=3 across a re-admission too."""
    srv = _server("tree_fused", {"round_mode": "single", "sync_every": 3})
    _serve(srv, rounds=4)
    srv.release(1)
    srv.add_request(1, PROMPTS[0])
    for _ in range(4):
        srv.step()
    tot = srv.telemetry_totals()
    for k, v in srv.ring_totals.items():
        np.testing.assert_array_equal(tot[k], v, err_msg=k)
    assert tot["rounds"].tolist() == [8, 8]
    # a corrupted buffer is caught at the next drain
    srv._telem_dev["accepted"][0] += 1
    with pytest.raises(RuntimeError, match="differs from the drained ring"):
        srv.flush()


def test_discarded_tokens_counted_on_slot_rebind():
    """Tokens in flight for a slot re-bound before anyone collected them are
    counted as discarded: all that slot accepted, here."""
    srv = _server("chain_fused", {"round_mode": "single", "sync_every": 3})
    srv.add_request(0, PROMPTS[0])
    srv.step()
    srv.step()
    assert srv.stats["host_syncs"] == 0
    srv.add_request(0, PROMPTS[1])                   # drains, then drops slot 0's tokens
    accepted = int(srv.telemetry_totals()["accepted"][0])
    snap = srv.metrics.snapshot()["counters"]
    assert accepted >= 2 and snap["serve_discarded_tokens_total"] == accepted


def test_sampled_requests_counter_and_free_pages_gauge():
    """``serve_sampled_requests_total`` counts stochastic admissions of a
    sampled build (not temperature-0 ones); ``serve_free_pages`` follows
    the page pool at admission and release."""
    srv = _server("chain_fused", {"round_mode": "single"}, paged=True, page_size=16,
                  sampling=SamplingParams(temperature=0.8, seed=1))
    pool = len(srv._free_pages)
    gauge = srv.metrics.gauge("serve_free_pages")
    srv.add_request(0, PROMPTS[0], max_new_tokens=8)
    srv.add_request(1, PROMPTS[1], sampling=SamplingParams(temperature=0.0), max_new_tokens=8)
    counters = srv.metrics.snapshot()["counters"]
    assert counters["serve_sampled_requests_total"] == 1
    used = sum(len(p) for p in srv._slot_pages.values())
    assert used > 0 and gauge.value == pool - used == len(srv._free_pages)
    srv.step()
    srv.release(0)
    assert gauge.value == len(srv._free_pages) == pool - len(srv._slot_pages[1])
