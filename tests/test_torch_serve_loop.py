"""The port's serving entry point against the JAX reference's, on the CPU:
``data/``, ``ServeLoop`` and the ``repro_torch.launch.serve`` CLI.

``data/`` gives the reference's prompts, corpus and batches array for
array. ``ServeLoop`` over the port's server gives the reference loop's
streams request by request and its finished order, with more requests than
slots, so slots are re-admitted. In every proposal mode the loop's telemetry
reconciles exactly: the accepted tokens the server tallied equal the
delivered, trimmed overshoot, unrouted, discarded and left-over tokens; the
latency histograms, gauges and loop spans are there. The CLI's last line
carries the reference CLI's keys, single-stream and batched.
"""
import dataclasses
import json
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.launch.mesh as j_mesh  # noqa: E402
import repro.launch.serve as j_serve  # noqa: E402
import repro.serving.server as j_server  # noqa: E402
from repro import data as j_data  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402
from repro_torch import bridge, data  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import layer_sparsity  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import scheduler as p_sched  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BatchedSpecServer,
    Request,
    RequestScheduler,
    TraceRecorder,
)

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
SPEC, J_SPEC = layer_sparsity(CFG, 0.5), j_layer_sparsity(J_CFG, 0.5)
PROMPTS = [p[:n] for p, n in zip(
    data.make_task_prompts(data.SPEC_TASKS["summarization"], 2, CFG.vocab_size)
    + data.make_task_prompts(data.SPEC_TASKS["math"], 2, CFG.vocab_size), (16, 12, 14, 10))]
BUDGETS = (9, 12, 7, 10)
# the proposal modes of tests/test_telemetry.py
MODES = {
    "chain_single": ("chain_fused", {"round_mode": "single", "sync_every": 3}),
    "chain_split": ("chain_fused", {"round_mode": "split"}),
    "tree_single": ("tree_fused", {"round_mode": "single", "sync_every": 2}),
    "legacy": ("legacy", {}),
    "cascade": ("cascade_fused", {}),
}


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("task", sorted(data.SPEC_TASKS))
def test_task_prompts_equal_reference(task):
    assert data.SPEC_TASKS[task] == data.TaskSpec(**dataclasses.asdict(j_data.SPEC_TASKS[task]))
    for seed in (0, 5):
        got = data.make_task_prompts(data.SPEC_TASKS[task], 3, CFG.vocab_size, seed=seed)
        want = j_data.make_task_prompts(j_data.SPEC_TASKS[task], 3, CFG.vocab_size, seed=seed)
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_corpus_batches_and_tokenizer_equal_reference():
    got, want = data.synthetic_corpus(CFG.vocab_size, 4000, seed=3), j_data.synthetic_corpus(
        CFG.vocab_size, 4000, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for a, b, _ in zip(data.lm_batches(got, 4, 32, seed=1), j_data.lm_batches(want, 4, 32, seed=1),
                       range(3)):
        assert np.array_equal(a["tokens"], b["tokens"]) and a["tokens"].dtype == np.int32
    tok, jtok = data.ByteTokenizer(), j_data.ByteTokenizer()
    assert tok.vocab_size == jtok.vocab_size == 320
    text = "speculative — décodage"
    assert np.array_equal(tok.encode(text, eos=True), jtok.encode(text, eos=True))
    assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text)) == text


# ----------------------------------------------------------------- ServeLoop
def _server(mode, kw, ref=False, **extra):
    kwargs = dict(max_batch=2, max_len=96, draft_k=4, tree_expansions=3, adaptive=False)
    if mode != "cascade_fused":
        kwargs["draft_spec"] = J_SPEC if ref else SPEC
    kwargs.update(kw, **extra)
    srv = (j_server.BatchedSpecServer(J_CFG, J_PARAMS, mode=mode, **kwargs) if ref
           else BatchedSpecServer(CFG, PARAMS, mode=mode, device="cpu", **kwargs))
    # split rounds price the draft by the wall clock: hold the priors
    srv.costs.observe = lambda *a, **k: None
    srv.costs.observe_target = lambda *a, **k: None
    return srv


def _loop(srv, mod, trace=None):
    """Serve the four requests on the server's two slots; returns (the
    finished requests' prompt indices in completion order, their streams
    by prompt index, the loop)."""
    sched = mod.RequestScheduler(2)
    reqs = [mod.Request(prompt=p, max_new_tokens=n) for p, n in zip(PROMPTS, BUDGETS)]
    index = {id(r): i for i, r in enumerate(reqs)}
    for r in reqs:
        sched.submit(r)
    loop = mod.ServeLoop(srv, sched, trace=trace)
    done = loop.run(max_steps=200)
    order = [index[id(r)] for r in done]
    return order, {index[id(r)]: r.generated for r in done}, loop


def test_serve_loop_equals_reference():
    """More requests than slots, single rounds at sync_every=2: the same
    streams request by request and the same finished order."""
    mode, kw = MODES["tree_single"]
    order, streams, _ = _loop(_server(mode, kw), p_sched)
    j_order, j_streams, _ = _loop(_server(mode, kw, ref=True), j_sched)
    assert len(order) == 4 and order == j_order
    assert streams == j_streams
    assert [len(streams[i]) for i in range(4)] == list(BUDGETS)


@pytest.mark.parametrize("name", list(MODES))
def test_serve_loop_reconciliation(name):
    """accepted == delivered + overshoot + unrouted + discarded + leftover;
    the trimmed surplus is not delivered; histograms, gauges and spans."""
    mode, kw = MODES[name]
    srv = _server(mode, kw)
    trace = TraceRecorder()
    _, streams, loop = _loop(srv, p_sched, trace=trace)
    assert [len(streams[i]) for i in range(4)] == list(BUDGETS)
    leftover = srv.flush()
    tot = srv.telemetry_totals()
    snap = srv.metrics.snapshot()
    c = snap["counters"]
    delivered = sum(len(s) for s in streams.values())
    accounted = (delivered + c.get("serve_overshoot_tokens_total", 0)
                 + c.get("serve_unrouted_tokens_total", 0)
                 + c.get("serve_discarded_tokens_total", 0)
                 + sum(len(v) for v in leftover.values()))
    assert int(tot["accepted"].sum()) == accounted
    assert c["serve_request_tokens_total"] == delivered == sum(BUDGETS)
    assert c["serve_requests_finished_total"] == 4
    hists = snap["histograms"]
    for h in ("serve_request_ttft_seconds", "serve_request_tpot_seconds",
              "serve_request_itl_seconds"):
        assert hists[h]["count"] > 0, h
    assert hists["serve_request_ttft_seconds"]["count"] == 4
    assert snap["gauges"]["serve_queue_depth"] == 0 and snap["gauges"]["serve_slots_occupied"] == 0
    names = {e["name"] for e in trace.events}
    assert {"admit", "dispatch", "route", "retire"} <= names
    if srv.round_mode == "single":
        assert "drain" in names                     # sync-on-admit flushed the ring
    assert loop.metrics is srv.metrics


def test_request_latency_excludes_overshoot():
    """A request whose last arrival overshoots: TPOT and ITL stop at the
    arrival that crossed ``max_new_tokens``."""
    req = Request(prompt=np.zeros(3, np.int32), max_new_tokens=5)
    req.submitted_at = 0.0
    req.arrivals = [(1.0, 2), (2.0, 4), (4.0, 7), (9.0, 9)]
    req.finalize_latency()
    assert req.ttft == 1.0 and req.tpot == pytest.approx(3.0 / 4)
    assert req.itl_gaps() == [1.0, 2.0]
    sched = RequestScheduler(1)
    sched.submit(req)
    assert sched.admit() == [0] and sched.busy
    req.generated = [1] * 5
    assert sched.retire() == [req] and not sched.busy


# ----------------------------------------------------------------------- CLI
def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _reference_cli(monkeypatch, capsys, argv):
    """The reference CLI in-process. Its ``--mesh`` path builds a device mesh:
    here the one-device mesh is a stand-in and the server is built without
    it, which is what a one-device mesh serves."""
    orig = j_server.BatchedSpecServer
    monkeypatch.setattr(j_server, "BatchedSpecServer",
                        lambda *a, mesh=None, **k: orig(*a, **k))
    monkeypatch.setattr(j_mesh, "mesh_from_spec", lambda spec: types.SimpleNamespace(
        shape={"model": 1, "data": 1}, devices=np.zeros(1)))
    monkeypatch.setattr(j_mesh, "set_global_mesh", lambda m: m)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    j_serve.main()
    return _last_json(capsys.readouterr().out)


def test_cli_single_stream_summary_keys_equal_reference(monkeypatch, capsys):
    argv = ["--reduced", "--scheduler", "ar", "--tokens", "3"]
    serve.main(["--device", "cpu", *argv])
    got = _last_json(capsys.readouterr().out)
    want = _reference_cli(monkeypatch, capsys, argv)
    assert set(got) == set(want)
    assert got["kind"] == "serve_summary" and got["delivered_tokens"] == 3
    assert got["rounds"] == got["target_calls"] == 3


def test_cli_batched_summary_and_exporters(monkeypatch, capsys, tmp_path):
    argv = ["--reduced", "--mesh", "model=1,data=1", "--mode", "legacy", "--batch", "1",
            "--tokens", "2"]
    trace, jsonl = tmp_path / "trace.json", tmp_path / "summary.jsonl"
    serve.main(["--device", "cpu", *argv, "--metrics-port", "0", "--trace-out", str(trace),
                "--metrics-jsonl", str(jsonl)])
    out = capsys.readouterr().out
    got = _last_json(out)
    assert "metrics: http://127.0.0.1:" in out
    want = _reference_cli(monkeypatch, capsys, argv)
    assert set(got) == set(want)
    assert got["kind"] == "serve_summary" and got["delivered_tokens"] == 2
    assert got["requests"] == 1 and 0.0 <= got["spec_accept_rate"] <= 1.0
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"admit", "dispatch", "route", "retire"} <= names
    assert [json.loads(x) for x in jsonl.read_text().splitlines()] == [got]


def test_cli_refuses_a_larger_mesh_and_a_missing_card():
    # a mesh of more than one device runs one process a device: started by
    # torchrun or by --spawn, never silently in this one
    with pytest.raises(SystemExit, match="torchrun or pass --spawn"):
        serve.main(["--device", "cpu", "--reduced", "--mesh", "model=2,data=1"])
    with pytest.raises(SystemExit, match="bad --mesh"):
        serve.main(["--device", "cpu", "--reduced", "--mesh", "rows=2"])
    with pytest.raises(ValueError):
        serve.parse_mesh("rows=1")
    assert serve.parse_mesh("model=1,data=1") == {"model": 1, "data": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--reduced", "--tokens", "1"])
