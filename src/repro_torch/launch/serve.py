"""Serving entry point of the port: the CAS-Spec engine (single stream) or the
batched server; the counterpart of the reference's ``launch/serve.py``,
with its flags and its last line.

  python -m repro_torch.launch.serve --scheduler dytc --tokens 64
  python -m repro_torch.launch.serve --arch gemma3-1b --mesh model=1,data=1 \\
      --mode tree_fused --batch 4 --tokens 32 --metrics-port 0 --trace-out trace.json

``--arch`` is any config the port registers (``repro_torch.config.
list_configs()``: vicuna-7b, the default, internlm2-20b, starcoder2-3b,
stablelm-1.6b, gemma3-1b, the image stack llava-next-mistral-7b, served
on text prompts, the MoE models qwen2-moe-a2.7b and mixtral-8x22b, the
Mamba-2 stacks mamba2-130m and jamba-v0.1-52b, and the codebook stack
musicgen-medium). On a stack with Mamba-2 blocks the tree schedulers
(``--scheduler dytc``, the default, and ``tree``) exit with the engine's
refusal: serve it with ``ar``, ``pld``, ``swift``, ``vc``, ``hc`` or
``vchc``, or batched in ``chain_fused`` or ``legacy``. musicgen-medium
exits with the engine's refusal whatever the flags: its codes are not
scalar tokens (``core.engine.check_text_stack``). It runs on the card
(``--device cuda``, the default; it raises when there is none). ``--device cpu --reduced`` runs the
kernels' plain versions on the CPU, at the reduced width with 8 layers.
``--mesh model=K,data=D`` serves the requests through ``ServeLoop`` and
``BatchedSpecServer``. A mesh of more than one device runs over a
``launch.mesh.Mesh``: one process a device, the params tensor-parallel
over ``model`` and the slots over ``data``. Launch K*D processes with
``torchrun --nproc-per-node K*D -m repro_torch.launch.serve --mesh ...``
(one card a rank, ``nccl``), or let the command start them itself with
``--spawn`` (a ``FileStore`` in a temporary directory). A one-device mesh
outside torchrun and ``--spawn`` serves in this process with no process
group, which is all a mesh of one device places. Rank 0 prints the lines
and the summary.

Observability: ``--metrics-port`` serves Prometheus text at ``/metrics``
while the run is in flight, ``--trace-out`` records Chrome-trace spans of
the serving loop's phases, ``--profile-dir`` wraps the run in
``torch.profiler`` (a Chrome trace in that directory) and
``--metrics-jsonl`` appends the summary as one JSONL record. Whatever the
flags, the last line of stdout is one JSON summary (``kind:
"serve_summary"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch import resolve_device
from repro_torch.config import get_config, list_configs
from repro_torch.core.cascade import (
    ARScheduler,
    HCScheduler,
    PLDScheduler,
    SDScheduler,
    TreeScheduler,
    VCHCScheduler,
    VCScheduler,
)
from repro_torch.core.dsia import build_hierarchy, layer_sparsity
from repro_torch.core.dytc import DyTCScheduler
from repro_torch.core.engine import SpecEngine, check_text_stack, check_tree_stack
from repro_torch.data import SPEC_TASKS, make_task_prompts
from repro_torch.launch.mesh import (
    Mesh,
    choose_backend,
    init_distributed,
    parse_mesh_spec,
    rank_device,
    spawn,
)
from repro_torch.models import init_params
from repro_torch.serving.exporters import JsonlSink, MetricsHTTPServer
from repro_torch.serving.telemetry import TraceRecorder, profiler_trace

SCHEDULERS = {
    "ar": lambda e, cfg: ARScheduler(e),
    "pld": lambda e, cfg: PLDScheduler(e, k=8),
    "swift": lambda e, cfg: SDScheduler(e, layer_sparsity(cfg, 0.4), k=4),
    "vc": lambda e, cfg: VCScheduler(e, layer_sparsity(cfg, 0.4)),
    "hc": lambda e, cfg: HCScheduler(e, layer_sparsity(cfg, 0.4)),
    "vchc": lambda e, cfg: VCHCScheduler(e, layer_sparsity(cfg, 0.4)),
    "tree": lambda e, cfg: TreeScheduler(e, layer_sparsity(cfg, 0.4)),
    "dytc": lambda e, cfg: DyTCScheduler(e, build_hierarchy(cfg)),
}
TREE_SCHEDULERS = ("tree", "dytc")     # they branch: refused on stacks with Mamba-2 blocks
MODES = ("chain_fused", "legacy", "tree_fused", "cascade_fused")


def parse_mesh(spec: str) -> dict:
    """``"model=K,data=D"`` -> ``{"data": D, "model": K}`` in the repo's axis
    order, with the reference's validation (``launch.mesh.parse_mesh_spec``)."""
    try:
        return parse_mesh_spec(spec)
    except ValueError as e:
        raise ValueError(f"bad --mesh {spec!r}: {e}") from None


def _emit_summary(summary: dict, args) -> None:
    """The one machine-readable last line (and the optional JSONL record)."""
    if args.metrics_jsonl:
        with JsonlSink(args.metrics_jsonl) as sink:
            sink.write(summary)
    print(json.dumps(summary, sort_keys=True))


def _mesh_rank(rank: int, world: int, cfg, args) -> None:
    """One rank of a ``--mesh`` run: its mesh, its params' shards, the loop."""
    device = rank_device(args.device, rank)
    sizes = parse_mesh(args.mesh)
    mesh = Mesh(tuple(sizes.values()), tuple(sizes), device=device)
    params = init_params(cfg, 0, device=device, mesh=mesh)
    run_batched(cfg, params, args, device, mesh)


def _run_mesh(cfg, args, device) -> None:
    """Start the ``--mesh`` ranks: this process as torchrun's rank,
    ``--spawn`` fresh ones, or, for a one-device mesh, the one-device
    server in this process."""
    sizes = parse_mesh(args.mesh)
    world = 1
    for n in sizes.values():
        world *= n
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"error: --mesh {args.mesh} needs {world} processes, torchrun "
                             f"started {os.environ['WORLD_SIZE']}")
        init_distributed(choose_backend(args.device, world),
                         device=rank_device(args.device, int(os.environ.get("LOCAL_RANK", rank))))
        _mesh_rank(rank, world, cfg, args)
    elif args.spawn:
        spawn(_mesh_rank, world, (cfg, args), device=args.device)
    elif world > 1:
        raise SystemExit(f"error: --mesh {args.mesh} runs {world} processes: launch them "
                         "with torchrun or pass --spawn")
    else:
        run_batched(cfg, init_params(cfg, 0, device=device), args, device, None)


def run_batched(cfg, params, args, device, mesh) -> None:
    """``--mesh`` path: continuous batching through ``ServeLoop`` on this
    rank of ``mesh`` (None: on the one device); rank 0 prints."""
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.scheduler import Request, RequestScheduler, ServeLoop
    from repro_torch.serving.server import BatchedSpecServer

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"mesh: {parse_mesh(args.mesh)} over {1 if mesh is None else mesh.size} devices")
    srv_kw: dict = {}
    if args.mode != "cascade_fused":
        srv_kw["draft_spec"] = layer_sparsity(cfg, 0.4)
    if args.temperature > 0.0:
        srv_kw["sampling"] = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                            top_p=args.top_p, seed=args.seed)
    if args.paged or args.prefill_chunk:
        # block-paged KV cache (and in-round chunked prefill): token-identical
        # to the dense path
        srv_kw.update(paged=True, page_size=args.page_size)
        if args.prefill_chunk:
            srv_kw["prefill_chunk"] = args.prefill_chunk
    srv = BatchedSpecServer(cfg, params, max_batch=args.batch, max_len=1024, mode=args.mode,
                            device=device, mesh=mesh, **srv_kw)
    endpoint = (MetricsHTTPServer(srv.metrics, port=args.metrics_port)
                if args.metrics_port is not None and lead else None)
    try:
        if endpoint is not None:
            print(f"metrics: {endpoint.url}")
        trace = TraceRecorder() if args.trace_out and lead else None
        sched = RequestScheduler(args.batch)
        for p in make_task_prompts(SPEC_TASKS[args.task], args.batch, cfg.vocab_size):
            sched.submit(Request(prompt=p, max_new_tokens=args.tokens))
        loop = ServeLoop(srv, sched, trace=trace)
        t0 = time.perf_counter()
        with profiler_trace(args.profile_dir if lead else None):
            while sched.busy:
                loop.step_once()
            srv.flush()
        dt = time.perf_counter() - t0  # port: noqa-PORT005: flush() read the last rounds
        tok = sum(len(r.generated) for r in sched.finished)
        say(f"mode={args.mode} mesh={args.mesh} requests={len(sched.finished)} "
            f"tokens={tok} time={dt:.2f}s ({dt / max(tok, 1) * 1e3:.1f} ms/tok)")
        if trace is not None:
            trace.save(args.trace_out)
            print(f"trace: {args.trace_out} (open in https://ui.perfetto.dev)")
    finally:
        if endpoint is not None:
            endpoint.close()
    summary = {
        "kind": "serve_summary",
        "mesh": args.mesh,
        "requests": len(sched.finished),
        "delivered_tokens": tok,
        "wall_s": dt,
        **srv.metrics_summary(),
    }
    if lead:
        _emit_summary(summary, args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="vicuna-7b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced width, with 8 layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu (plain versions)")
    ap.add_argument("--scheduler", default="dytc", choices=sorted(SCHEDULERS))
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--task", default="summarization", choices=sorted(SPEC_TASKS))
    ap.add_argument("--mesh", default=None,
                    help="'model=K,data=D' -> the mesh-sharded batched server (K*D ranks)")
    ap.add_argument("--spawn", action="store_true",
                    help="start the --mesh ranks as processes of this command (else torchrun)")
    ap.add_argument("--mode", default="chain_fused", choices=MODES,
                    help="batched server mode (with --mesh)")
    ap.add_argument("--batch", type=int, default=4, help="batch slots (with --mesh)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (batched path; 0 = greedy, the default; "
                         "lossless stochastic verify when > 0)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter for sampled serving (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass for sampled serving (1.0 = off)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base PRNG seed for sampled serving (per-request streams derive "
                         "from it and the admission order)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache (batched path; lossless)")
    ap.add_argument("--page-size", type=int, default=64, help="tokens per KV page (with --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help=">0: non-blocking admission; prompts prefill inside the single "
                         "rounds, this many tokens per round (implies --paged)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port (0 = ephemeral; batched path)")
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome trace-event JSON of the serving loop's phases here "
                         "(batched path)")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the run in torch.profiler, writing a Chrome trace here")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append the final summary record to this JSONL file")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), num_layers=8)
    # a larger mesh, a codebook stack, or a tree scheduler on a stack with
    # Mamba-2 blocks is refused before anything is built
    try:
        mesh_shape = parse_mesh(args.mesh) if args.mesh else None
        check_text_stack(cfg, f"--arch {args.arch}")
        if mesh_shape is None and args.scheduler in TREE_SCHEDULERS:
            check_tree_stack(cfg, f"--scheduler {args.scheduler}")
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    if mesh_shape is not None:
        _run_mesh(cfg, args, device)
        return
    params = init_params(cfg, 0, device=device)
    prompt = make_task_prompts(SPEC_TASKS[args.task], 1, cfg.vocab_size)[0]

    eng = SpecEngine(cfg, params, max_len=1024, device=device)
    eng.start(prompt)
    sched = SCHEDULERS[args.scheduler](eng, cfg)
    t0 = time.perf_counter()
    with profiler_trace(args.profile_dir):
        out = sched.generate(args.tokens)
    dt = time.perf_counter() - t0  # port: noqa-PORT005: each verify reads its verdict
    s = eng.stats
    print(f"scheduler={args.scheduler} tokens={len(out)} time={dt:.2f}s "
          f"({dt / len(out) * 1e3:.1f} ms/tok)")
    print("output:", out[:32], "..." if len(out) > 32 else "")
    summary = {
        "kind": "serve_summary",
        "scheduler": args.scheduler,
        "delivered_tokens": len(out),
        "wall_s": dt,
        "rounds": s["rounds"],
        "target_calls": s["target_calls"],
        "mean_accepted": s["accepted_tokens"] / max(s["rounds"], 1),
    }
    _emit_summary(summary, args)


if __name__ == "__main__":
    main()
