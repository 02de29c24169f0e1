#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card

Phase 1 prints the card, builds the hand-written kernels (one nvcc per
source, in parallel) and prints what was compiled: each kernel's
registers, shared memory and spill bytes (ptxas) and its count of each
tensor-core and async-copy instruction (cuobjdump, where the toolkit has
it). Phase 2 holds each kernel against its plain PyTorch version at the
main path's shapes (the paged flash decode also bitwise against the dense
kernel on the gathered view) and times kernel, plain version, a library
call and the bound, in float32 and bfloat16; the attention kernels and
their library calls both by CUDA events and by replaying a captured CUDA
graph; the W8A8 kernel bitwise at every row count of the decode path
and timed at M = 4, 16, 32, 64 in both MLP shapes; the tree kernel also
with a carried key segment at the draft's carry shapes, and the set_cond
kernel of a conditional graph node against the same segments run eagerly
with a host read. Phases 3-5 drive the
single-stream CAS-Spec path at vicuna-7b width with random weights: float32
AR vs DyTC token identity, the same in bfloat16, and decode_step through
the W8A8 kernel, with one quantized_matmul timed in its parts. Phase 6 drives
the batched server (tree_fused and chain_fused, dense and paged caches,
four slots) at the same width in float32 in split rounds, phase 7 in
single-dispatch rounds (one launch of a CUDA graph per round, the draft
and chunked prefill behind conditional nodes), and both hold every stream
to AR; phase 7 times the rounds that ran the draft apart from those that
skipped it, serves with carried and recomputed draft KV and with chunked
prefill of a prompt admitted mid-stream, profiles one launch of each kind
and a steady window of rounds. Phase 8 serves the multi-level cascade
(``cascade_fused``: the mixing hierarchy, whose int8 level runs the W8A8
kernel on weights quantized once, dense and paged; the scaling hierarchy)
and the per-step ``legacy`` baseline in split rounds, holds every stream
to AR and the dispatches per round to the server's own count, and times
one decode of the int8 drafter against float32 and against quantizing the
weights per call. Phase 9 serves sampled builds (temperature 0 against AR
in five modes, seeded stochastic streams twice, the key stream and the
warp on the card against the CPU). Phase 10 drives the serving entry
point: the seven single-stream baselines against AR; ``ServeLoop`` over
eight requests of the synthetic task suite on four slots in three modes,
every stream against AR and the round telemetry reconciled with the
delivered tokens; telemetry on against off; and, the model freed, the
``repro_torch.launch.serve`` CLI as two subprocesses. Phase 11 trains
vicuna-7b at full width and 8 layers in float32 through
``repro_torch.training`` (the reference benchmarks' recipe, 60 steps;
every loss finite, the last 5 steps' ce 1 nat below step 0's), times its
steps, round-trips the checkpoint bitwise, and serves the trained model
(AR, DyTC, ``ServeLoop``; every stream equal to AR) beside the same config
with random weights. Phase 12 drives the other attention-only models at
full width, one at a time: stablelm-1.6b (hd 64), starcoder2-3b (GQA rep
12, a 2-matrix GeLU MLP), gemma3-1b (hd 288, MQA, a mixed sliding/global
stack) and internlm2-20b (GQA rep 6, cut to 24 layers in float32): AR and
DyTC single stream and the batched server in single rounds, every stream
equal to AR; gemma3 also paged, with chunked prefill and past its
1024-token window; starcoder2's cascade on the W8A8 kernel; internlm2 at
all 48 layers in bfloat16. Phase 2 also holds and times the attention
kernels at those models' shapes. Phase 13 serves the MoE models at full
width through the grouped expert GEMM of the dropless dispatch:
qwen2-moe-a2.7b at all 24 layers in float32 (AR, DyTC, ``tree_fused``
single dense and paged, ``chain_fused`` split; every stream equal to AR)
and in bfloat16, and mixtral-8x22b cut to 4 layers (AR, DyTC,
``tree_fused`` single); phase 2 holds that kernel against its plain
version at both models' expert shapes, with experts of 1 to 130 rows about
its bfloat16 tiles (bitwise batch-invariant too), and times it beside
three yardsticks (in bfloat16 ``torch._grouped_mm``, the kernel's time
over its printed); phase 1 requires tensor-core (HGMMA) and TMA (UTMALDG)
instructions in its bfloat16 kernels. Phase 14 serves the Mamba-2 stacks at
full width, mamba2-130m at all 24 layers and jamba-v0.1-52b cut to one
8-layer unit, float32 then bfloat16: AR, PLD and SD single stream (with an
1100-token prompt whose SSD prefill spans five chunks), ``chain_fused``
single dense and paged, split and ``legacy`` on four slots, every float32
stream equal to AR, the tree schedulers and ``tree_fused`` refused; it
times one mamba layer's prefill and T=5 decode. Phase 15 drives the
codebook and image stacks at full width and trains the MoE, Mamba-2 and
codebook stacks: llava-next-mistral-7b at all 32 layers prefills 2880
image positions and 128 text tokens, takes 32 greedy steps over the
committed cache (held to fresh prefills; the flash decode held to its
plain version at that length) and serves text through AR, DyTC,
``tree_fused`` single dense and paged and the cascade, every stream equal
to AR; musicgen-medium at all 48 layers decodes (B, T, 4) codes, a T=5
joint decode equal to five single steps, and every speculative path
refuses it; mamba2-130m, qwen2-moe-a2.7b at 4 layers and musicgen-medium
each train 20 steps (finite losses, ce falling). Every captured single
round of phases 7, 9, 10 and 12-15 is held to its dispatch contracts
(``repro_torch.analysis.contracts``: the round graph walked node by node,
no host node or host transfer, each gated segment behind its IF node, each
segment's hand kernels as their wrappers counted, no collective, the cache
and state in place), and phase 10's telemetry on/off pair differs in the
tail segment only. Phase 16 drives the analysis layer: every GEMM of a
vicuna-7b layer and the unembedding at M = 1, 16, 64 and 128 in float32
and bfloat16, one layer's decode_step at T = 1, 16 and 64 and the 32-layer
target call at T = 16, each by graph replay beside its counted bound
(``repro_torch.analysis.costs``, the H100's roofline) and share; the BLR
latency predictor fitted on the target's and the LS0.5 draft's call times,
predicting two held-out T; the draft's c by the roofline, by graph replay
and by phase 3's wall time; and the contracts' summary. Phase 2's bounds
come from ``analysis.costs`` too. Phase 17 drives the mesh
(``repro_torch.launch.mesh``): the W8A8 and grouped expert kernels at the
shards' shapes against their plain versions; (a) vicuna-7b at 32 layers on
a one-rank NCCL mesh, ``tree_fused`` single rounds captured with their
collectives, held to phase 7's streams, rounds, graph launches and host
syncs and to the contracts; (b) vicuna-7b at model=2 as two gloo ranks
sharing the card (split ``tree_fused`` dense and ``chain_fused`` paged,
every stream against AR, 16 KV heads a rank, ms a round and the
collectives' share); (c) gemma3-1b at model=2, whose cache is
sequence-sharded: one context-parallel ``decode_attention`` within 1e-5
of the one-device call, split ``tree_fused`` streams against AR; (d) the
dry run's per-device table for four large configs on 1, 2 and 4 cards;
(e) model=2 over NCCL on a machine with two cards. Phase 18 drives
sharded training (``make_train_step`` under a mesh: FSDP over ``data``,
tensor parallelism over ``model``, rows over ``data``), float32, phase
11's batches, each run against the same steps on one device: (a)
vicuna-7b at 8 layers on a one-rank NCCL mesh, bitwise; (b) vicuna-7b at
2 layers as two gloo ranks sharing the card at data=2 and at model=2
(ce and grad_norm within 1e-5 and 1e-4 relative, the params by the
training tests' rule, each rank's bytes against the dry run's plan, ms a
step and the collectives' share); (c) qwen2-moe-a2.7b at 2 layers at
data=2, the MoE slot tables of both ranks gathered against the unsharded
table; (d) the dry run's training rows at train_4k; (e) (b) over NCCL on
a machine with two cards. Each phase prints its
seconds and the memory left allocated after it. The last line is the
JSON device record; the line before it lists the kernels, with the
launches of phases 3, 5-15 and 17 (graph launches counted by the server,
a gated segment's only in the rounds that ran it; phase 17's of every
rank); the grouped expert GEMM has a row for each of its two kernels
(``moe_grouped`` float32, ``moe_grouped_bf16`` bfloat16).
Exits non-zero,
with no result, when any phase fails or when no CUDA device (or no
repro_torch beside this script) is present.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

TOL = {"attention": 1e-4, "int8": 0.0, "int8_decode_logits": 1e-3, "moe": 1e-4}
MAIN_PATH_S = 160                  # longest live cache prefix of phases 3-4


# ------------------------------------------------------------------ timing
def _time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around each call, with
    the L2 cache flushed before every call (the main path meets cold KV)."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _graph_ms(fn, flush, iters: int = 20) -> float:
    """Mean device time of one replay of a CUDA graph holding ``fn``'s
    launches, L2 flushed before every replay: the kernels' time without the
    host's launch gaps."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    total = 0.0
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del graph
    return total / iters


def _device_ms(fn, flush, kernel: str, iters: int = 20) -> float:
    """Mean device time of the launches of ``kernel`` (a substring of the
    kernel's name) in ``fn``, from the profiler's CUDA activity records, L2
    flushed before every call: the kernel alone, without launch gaps. The
    profiler may drop a few records; the mean is over those it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.self_device_time_total
            count += e.count
    if count == 0:
        raise AssertionError(f"the profiler recorded no launch of {kernel}")
    return total / count / 1e3


def _busy_ms(fn, iters: int = 5) -> float:
    """Mean device time of all the kernels one call of ``fn`` launches, from
    the profiler's CUDA activity records (after 2 warm-up calls): the
    device's share of the call, without the host's launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / iters / 1e3


def _timings(kernel, plain, library, flush, bound: float, by: str) -> dict:
    """A kernel's times beside its plain version's and its library
    yardstick's: the kernel and the yardstick both by CUDA events and by
    CUDA-graph replay (like with like), the plain version by events."""
    return dict(ms=_time_ms(kernel, flush), graph_ms=_graph_ms(kernel, flush),
                plain_ms=_time_ms(plain, flush), library_ms=_time_ms(library, flush),
                library_graph_ms=_graph_ms(library, flush), bound_ms=bound, bound_by=by)


def _timing_text(tm: dict, library: str) -> str:
    return (f"kernel {tm['ms']:.4f} ms (graph replay {tm['graph_ms']:.4f} ms)  plain "
            f"{tm['plain_ms']:.4f} ms  {library} {tm['library_ms']:.4f} ms (graph replay "
            f"{tm['library_graph_ms']:.4f} ms)  bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), "
            f"graph/bound {tm['graph_ms'] / tm['bound_ms']:.1f}x, library graph/kernel graph "
            f"{tm['library_graph_ms'] / tm['graph_ms']:.2f}")


# ------------------------------------------------------------------ phase 1
def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda})")
    for name in _build.SOURCES:
        for func, info in _compile_report(_build, name).items():
            print(f"  {name}: {func}: " + ", ".join(f"{k} {v}" for k, v in info.items()))
            if name == "int8_matmul" and "int8_mm_kernel" in func and (
                    info.get("spill_stores", 0) or info.get("spill_loads", 0)
                    or info.get("IMMA", 1) == 0 or info.get("LDGSTS", 1) == 0):
                raise AssertionError(f"{func}: spills, or no IMMA / LDGSTS in its SASS: {info}")
            if name == "moe_grouped" and "grouped_kernel<float" in func and info.get("LDGSTS", 1) == 0:
                raise AssertionError(f"{func}: no LDGSTS (cp.async) in its SASS: {info}")
            if name == "moe_grouped" and "grouped_wgmma_kernel" in func and (
                    info.get("HGMMA", 1) == 0 or info.get("UTMALDG", 1) == 0):
                raise AssertionError(f"{func}: no HGMMA (wgmma) or UTMALDG (TMA) in its SASS: {info}")
    return {"smi": smi}


SASS_OPS = ("HMMA", "HGMMA", "IMMA", "LDGSTS", "UTMALDG")   # tensor-core products, async copies


def _demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    return dict(zip(names, out.splitlines()))


def _compile_report(_build, name: str) -> dict:
    """Per kernel of ``csrc/<name>.cu``: what ``ptxas -v`` reported
    (registers, shared memory, spill bytes) and, where the toolkit has
    ``cuobjdump``, how many of each tensor-core and async-copy instruction
    (``SASS_OPS``) its SASS holds: evidence of what the compiled code runs on."""
    import re

    info: dict = {}
    log = _build.BUILD / f"{name}.log"
    func = None
    for line in (log.read_text().splitlines() if log.exists() else ()):
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            func = m.group(1)
            info.setdefault(func, {})
        elif func and (m := re.search(r"Used (\d+) registers", line)):
            info[func]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                info[func]["static_smem_bytes"] = int(m.group(1))
        elif func and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            info[func].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True).stdout
        func = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                func = m.group(1)
                info.setdefault(func, {})
                info[func].update({op: 0 for op in SASS_OPS})
            elif func:
                for op in SASS_OPS:
                    if re.search(rf"\b{op}\b", line):
                        info[func][op] += 1
    names = _demangle(list(info))
    short = lambda n: n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]  # noqa: E731
    return {short(names[f]): v for f, v in info.items()}


# ------------------------------------------------------------------ phase 2
def _attn_inputs(torch, gen, B, KV, R, T, S, hd, dtype, pos):
    dev = "cuda"
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    q = mk(B, KV, R, hd)
    kc, vc = mk(B, S, KV, hd), mk(B, S, KV, hd)        # cache layout (B, S, KV, hd)
    kn, vn = mk(B, T, KV, hd), mk(B, T, KV, hd)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    kv_pos = torch.where(slots < pos, slots, torch.full_like(slots, -1)).contiguous()
    q_pos = (pos + torch.arange(R, device=dev, dtype=torch.int32) % T)[None].repeat(B, 1)
    q_pos[:, 0] = -1                                    # a fully masked row
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
    if T >= 4:
        tm[3, 2] = False                                # a branch
    tmask = tm[None].expand(B, T, T).contiguous()
    return q, kc, vc, kv_pos, q_pos, kn, vn, tmask


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel(a, b) -> float:
    """Max abs error relative to the largest magnitude of the plain result."""
    return _err(a, b) / max(float(b.float().abs().max()), 1e-30)


def _paged_inputs(torch, gen, B, KV, T, P, n_pp, dtype, pos, hd=128, rep=1):
    """Paged verify inputs: pools (NP, P, KV, hd) in the model's layout with
    two spare pages, a scrambled table whose last batch row ends in -1
    entries, kv_pos from ``pos`` (B,) (partial tail pages); ``rep`` * T
    query rows per kv head."""
    dev = "cuda"
    NP = B * n_pp + 2
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    q = mk(B, KV, rep * T, hd)
    k_pages, v_pages = mk(NP, P, KV, hd), mk(NP, P, KV, hd)
    perm = torch.randperm(NP, generator=gen, device=dev).to(torch.int32)
    table = perm[: B * n_pp].reshape(B, n_pp).contiguous()
    n_last = -(-int(pos[-1]) // P)
    table[-1, n_last:] = -1                              # an unallocated tail
    S = n_pp * P
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    pos_t = torch.as_tensor(pos, device=dev, dtype=torch.int32)[:, None]
    kv_pos = torch.where(slots < pos_t, slots, torch.full_like(slots, -1)).contiguous()
    q_pos = (pos_t + torch.arange(T, device=dev, dtype=torch.int32)[None]).repeat(1, rep)
    kn, vn = mk(B, T, KV, hd), mk(B, T, KV, hd)
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
    tm[3, 2] = False
    return q, k_pages, v_pages, table, kv_pos, q_pos, kn, vn, tm[None].expand(B, T, T).contiguous()


def _paged_kernel(torch, gen, flush, results: dict) -> None:
    """The paged flash decode (#4): against its plain version and bitwise
    against the dense kernel on the gathered view, at the agreement shapes
    and at the server's, where it is also timed."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    F = torch.nn.functional
    tol, worst = TOL["attention"], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for P, n_pp, pos in ((16, 7, (100, 37)), (64, 5, (300, 130))):
            for kind, window in (("causal", 0), ("window", 40), ("streaming", 40)):
                q, kp, vp, table, kv_pos, q_pos, *_ = _paged_inputs(
                    torch, gen, 2, 4, 32, P, n_pp, dtype, pos)
                kw = dict(kind=kind, window=window, sink=4)
                got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, **kw)
                want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, **kw)
                k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
                dense = fd.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(g, d) for g, d in zip(got, dense))
                out_g, out_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
                e = _err(out_g, out_w)
                e_m = _err(got[1], want[1])
                e_l = float(((got[2] - want[2]).abs() / want[2]).max())
                print(f"[phase 2] flash_decode paged {str(dtype)[6:]:8s} P={P:2d} {kind:9s} "
                      f"out err abs={e:.3e} rel={_rel(out_g, out_w):.3e} m err={e_m:.3e} "
                      f"l rel err={e_l:.3e} bitwise dense on gathered view={bitwise}")
                if not (e <= tol and e_m <= tol and e_l <= tol and bitwise):
                    raise AssertionError(f"paged flash decode disagrees ({dtype}, P={P}, {kind})")
                worst = max(worst, e)

    # the server's shapes (phase 6): B=4, KV=32, P=64, a live prefix of 4
    # pages, T=16 rows (tree_fused's bucket) and T=5 (chain_fused's k+1),
    # slots of unequal length, the shortest ending in -1 entries; then T=32
    # over 32 pages (S=2048), a longer context than phase 6 reaches
    B, KV, P, hd = 4, 32, 64, 128
    timing = {}
    for T, n_pp, pos in ((16, 4, (232, 168, 104, 40)), (5, 4, (232, 168, 104, 40)),
                         (32, 32, (2016,) * 4)):
        S = n_pp * P
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, kv_pos, q_pos, kn, vn, tmask = _paged_inputs(
                torch, gen, B, KV, T, P, n_pp, dtype, pos)
            kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
            kd, vd = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
            got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
            want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
            dense = fd.flash_decode_partial(q, kd, vd, kv_pos, q_pos)
            tree = ta.tree_attention_partial(q, kt, vt, tmask)
            got_m = fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree)
            want_m = ref.merge_partials(want, tree)
            dense_m = fd.flash_decode_merge(q, kd, vd, kv_pos, q_pos, tree)
            torch.cuda.synchronize()
            bitwise = (all(torch.equal(g, d) for g, d in zip(got, dense))
                       and torch.equal(got_m, dense_m))
            out_g, out_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
            e = max(_err(out_g, out_w), _err(got_m, want_m))
            e_m = _err(got[1], want[1])
            e_l = float(((got[2] - want[2]).abs() / want[2]).max())
            e_dense = _err(dense_m, want_m)
            name = f"{str(dtype)[6:]} B={B} T={T} {n_pp} pages of {P}"
            print(f"[phase 2] flash_decode paged {name} (S={S}): out err abs={e:.3e} "
                  f"rel={_rel(got_m, want_m):.3e} m err={e_m:.3e} l rel err={e_l:.3e}; dense kernel "
                  f"on the gathered view err abs={e_dense:.3e}, bitwise equal to paged={bitwise}")
            if not (e <= tol and e_m <= tol and e_l <= tol and e_dense <= tol and bitwise):
                raise AssertionError(f"paged flash decode disagrees ({name})")
            worst = max(worst, e)
            run = lambda: fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree)  # noqa: E731
            # the dense kernel over the gathered view: what reading through the table costs
            dense = lambda: fd.flash_decode_merge(q, kd, vd, kv_pos, q_pos, tree)  # noqa: E731
            dense_ms, dense_graph = _time_ms(dense, flush), _graph_ms(dense, flush)
            plain = lambda: ref.merge_partials(  # noqa: E731
                ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos), tree)
            # library yardstick: index_select gather + SDPA with an explicit mask
            am = torch.cat([ref.visible(q_pos, kv_pos, "causal", 0, 0), tmask], dim=-1)[:, None]
            idx = table.clamp_min(0).flatten()

            def library():
                kg = kp.index_select(0, idx).reshape(B, S, KV, hd)
                vg = vp.index_select(0, idx).reshape(B, S, KV, hd)
                ks = torch.cat([kg, kn], dim=1).transpose(1, 2)
                vs = torch.cat([vg, vn], dim=1).transpose(1, 2)
                return F.scaled_dot_product_attention(q, ks, vs, attn_mask=am)

            # the least work this data needs: each slot's live rows, read once
            live = sum(pos)
            cost = C.flash_decode(B, KV, T, hd, S, dtype, live=live, merge=True, pages=n_pp)
            nbytes = cost.bytes_hbm
            bound, by = cost.bound_ms()
            tm = _timings(run, plain, library, flush, bound, by)
            timing[(str(dtype)[6:], T, n_pp)] = tm
            del kd, vd
            print(f"[phase 2] flash_decode paged merge {name} (S={S}, {live} live rows): "
                  + _timing_text(tm, "gather+sdpa")
                  + f"  dense kernel on the gathered view {dense_ms:.4f} ms (graph replay "
                  f"{dense_graph:.4f} ms)  ({nbytes / 1e6:.2f} MB)")
    results["flash_decode_paged"] = dict(max_abs_err=worst, **timing[("float32", 16, 4)])


def _bounded_kernels(torch, gen, flush) -> None:
    """Flash decode (#1, #4) reading its live length on the device: a dense
    and a paged launch over the whole cache with ``bound`` (the committed
    lengths, as the model passes the cache's pos) held bitwise against a
    dense launch over the cache cut on the host to L = max(pos), partials
    and merged output, at the main path's verify (B=1, T=32, 160 live slots
    of 2048) and the server's (B=4, T=16 and T=5, slots of 232/168/104/40
    over 1024), in float32 and bfloat16; the merged launches of the two
    float32 server shapes timed by graph replay beside the cut one."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    B1, SRV = (160,), (232, 168, 104, 40)
    for B, T, n_pp, pos in ((1, 32, 32, B1), (4, 16, 16, SRV), (4, 5, 16, SRV)):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, kv_pos, q_pos, kn, vn, tmask = _paged_inputs(
                torch, gen, B, 32, T, 64, n_pp, dtype, pos)
            bound = torch.tensor(pos, dtype=torch.int32, device="cuda")
            L = max(pos)
            k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
            cut = (k[:, :, :L], v[:, :, :L], kv_pos[:, :L].contiguous(), q_pos)
            tree = ta.tree_attention_partial(q, kn.transpose(1, 2), vn.transpose(1, 2), tmask)
            runs = {
                "cut": lambda: fd.flash_decode_merge(q, *cut, tree),
                "dense": lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree, bound=bound),
                "paged": lambda: fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree,
                                                             bound=bound),
            }
            want = fd.flash_decode_partial(q, *cut)
            parts = (fd.flash_decode_partial(q, k, v, kv_pos, q_pos, bound=bound),
                     fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, bound=bound))
            merged = {name: fn() for name, fn in runs.items()}
            torch.cuda.synchronize()
            bitwise = (all(torch.equal(g, w) for got in parts for g, w in zip(got, want))
                       and torch.equal(merged["dense"], merged["cut"])
                       and torch.equal(merged["paged"], merged["cut"]))
            name = f"{str(dtype)[6:]} B={B} T={T} {L} live of {n_pp * 64}"
            text = ""
            if dtype == torch.float32 and B == 4:
                ms = {n: _graph_ms(fn, flush) for n, fn in runs.items()}
                text = "; graph replay ms: " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
            print(f"[phase 2] flash_decode bounded on the device {name}: dense and paged over "
                  f"the whole cache bitwise equal to the host cut (partials and merge)={bitwise}"
                  + text)
            if not bitwise:
                raise AssertionError(f"a device-bounded flash decode differs from the host cut ({name})")


# the other models' attention shapes (phase 12): (model, B, KV, rep, T, S,
# hd, mask kind, window, pages of 64 or 0)
MODEL_SHAPES = (
    ("stablelm-1.6b", 1, 32, 1, 16, 160, 64, "causal", 0, 0),
    ("stablelm-1.6b", 1, 32, 1, 16, 2048, 64, "causal", 0, 0),
    ("stablelm-1.6b", 1, 32, 1, 32, 160, 64, "causal", 0, 0),
    ("stablelm-1.6b", 1, 32, 1, 32, 2048, 64, "causal", 0, 0),
    ("gemma3-1b", 1, 1, 4, 16, 2048, 288, "window", 1024, 0),
    ("gemma3-1b", 1, 1, 4, 16, 2048, 288, "window", 1024, 32),
    ("internlm2-20b", 1, 8, 6, 32, 2048, 128, "causal", 0, 0),
    ("starcoder2-3b", 1, 2, 12, 32, 2048, 128, "causal", 0, 0),
)


def _model_shape_kernels(torch, gen, flush) -> dict:
    """Flash decode (#1, or #4 over pages), merged with the tree partials,
    and tree attention (#2) at the other models' shapes (``MODEL_SHAPES``:
    hd 64; hd 288 at MQA rep 4 with gemma3's window of 1024 over a cache of
    2048, dense and over 32 pages of 64; hd 128 at GQA rep 6 and 12), each
    against its plain twin, in float32 and bfloat16, timed by CUDA events
    and graph replay beside the bound and SDPA over [cache ++ staged] with
    the same mask (after an ``index_select`` gather when paged). The bound
    counts the slots some row sees (the window's, not the whole cache) and
    each row's visible slots' products. Returns the largest error of each
    kernel."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    F = torch.nn.functional
    tol = TOL["attention"]
    worst = dict.fromkeys(("flash_decode", "flash_decode_paged", "tree_attention"), 0.0)
    for model, B, KV, rep, T, S, hd, kind, window, n_pp in MODEL_SHAPES:
        R = rep * T
        for dtype in (torch.float32, torch.bfloat16):
            kw = dict(kind=kind, window=window)
            if n_pp:
                q, kp, vp, table, kv_pos, q_pos, kn, vn, tmask = _paged_inputs(
                    torch, gen, B, KV, T, S // n_pp, n_pp, dtype, (S - T,) * B, hd=hd, rep=rep)
                k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
                idx = table.clamp_min(0).flatten()
                kc_fn = lambda: (kp.index_select(0, idx).reshape(B, S, KV, hd),  # noqa: E731
                                 vp.index_select(0, idx).reshape(B, S, KV, hd))
                run = lambda: fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos,  # noqa: E731
                                                          tree, **kw)
            else:
                q, kc, vc, kv_pos, q_pos, kn, vn, tmask = _attn_inputs(
                    torch, gen, B, KV, R, T, S, hd, dtype, S - T)
                q_pos[:, 0] = S - T                        # verify rows see the cache
                k, v = kc.transpose(1, 2), vc.transpose(1, 2)
                kc_fn = lambda: (kc, vc)  # noqa: E731
                run = lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree, **kw)  # noqa: E731
            kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
            tree = ta.tree_attention_partial(q, kt, vt, tmask)
            want_t = ref.tree_attention_partial(q, kt, vt, tmask)
            got = run()
            want = ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kt, vt, tmask, **kw)
            torch.cuda.synchronize()
            e_t = _err(tree[0] / tree[2][..., None], want_t[0] / want_t[2][..., None])
            e = _err(got, want)
            dt = str(dtype)[6:]
            name = (f"{model} {dt} hd={hd} KV={KV} rep={rep} T={T} S={S}"
                    + (f" {kind} {window}" if window else "") + (f", {n_pp} pages of {S // n_pp}"
                                                                  if n_pp else ""))
            print(f"[phase 2] {name}: merged verify err abs={e:.3e} rel={_rel(got, want):.3e}; "
                  f"tree partials out err abs={e_t:.3e}")
            if not (e <= tol and e_t <= tol):
                raise AssertionError(f"attention at {name} disagrees with its plain version")
            fd_name = "flash_decode_paged" if n_pp else "flash_decode"
            worst[fd_name] = max(worst[fd_name], e)
            worst["tree_attention"] = max(worst["tree_attention"], e_t)
            # SDPA over the same function: one "head" per kv head with its R rows
            vis = ref.visible(q_pos, kv_pos, kind, window, 0)               # (B, R, S)
            t_rows = tmask.repeat(1, rep, 1)                                # (B, R, T)
            am = torch.cat([vis, t_rows], dim=-1)[:, None]

            def library():
                kg, vg = kc_fn()
                ks = torch.cat([kg, kn], dim=1).transpose(1, 2)
                vs = torch.cat([vg, vn], dim=1).transpose(1, 2)
                return F.scaled_dot_product_attention(q, ks, vs, attn_mask=am)

            seen = int(vis.any(dim=1).sum())                                # slots some row sees
            bound, by = C.flash_decode(B, KV, R, hd, S, dtype, live=seen, visible=int(vis.sum()),
                                       merge=True, pages=n_pp).bound_ms()
            plain = lambda: ref.merge_partials(  # noqa: E731
                ref.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw), tree)
            tm = _timings(run, plain, library, flush, bound, by)
            print(f"[phase 2] {name}: flash_decode{'_paged' if n_pp else ''} merge "
                  + _timing_text(tm, "sdpa"))
            tbound, tby = C.tree_attention(B, KV, R, T, hd, dtype, pairs=int(tmask.sum())).bound_ms()
            ks_t, vs_t = kt.contiguous(), vt.contiguous()
            tt = _timings(lambda: ta.tree_attention_partial(q, kt, vt, tmask),
                          lambda: ref.tree_attention_partial(q, kt, vt, tmask),
                          lambda: F.scaled_dot_product_attention(q, ks_t, vs_t,
                                                                 attn_mask=t_rows[:, None]),
                          flush, tbound, tby)
            print(f"[phase 2] {name}: tree_attention " + _timing_text(tt, "sdpa"))
    return worst


# chain and tree steps, the cascade drafter's carry steps (8) and seed block
# (128), verifies, ragged row tiles
W8A8_ROWS = (1, 4, 8, 16, 17, 20, 32, 40, 64, 96, 128)
W8A8_TIMED_ROWS = (4, 16, 32, 64)
W8A8_SHAPES = ((4096, 11008), (11008, 4096))      # the MLP's gate/up and down products


def _int8_operands(torch, gen, M, K, N):
    x_q = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand(M, 1, generator=gen, device="cuda") / 127
    ws = torch.rand(1, N, generator=gen, device="cuda") / 127
    return x_q, w_q, xs, ws


def _int_mm_rows(torch, x_q, w_q):
    """x_q as ``torch._int_mm`` takes it: zero rows appended up to 17 where
    its CUDA path refuses M <= 16 (the padded rows are computed and cut)."""
    try:
        torch._int_mm(x_q, w_q)
        return x_q
    except RuntimeError:
        pad = torch.zeros(17 - x_q.shape[0], x_q.shape[1], dtype=x_q.dtype, device=x_q.device)
        return torch.cat([x_q, pad])


def _w8a8_kernel(torch, gen, flush_buf) -> dict:
    """The W8A8 kernel (#3) bitwise against its plain version at every row
    count of the decode path, in both MLP shapes and a small one whose last
    column strip ends half way, and under a forced plan that splits K into
    uneven ranges; then timed at M = 4, 16, 32, 64 in both MLP shapes beside
    its byte bound and ``torch._int_mm`` with the same scale epilogue, and
    by the profiler's kernel time after the usual flush (a 256 MB write, whose
    dirty lines the kernel's reads evict) and after a read of the buffer
    (clean L2)."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ref

    worst = 0.0
    for K, N in W8A8_SHAPES + ((256, 192),):
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        ws = torch.rand(1, N, generator=gen, device="cuda") / 127
        for M in W8A8_ROWS:
            x_q, _, xs, _ = _int8_operands(torch, gen, M, K, 64)
            got = i8.int8_matmul(x_q, w_q, xs, ws)
            want = ref.ref_int8_matmul(x_q, w_q, xs, ws)
            forced = i8._launch(x_q, w_q, xs, ws, 16, min(7, K // 64))
            torch.cuda.synchronize()
            e = max(_err(got, want), _err(forced, want))
            bm, splits = i8.card_plan(M, K, N, 0)
            print(f"[phase 2] int8_matmul ({M},{K})x({K},{N}) row tile {bm}, {splits} K splits, "
                  f"{-(-M // bm) * -(-N // i8.STRIP) * splits} CTAs: err abs={e:.3e} "
                  f"bitwise={torch.equal(got, want)}; forced 16-row tiles and "
                  f"{min(7, K // 64)} splits bitwise={torch.equal(forced, want)}")
            if e > TOL["int8"] or not (torch.equal(got, want) and torch.equal(forced, want)):
                raise AssertionError(f"int8_matmul disagrees at ({M},{K},{N})")
            worst = max(worst, e)

    flush = flush_buf.zero_
    clean = flush_buf.view(torch.float32).sum
    one = torch.zeros(1, device="cuda")
    print(f"[phase 2] graph replay of a one-element add, the floor of a graph-replay time: "
          f"{_graph_ms(lambda: one.add_(1), flush):.4f} ms")
    timing = {}
    for K, N in W8A8_SHAPES:
        for M in W8A8_TIMED_ROWS:
            x_q, w_q, xs, ws = _int8_operands(torch, gen, M, K, N)
            x_lib = _int_mm_rows(torch, x_q, w_q)
            bound, by = C.int8_matmul(M, K, N).bound_ms()
            tm = _timings(lambda: i8.int8_matmul(x_q, w_q, xs, ws),
                          lambda: ref.ref_int8_matmul(x_q, w_q, xs, ws),
                          lambda: torch._int_mm(x_lib, w_q)[:M].float() * xs * ws, flush, bound, by)
            kernel = lambda: i8.int8_matmul(x_q, w_q, xs, ws)  # noqa: E731
            tm.update(device_ms=_device_ms(kernel, flush, "int8_mm_kernel"),
                      device_clean_ms=_device_ms(kernel, clean, "int8_mm_kernel"))
            timing[(M, K, N)] = tm
            padded = f" (rows padded to {x_lib.shape[0]})" if x_lib.shape[0] != M else ""
            print(f"[phase 2] int8_matmul ({M},{K})x({K},{N}) " + _timing_text(tm, "_int_mm+scale")
                  + padded + f"  kernel device time {tm['device_ms']:.4f} ms ({tm['device_ms'] / bound:.2f}x "
                  f"bound), clean L2 {tm['device_clean_ms']:.4f} ms ({tm['device_clean_ms'] / bound:.2f}x)")
    return dict(max_abs_err=worst, **timing[(32, 4096, 11008)])


def phase_kernels(torch, results: dict) -> None:
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    F = torch.nn.functional
    _paged_kernel(torch, gen, flush, results)
    _bounded_kernels(torch, gen, flush)
    other_worst = _model_shape_kernels(torch, gen, flush)
    results["flash_decode_paged"]["max_abs_err"] = max(results["flash_decode_paged"]["max_abs_err"],
                                                       other_worst["flash_decode_paged"])
    B, KV, hd, S, pos, window, sink = 1, 32, 128, 2048, 1500, 256, 4
    tol = TOL["attention"]

    # --- flash decode (#1): partials for every kind, dtype and T
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T in (1, 5, 16, 32):           # decode, chain verify, tree buckets
            for kind in ("causal", "window", "streaming"):
                q, kc, vc, kv_pos, q_pos, *_ = _attn_inputs(torch, gen, B, KV, T, T, S, hd, dtype, pos)
                k, v = kc.transpose(1, 2), vc.transpose(1, 2)
                kw = dict(kind=kind, window=window, sink=sink)
                got = fd.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw)
                want = ref.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw)
                torch.cuda.synchronize()
                out_g, out_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
                e_out, r_out = _err(out_g, out_w), _rel(out_g, out_w)
                e_m = _err(got[1], want[1])
                e_l = float(((got[2] - want[2]).abs() / want[2]).max())
                print(f"[phase 2] flash_decode partial {str(dtype)[6:]:8s} T={T:2d} {kind:9s} "
                      f"out err abs={e_out:.3e} rel={r_out:.3e} m err={e_m:.3e} l rel err={e_l:.3e}")
                if not (e_out <= tol and e_m <= tol and e_l <= tol):
                    raise AssertionError(f"flash_decode partial disagrees ({dtype}, T={T}, {kind})")
                worst = max(worst, e_out)

    # --- GQA with several 32-row tiles and two sequences (rep 8, T 8 -> R 64),
    # a ragged S: layouts later slices use, checked for agreement only
    for dtype in (torch.float32, torch.bfloat16):
        q, kc, vc, kv_pos, q_pos, kn, vn, tmask = _attn_inputs(torch, gen, 2, 8, 64, 8, 300, hd, dtype, 250)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
        tree = ta.tree_attention_partial(q, kt, vt, tmask)
        got = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
        want = ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kt, vt, tmask)
        torch.cuda.synchronize()
        e = _err(got, want)
        print(f"[phase 2] GQA verify (B=2, KV=8, R=64, S=300) {str(dtype)[6:]:8s} err abs={e:.3e} "
              f"rel={_rel(got, want):.3e}")
        if e > tol:
            raise AssertionError(f"GQA verify disagrees ({dtype})")
        worst = max(worst, e)

    # --- flash decode merged with the tree partials, at the verify shape:
    # S = 160 is the longest live cache prefix the main path reads (a 128-token
    # prompt + 32 generated), S = 2048 the whole allocation
    T = 32
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S_live in (MAIN_PATH_S, S):
            q, kc, vc, kv_pos, q_pos, kn, vn, tmask = _attn_inputs(
                torch, gen, B, KV, T, T, S_live, hd, dtype, S_live - T)
            q_pos[:, 0] = S_live - T                        # verify rows see the cache
            k, v = kc.transpose(1, 2), vc.transpose(1, 2)
            kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
            tree = ref.tree_attention_partial(q, kt, vt, tmask)
            got = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
            want = ref.merge_partials(ref.flash_decode_partial(q, k, v, kv_pos, q_pos), tree)
            full = ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kt, vt, tmask)
            torch.cuda.synchronize()
            e = max(_err(got, want), _err(got, full))
            name = f"{str(dtype)[6:]}_S{S_live}"
            print(f"[phase 2] flash_decode merge   {name:14s} T={T} err abs={e:.3e} rel={_rel(got, full):.3e}")
            if e > tol:
                raise AssertionError(f"flash_decode merge disagrees ({name})")
            worst = max(worst, e)
            # library yardstick: SDPA over [cache ++ staged] with an explicit mask
            qs = q.reshape(B, KV, T, hd)
            ks = torch.cat([kc, kn], dim=1).transpose(1, 2).contiguous()
            vs = torch.cat([vc, vn], dim=1).transpose(1, 2).contiguous()
            am = torch.cat([ref.visible(q_pos, kv_pos, "causal", 0, 0), tmask], dim=-1)[:, None]
            bound, by = C.flash_decode(B, KV, T, hd, S_live, dtype, merge=True).bound_ms()
            timing[name] = _timings(
                lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree),
                lambda: ref.merge_partials(ref.flash_decode_partial(q, k, v, kv_pos, q_pos), tree),
                lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), flush, bound, by)
            print(f"[phase 2] flash_decode merge   {name:14s} " + _timing_text(timing[name], "sdpa"))
    results["flash_decode"] = dict(max_abs_err=max(worst, other_worst["flash_decode"]),
                                   **timing[f"float32_S{MAIN_PATH_S}"])

    # --- tree attention (#2)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for T in (5, 8, 16, 32):               # chain verify, buckets of 8, 16, 32
            q, _, _, _, _, kn, vn, tmask = _attn_inputs(torch, gen, B, KV, T, T, 8, hd, dtype, 0)
            kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
            tmask[:, 1] = False                             # a fully masked tree row
            got = ta.tree_attention_partial(q, kt, vt, tmask)
            want = ref.tree_attention_partial(q, kt, vt, tmask)
            torch.cuda.synchronize()
            out_g, out_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
            e = _err(out_g, out_w)
            e_m = _err(got[1], want[1])
            e_l = float(((got[2] - want[2]).abs() / want[2]).max())
            print(f"[phase 2] tree_attention   {str(dtype)[6:]:8s} T={T:2d} out err abs={e:.3e} "
                  f"rel={_rel(out_g, out_w):.3e} m err={e_m:.3e} l rel err={e_l:.3e}")
            if not (e <= tol and e_m <= tol and e_l <= tol):
                raise AssertionError(f"tree_attention disagrees ({dtype}, T={T})")
            worst = max(worst, e)
            if T == 32:
                name = str(dtype)[6:]
                qs = q.reshape(B, KV, T, hd)
                ks, vs = kt.contiguous(), vt.contiguous()
                bound, by = C.tree_attention(B, KV, T, T, hd, dtype,
                                             pairs=int(tmask.sum())).bound_ms()
                timing[name] = _timings(
                    lambda: ta.tree_attention_partial(q, kt, vt, tmask),
                    lambda: ref.tree_attention_partial(q, kt, vt, tmask),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=tmask[:, None]),
                    flush, bound, by)
                print(f"[phase 2] tree_attention   {name:8s} " + _timing_text(timing[name], "sdpa"))
    worst = max(worst, _carried_tree_kernel(torch, gen, flush, timing))
    results["tree_attention"] = dict(max_abs_err=max(worst, other_worst["tree_attention"]),
                                     **timing["float32"])

    # --- set_cond: the conditional node of the captured round
    results["set_cond"] = _set_cond_kernel(torch, flush)

    # --- W8A8 (#3)
    results["int8_matmul"] = _w8a8_kernel(torch, gen, flush_buf)

    # --- the grouped expert GEMM of the MoE dispatch (not a TPU kernel)
    results.update(_moe_kernel(torch, gen, flush))
    del flush_buf


def _carried_tree_kernel(torch, gen, flush, timing: dict) -> float:
    """The tree kernel with a carried key segment (``draft_kv="carry"``) at
    the draft's shapes: 4 slots of 32 heads, a tree step's 2 new nodes over
    the 16-node bucket's carried rows and a chain step's 1 token over its
    5, strided views of the (B, N, KV, hd) buffers, a row that sees no
    carried key; against the plain version, and timed at the tree step
    beside SDPA over [carried ++ new] with the explicit mask. Returns the
    worst error."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    F = torch.nn.functional
    B, KV, hd, tol, worst = 4, 32, 128, TOL["attention"], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T, N_s in ((2, 16), (1, 5)):
            mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
            q = mk(B, KV, T, hd)
            kt, vt = (mk(B, T, KV, hd).transpose(1, 2) for _ in range(2))
            ks, vs = (mk(B, N_s, KV, hd).transpose(1, 2) for _ in range(2))
            tmask = torch.eye(T, dtype=torch.bool, device="cuda")[None].expand(B, T, T).contiguous()
            smask = torch.rand(B, T, N_s, generator=gen, device="cuda") < 0.6
            smask[0, 0] = False
            seg2 = dict(k_staged=ks, v_staged=vs, staged_mask=smask)
            got = ta.tree_attention_partial(q, kt, vt, tmask, **seg2)
            want = ref.tree_attention_partial(q, kt, vt, tmask, **seg2)
            torch.cuda.synchronize()
            out_g, out_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
            e, e_m = _err(out_g, out_w), _err(got[1], want[1])
            e_l = float(((got[2] - want[2]).abs() / want[2]).max())
            name = f"{str(dtype)[6:]} carry T={T} N_s={N_s}"
            print(f"[phase 2] tree_attention   {name}: out err abs={e:.3e} rel={_rel(out_g, out_w):.3e} "
                  f"m err={e_m:.3e} l rel err={e_l:.3e}")
            if not (e <= tol and e_m <= tol and e_l <= tol):
                raise AssertionError(f"tree_attention with a carried segment disagrees ({name})")
            worst = max(worst, e)
            if T == 2:
                kc, vc = torch.cat([ks, kt], dim=2).contiguous(), torch.cat([vs, vt], dim=2).contiguous()
                am = torch.cat([smask, tmask], dim=-1)[:, None]
                bound, by = C.tree_attention(B, KV, T, T, hd, dtype, pairs=int(tmask.sum()),
                                             carried=N_s, carried_pairs=int(smask.sum())).bound_ms()
                key = f"{str(dtype)[6:]}_carry"
                timing[key] = _timings(
                    lambda: ta.tree_attention_partial(q, kt, vt, tmask, **seg2),
                    lambda: ref.tree_attention_partial(q, kt, vt, tmask, **seg2),
                    lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=am), flush, bound, by)
                print(f"[phase 2] tree_attention   {name} " + _timing_text(timing[key], "sdpa"))
    return worst


def _set_cond_kernel(torch, flush) -> dict:
    """set_cond behind an IF node: three captured segments (a predicate, a
    gated body that updates a buffer in place, a tail that reads it)
    assembled by ``kernels.graph_cond.CondGraph``, against the plain version
    (``ref.cond_segments``: the same segments eagerly, the IF decided by a
    host read), bitwise over predicates that flip; timed with the predicate
    false and true. The bound is the one-byte read of the predicate."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import graph_cond, ref

    def state():
        return {"flag": torch.zeros((), dtype=torch.int32, device="cuda"),
                "x": torch.ones(64, 1024, device="cuda"), "y": torch.zeros(64, device="cuda")}

    def segments(st, mid):
        def head():
            mid["pred"] = st["flag"] > 0

        def body():
            st["x"].mul_(0.5).add_(1.0)

        def tail():
            st["y"].copy_(st["x"].sum(dim=-1))
        return head, body, tail

    g_st, g_mid, p_st, p_mid = state(), {}, state(), {}
    g_segs = segments(g_st, g_mid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in g_segs:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs, pool = [], None
    for fn in g_segs:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool):
            fn()
        pool = graph.pool() if pool is None else pool
        graphs.append(graph)
    g_st["x"].fill_(1.0)
    cond = graph_cond.CondGraph([("child", graphs[0]), ("if", g_mid["pred"], graphs[1]),
                                 ("child", graphs[2])], "cuda")
    head, body, tail = segments(p_st, p_mid)
    plain = lambda: ref.cond_segments([("child", head), ("if", lambda: p_mid["pred"], body),  # noqa: E731
                                       ("child", tail)])
    err = 0.0
    for flag in (1, 0, 1, 1, 0, 0, 1):
        g_st["flag"].fill_(flag)
        p_st["flag"].fill_(flag)
        cond.launch()
        plain()
        torch.cuda.synchronize()
        err = max(err, _err(g_st["x"], p_st["x"]), _err(g_st["y"], p_st["y"]))
        if not (torch.equal(g_st["x"], p_st["x"]) and torch.equal(g_st["y"], p_st["y"])):
            raise AssertionError(f"set_cond: the conditional graph differs from the plain version "
                                 f"(predicate {flag})")
    bound, by = C.set_cond().bound_ms()
    times = {}
    for flag in (0, 1):
        g_st["flag"].fill_(flag)
        p_st["flag"].fill_(flag)
        times[flag] = (_time_ms(cond.launch, flush), _time_ms(plain, flush))
    print(f"[phase 2] set_cond (an IF node over a 64x1024 in-place update): bitwise equal to the plain "
          f"version over 7 launches | launch ms, predicate false {times[0][0]:.4f} (plain "
          f"{times[0][1]:.4f}), true {times[1][0]:.4f} (plain {times[1][1]:.4f}); bound "
          f"{bound:.2e} ms ({by})")
    cond.close()
    return dict(max_abs_err=err, ms=times[0][0], plain_ms=times[0][1], bound_ms=bound, bound_by=by,
                library_ms=None, launches=0)


# the experts of phase 13's models: (model, d, F, E, K)
MOE_SHAPES = (("qwen2-moe-a2.7b", 2048, 1408, 60, 4), ("mixtral-8x22b", 6144, 16384, 8, 2))
MOE_TOKENS = (1, 4, 16, 64, 128)
MOE_TIMED = (4, 16, 64)            # the single stream's verifies, the server's B=4 verify
MOE_TIMED_BF16 = MOE_TIMED + (128,)
MOE_EDGE_ROWS = (1, 63, 65, 130)   # rows an expert about the 64-row tiles of the bfloat16 kernel


def _moe_route(torch, gen, N, K, E, d, dtype, pool=None):
    """N token rows (N, d) and K distinct experts for each (N, K), drawn
    from ``pool`` (default: all E)."""
    scores = torch.rand(N, E, generator=gen, device="cuda")
    if pool is not None:
        keep = torch.zeros(E, dtype=torch.bool, device="cuda")
        keep[list(pool)] = True
        scores = torch.where(keep, scores, -1.0)
    return torch.randn(N, d, generator=gen, device="cuda").to(dtype), scores.topk(K, dim=-1).indices


def _moe_sort(torch, x, ids, E):
    """The dispatch's rows, as ``models/moe.py`` sorts them: (x_s (N*K, d),
    offs (E + 1,) int32, order: the flat (token, k) index of each row)."""
    sorted_e, order = torch.sort(ids.reshape(-1), stable=True)
    offs = torch.searchsorted(sorted_e, torch.arange(E + 1, device="cuda"), out_int32=True)
    return x.index_select(0, order // ids.shape[1]), offs, order


def _moe_kernel(torch, gen, flush) -> dict:
    """The grouped expert GEMM (``moe_grouped``: the gated up projection and
    the down projection of one MoE layer, two launches) against its plain
    version, at qwen2-moe's and mixtral's expert shapes, in float32 (within
    TOL["moe"]) and bfloat16 (within one bfloat16 ulp of the value plus
    TOL["moe"]: both round float32 sums), at N = 1-128 tokens and with most
    experts empty; the first tokens' rows bitwise equal whatever else is
    batched; timed by CUDA events and graph replay beside the bound (the
    bytes of the experts hit and of the rows, or the operations), the plain
    version and three yardsticks: a loop of one matmul per expert that reads
    the group sizes on the host, the fixed-shape product of every expert
    over every token (einsum, E / K times the operations) and, in bfloat16,
    ``torch._grouped_mm`` where the card's torch has it, with the kernel's
    graph-replay time over its. Routed cases give each of K experts 1, 63,
    64, 65 or 130 rows, about the bfloat16 kernel's 64-row tiles; the
    bitwise check also puts the last tokens' rows in a later tile of each
    expert. bfloat16 is also timed at N = 128. Returns the kernels line's
    two rows, each with its type's worst error: ``moe_grouped`` (the
    float32 SIMT kernel) at qwen2-moe N=64 and ``moe_grouped_bf16`` (the
    bfloat16 tensor-core kernel) at qwen2-moe N=16 (~phase 13's B=4 round),
    with ``torch._grouped_mm``'s time."""
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ref

    F_ = torch.nn.functional
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows_of = {("qwen2-moe-a2.7b", "float32", 64): "moe_grouped",
               ("qwen2-moe-a2.7b", "bfloat16", 16): "moe_grouped_bf16"}
    out = {}
    for model, d, F, E, K in MOE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            w_gate, w_up = (torch.randn(E, d, F, generator=gen, device="cuda").mul_(d ** -0.5)
                            .to(dtype) for _ in range(2))
            w_down = torch.randn(E, F, d, generator=gen, device="cuda").mul_(F ** -0.5).to(dtype)

            def kernel(x_s, offs):
                h = mg.moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
                return mg.moe_grouped(h, w_down, offs)

            def plain(x_s, offs):
                h = ref.ref_moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
                return ref.ref_moe_grouped(h, w_down, offs)

            # and tokens routed to K experts only: most experts get no row, each
            # of the K gets every token's row
            k_pool = tuple(range(0, E, E // K))[:K]
            cases = [(N, None) for N in MOE_TOKENS] + [(N, k_pool) for N in (64, *MOE_EDGE_ROWS)]
            errs = []
            for N, pool in cases:
                x_s, offs, _ = _moe_sort(torch, *_moe_route(torch, gen, N, K, E, d, dtype, pool), E)
                h = mg.moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
                got = mg.moe_grouped(h, w_down, offs)
                pairs = ((h, ref.ref_moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)),
                         (got, ref.ref_moe_grouped(h, w_down, offs)))
                torch.cuda.synchronize()
                for a, b in pairs:
                    ulp = 0.0 if dtype == torch.float32 else 2 ** -7 * b.float().abs()
                    if bool(((a.float() - b.float()).abs() > TOL["moe"] + ulp).any()):
                        raise AssertionError(f"moe_grouped {model} {name} N={N}: err abs "
                                             f"{_err(a, b):.3e} past the tolerance")
                    errs.append(_err(a, b))
                hit = int((offs[1:] > offs[:-1]).sum())
                print(f"[phase 2] moe_grouped {model} {name} N={N:3d} (P={N * K}, {hit} of {E} "
                      f"experts hit{', routed to ' + str(len(pool)) if pool else ''}): err abs "
                      f"h {errs[-2]:.3e}, out {errs[-1]:.3e}")
            worst[dtype] = max(worst[dtype], *errs)
            # batch invariance: the rows of the first 4 tokens, alone and among 64
            x, ids = _moe_route(torch, gen, 64, K, E, d, dtype)
            rows = []
            for n in (4, 64):
                x_s, offs, order = _moe_sort(torch, x[:n], ids[:n], E)
                rows.append(kernel(x_s, offs)[torch.argsort(order)][:4 * K])   # (token, k) order
            torch.cuda.synchronize()
            if not torch.equal(rows[0], rows[1]):
                raise AssertionError(f"moe_grouped {model} {name}: the first 4 tokens' rows differ "
                                     f"when 60 more tokens are batched with them")
            # and the last 4 of 100 tokens routed to K experts: rows 96-99 of
            # each expert's 100, in its second 64-row tile
            x, ids = _moe_route(torch, gen, 100, K, E, d, dtype, k_pool)
            for lo in (96, 0):
                x_s, offs, order = _moe_sort(torch, x[lo:], ids[lo:], E)
                rows.append(kernel(x_s, offs)[torch.argsort(order)][-4 * K:])
            torch.cuda.synchronize()
            if not torch.equal(rows[2], rows[3]):
                raise AssertionError(f"moe_grouped {model} {name}: the last 4 tokens' rows differ "
                                     f"when 96 tokens of the same experts come before them")
            print(f"[phase 2] moe_grouped {model} {name}: the first 4 tokens' {4 * K} rows bitwise "
                  f"equal alone and among 64 tokens' {64 * K}; the last 4 tokens' alone and after "
                  f"96 tokens of the same {K} experts (their rows in each expert's second 64-row "
                  f"tile)")
            for N in (MOE_TIMED_BF16 if dtype == torch.bfloat16 else MOE_TIMED):
                x, ids = _moe_route(torch, gen, N, K, E, d, dtype)
                x_s, offs, order = _moe_sort(torch, x, ids, E)
                sorted_e = torch.searchsorted(offs[1:].long(), torch.arange(N * K, device="cuda"),
                                              right=True)
                hit = int((offs[1:] > offs[:-1]).sum())
                bound, by = C.moe_grouped(N, K, d, F, E, hit, dtype).bound_ms()

                def loop():
                    sizes = offs.diff().tolist()               # the host read
                    outs, a = [], 0
                    for e, n in enumerate(sizes):
                        if n:
                            xe = x_s[a:a + n]
                            outs.append((F_.silu(xe @ w_gate[e]) * (xe @ w_up[e])) @ w_down[e])
                        a += n
                    return torch.cat(outs)

                def every():
                    hs = F_.silu(torch.einsum("nd,edf->enf", x, w_gate)) * torch.einsum(
                        "nd,edf->enf", x, w_up)
                    return torch.einsum("enf,efd->end", hs, w_down)[sorted_e, order // K]

                tm = dict(ms=_time_ms(lambda: kernel(x_s, offs), flush),
                          graph_ms=_graph_ms(lambda: kernel(x_s, offs), flush),
                          plain_ms=_time_ms(lambda: plain(x_s, offs), flush),
                          loop_ms=_time_ms(loop, flush), every_ms=_time_ms(every, flush),
                          every_graph_ms=_graph_ms(every, flush), bound_ms=bound, bound_by=by)
                grouped, tm["library_graph_ms"] = "absent", None
                if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
                    ends = offs[1:].contiguous()

                    def lib():
                        h = F_.silu(torch._grouped_mm(x_s, w_gate, offs=ends)) * torch._grouped_mm(
                            x_s, w_up, offs=ends)
                        return torch._grouped_mm(h, w_down, offs=ends)

                    try:
                        e = _err(lib(), kernel(x_s, offs))
                        tm["library_ms"] = _time_ms(lib, flush)
                        tm["library_graph_ms"] = _graph_ms(lib, flush)
                        grouped = (f"{tm['library_ms']:.4f} ms (graph replay "
                                   f"{tm['library_graph_ms']:.4f} ms, err abs {e:.3e}); kernel "
                                   f"graph / library graph "
                                   f"{tm['graph_ms'] / tm['library_graph_ms']:.2f}")
                    except RuntimeError as exc:
                        grouped = f"absent ({str(exc).splitlines()[0][:80]})"
                print(f"[phase 2] moe_grouped {model} {name} N={N} (P={N * K}, {hit} experts hit): "
                      f"kernel {tm['ms']:.4f} ms (graph replay {tm['graph_ms']:.4f} ms)  plain "
                      f"{tm['plain_ms']:.4f} ms  bound {bound:.4f} ms ({by}), graph/bound "
                      f"{tm['graph_ms'] / bound:.1f}x | yardsticks: per-expert matmul loop "
                      f"(host read) {tm['loop_ms']:.4f} ms; every expert over every token "
                      f"{tm['every_ms']:.4f} ms (graph replay {tm['every_graph_ms']:.4f} ms); "
                      f"torch._grouped_mm {grouped}")
                if (model, name, N) in rows_of:
                    out[rows_of[model, name, N]] = dict(
                        dtype=dtype, ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=bound,
                        bound_by=by, library_ms=tm.get("library_ms"), launches=0)
            del w_gate, w_up, w_down
            torch.cuda.empty_cache()
    for row in out.values():
        row["max_abs_err"] = worst[row.pop("dtype")]
    return out


# ------------------------------------------------------------------ phases 3-5
GEN_TOKENS = 32
SEED = 0


def _prompts(vocab: int):
    """Three prompts of 32, 64 and 128 tokens, each a random motif repeated
    four times so that prompt lookup (PLD) has n-grams to match."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [np.tile(rng.integers(0, vocab, size=n // 4), 4).astype(np.int32) for n in (32, 64, 128)]


def _counters():
    """Kernel name -> (module, the module integer its wrapper counts in)."""
    from repro_torch.kernels import flash_decode, graph_cond, int8_matmul, moe_grouped, tree_attention

    return {"flash_decode": (flash_decode, "launches"),
            "flash_decode_paged": (flash_decode, "paged_launches"),
            "tree_attention": (tree_attention, "launches"),
            "int8_matmul": (int8_matmul, "launches"),
            "set_cond": (graph_cond, "launches"),
            "moe_grouped": (moe_grouped, "launches"),
            "moe_grouped_bf16": (moe_grouped, "bf16_launches")}


def _reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def _generate(torch, cfg, params, prompt, dytc: bool):
    from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy

    eng = SpecEngine(cfg, params)
    eng.start(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = DyTCScheduler(eng, build_hierarchy(cfg, "scaling")) if dytc else ARScheduler(eng)
    out = sched.generate(GEN_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(eng.last_logits).all())
    return out, eng.stats, wall, finite


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "split_kernel" in n or "combine_kernel" in n:
        return "flash_decode"
    if "tree_kernel" in n:
        return "tree_attention"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    return "other"


def _profile(torch, cfg, params, prompt, dytc: bool, n_tokens: int = 8) -> None:
    """Device time by kernel group over a short steady window of one request
    (after 4 warm-up tokens), and the device's idle share of the window's
    wall time. The profiler's own overhead lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy

    eng = SpecEngine(cfg, params)
    eng.start(prompt)
    sched = DyTCScheduler(eng, build_hierarchy(cfg, "scaling")) if dytc else ARScheduler(eng)
    sched.generate(4)
    torch.cuda.synchronize()
    calls0 = eng.stats["target_calls"] + eng.stats["draft_calls"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.generate(n_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = eng.stats["target_calls"] + eng.stats["draft_calls"] - calls0
    groups: dict = {}
    launches = 0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0.0)
        if dt > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + dt / 1e3
            launches += e.count
    busy = sum(groups.values())
    print(f"[phase 3] profile {'DyTC' if dytc else 'AR'} ({n_tokens} tokens, {calls} model calls): "
          f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{launches} device launches; by group (ms): "
          + ", ".join(f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda x: -x[1])))


def phase_main_path(torch, dtype: str, results: dict, exact: bool) -> list:
    """AR and DyTC over three prompts at vicuna-7b width in ``dtype``;
    returns the AR streams."""
    from repro_torch.config import get_config
    from repro_torch.models import init_params

    phase = 3 if exact else 4
    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype=dtype)
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    torch.cuda.synchronize()
    print(f"[phase {phase}] vicuna-7b {dtype}: random params (seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    _reset_counts()
    ar_streams = []
    for i, prompt in enumerate(_prompts(cfg.vocab_size)):
        ar, ar_stats, ar_wall, ar_fin = _generate(torch, cfg, params, prompt, dytc=False)
        ar_streams.append(ar)
        before = _read_counts()
        dy, dy_stats, dy_wall, dy_fin = _generate(torch, cfg, params, prompt, dytc=True)
        rounds = dy_stats["rounds"]
        per_round = {k: (v - before[k]) / rounds for k, v in _read_counts().items()}
        same = sum(a == b for a, b in zip(ar, dy)) / GEN_TOKENS
        finite = ar_fin and dy_fin
        # c by wall time: a draft call's mean over a target call's
        c = (dy_stats["draft_time"] / dy_stats["draft_calls"]
             / (dy_stats["verify_time"] / dy_stats["target_calls"])
             if dy_stats["draft_calls"] else float("nan"))
        if exact:
            results.setdefault("phase3_c", []).append(c)
        print(f"[phase {phase}] prompt {i} ({len(prompt)} tokens): AR {ar_stats['target_calls']} target calls "
              f"{ar_wall:.3f} s | DyTC {dy_stats['target_calls']} target calls, {dy_stats['draft_calls']} "
              f"draft calls (c {c:.3f} by wall time), {rounds} rounds, "
              f"{dy_stats['accepted_tokens'] / rounds:.2f} tokens/round, "
              f"{dy_wall:.3f} s | identical={ar == dy} share equal={same:.3f} finite={finite} | "
              "launches per DyTC round: " + ", ".join(f"{k} {v:.2f}" for k, v in per_round.items()))
        if exact and ar != dy:
            raise AssertionError(f"prompt {i}: DyTC diverged from AR in {dtype}:\nAR   {ar}\nDyTC {dy}")
        if not finite:
            raise AssertionError(f"prompt {i}: non-finite logits in {dtype}")
    counts = _read_counts()
    print(f"[phase {phase}] kernel launches on the main path: {counts}")
    for name in ("flash_decode", "tree_attention"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {dtype} main path")
    if exact:
        for name in ("flash_decode", "tree_attention"):
            results[name]["launches"] = counts[name]
        for mode in ("ar", "dytc"):
            _profile(torch, cfg, params, _prompts(cfg.vocab_size)[2], mode == "dytc")
    return ar_streams


@contextlib.contextmanager
def _plain_w8a8():
    """Route the W8A8 product of ``ops.quantized_matmul`` to its plain version."""
    from repro_torch.kernels import ops, ref

    kernel = ops.int8_matmul
    ops.int8_matmul = ref.ref_int8_matmul
    try:
        yield
    finally:
        ops.int8_matmul = kernel


def phase_int8(torch, results: dict) -> None:
    """decode_step(quantize="int8") at vicuna-7b width, bf16, against the same
    call with the plain W8A8 version; then one quantized_matmul split into
    its parts."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = get_config("vicuna-7b")
    params = init_params(cfg, SEED)
    prompt = _prompts(cfg.vocab_size)[2]
    cache = init_cache(cfg, 1, 2048)
    _, cache = prefill(cfg, params, {"tokens": torch.as_tensor(prompt[None], device="cuda")}, cache)
    T = 32
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, T)), device="cuda")
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))
    tm[5:, 4] = False                                     # a branch at node 4
    _reset_counts()
    got, _ = decode_step(cfg, params, cache, toks, tree_mask=tm, quantize="int8")
    torch.cuda.synchronize()
    counts = _read_counts()
    with _plain_w8a8():
        want, _ = decode_step(cfg, params, cache, toks, tree_mask=tm, quantize="int8")
    dense, _ = decode_step(cfg, params, cache, toks, tree_mask=tm)
    torch.cuda.synchronize()
    err = _err(got, want)
    agree = float((got.argmax(-1) == dense.argmax(-1)).float().mean())
    print(f"[phase 5] decode_step(quantize='int8') bf16 T={T}: kernel vs plain W8A8 max abs logit err "
          f"{err:.3e} (tol {TOL['int8_decode_logits']}); W8A8 launches {counts['int8_matmul']}; "
          f"argmax agreement with the unquantized step {agree:.3f}")
    if err > TOL["int8_decode_logits"] or not bool(torch.isfinite(got).all()):
        raise AssertionError("decode_step int8 disagrees with its plain W8A8 version")
    if counts["int8_matmul"] <= 0:
        raise AssertionError("the W8A8 kernel was not launched by decode_step(quantize='int8')")
    results["int8_matmul"]["launches"] = counts["int8_matmul"]
    del params, cache
    _quantized_matmul_parts(torch)


def _quantized_matmul_parts(torch) -> None:
    """One ``ops.quantized_matmul`` at the gate/up product (32 rows, 4096 ->
    11008) by graph replay, L2 flushed, in bfloat16 and float32, split into
    its parts (the reference quantizes the weight anew on every call), beside
    the unquantized x @ w at the same shape."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(32, 4096, generator=gen, device="cuda").to(dtype)
        w = torch.randn(4096, 11008, generator=gen, device="cuda").to(dtype)
        x_q, xs = i8.quantize_rows(x)
        w_q, ws = i8.quantize_cols(w)
        parts = {"quantize_rows": lambda: i8.quantize_rows(x),
                 "quantize_cols": lambda: i8.quantize_cols(w),
                 "kernel": lambda: i8.int8_matmul(x_q, w_q, xs, ws),
                 "quantized_matmul": lambda: ops.quantized_matmul(x, w),
                 "x @ w": lambda: x @ w}
        ms = {k: _graph_ms(f, flush_buf.zero_) for k, f in parts.items()}
        print(f"[phase 5] quantized_matmul {str(dtype)[6:]} (32, 4096) x (4096, 11008), graph replay ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f"; quantize_cols / kernel {ms['quantize_cols'] / ms['kernel']:.1f}x")
    del flush_buf


# ------------------------------------------------------------------ phase 6
SERVER = dict(max_batch=4, max_len=1024, draft_k=4, tree_expansions=5, adaptive=True)
PAGE = 64


def _serve(torch, srv, prompts, ar_streams, readmit=(), late=(), sampling=None):
    """Admit ``prompts`` into slots 0.. (those in ``late`` after two
    rounds, mid-stream), step until every slot holds GEN_TOKENS tokens (a
    finished slot is released; the slots in ``readmit`` are admitted once
    more with the same prompt, onto the pages they gave back, in reverse
    order), and hold every stream to its AR stream (none: ``ar_streams``
    None). ``sampling``: a ``SamplingParams`` per prompt, passed at every
    admission of it. Returns a record of
    the run, with the mean wall time of the steps whose round prefilled a
    chunk, of those that ran the draft and no chunk, and of those that ran
    neither (read from the drained round, so only where each step drains),
    and each step's wall ms and stats deltas, and the streams. Kernel
    launches are the wrappers' counts plus, in single mode, those of the
    server's graph launches."""
    paged_kw = dict(max_new_tokens=GEN_TOKENS) if srv.paged else {}

    def admit(b):
        srv.add_request(b, prompts[b], sampling=None if sampling is None else sampling[b],
                        **paged_kw)

    pending = list(late)
    for b in range(len(prompts)):
        if b not in pending:
            admit(b)
    todo = list(readmit)
    gen = {b: [] for b in range(len(prompts)) if b not in pending}
    done = []                                      # (prompt index, stream)
    torch.cuda.synchronize()
    _reset_counts()
    steps0, graph0 = dict(srv.stats), dict(srv.graph_launches)
    slot_rounds, step_ms, step_kind, per_step, t0 = 0, [], [], [], time.perf_counter()
    while gen or pending:
        if pending and srv.stats["steps"] - steps0["steps"] == 2:
            for b in pending:
                admit(b)
                gen[b] = []
            pending = []
        slot_rounds += len(gen)
        d0, p0, t = srv.stats["draft_rounds"], srv.stats["prefill_rounds"], time.perf_counter()
        before = dict(srv.stats)
        out = srv.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append({k: v - before[k] for k, v in srv.stats.items()})
        step_kind.append("prefilled" if srv.stats["prefill_rounds"] > p0
                         else "ran" if srv.stats["draft_rounds"] > d0 else "skipped")
        for b, toks in out.items():
            gen[b].extend(toks)
        for b in [b for b, g in gen.items() if len(g) >= GEN_TOKENS]:
            done.append((b, gen.pop(b)))
            srv.release(b)
            if b in todo:
                todo.remove(b)
                admit(b)
                gen[b] = []
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    for k, v in srv.graph_launches.items():
        counts[k] += v - graph0.get(k, 0)
    st = {k: v - steps0[k] for k, v in srv.stats.items()}
    for i, stream in done:
        if ar_streams is not None and stream[:GEN_TOKENS] != ar_streams[i][:GEN_TOKENS]:
            raise AssertionError(f"prompt {i}: the server's stream left AR:\n"
                                 f"AR     {ar_streams[i][:GEN_TOKENS]}\nserver {stream[:GEN_TOKENS]}")
    def mean_ms(kind):
        ms = [m for m, k in zip(step_ms, step_kind) if k == kind]
        return (sum(ms) / len(ms) if ms else float("nan")), len(ms)

    contracts = _round_contracts(srv)
    return dict(requests=len(done), rounds=st["steps"], target_calls=st["target_calls"],
                draft_dispatches=st["draft_dispatches"], draft_rounds=st["draft_rounds"],
                prefill_rounds=st["prefill_rounds"], graph_replays=st["graph_replays"],
                host_syncs=st["host_syncs"], tokens=st["tokens"],
                tokens_per_slot_round=st["tokens"] / slot_rounds, wall_s=wall,
                ms_per_round=wall / st["steps"] * 1e3, launches=counts,
                launches_per_round={k: v / st["steps"] for k, v in counts.items()},
                per_step=per_step, step_ms=step_ms, streams=done, contracts=contracts,
                **{f"ms_{kind}": mean_ms(kind) for kind in ("prefilled", "ran", "skipped")})


def _check_launches(name: str, counts: dict, is_paged: bool) -> None:
    used = "flash_decode_paged" if is_paged else "flash_decode"
    unused = "flash_decode" if is_paged else "flash_decode_paged"
    if counts[used] <= 0 or counts["tree_attention"] <= 0 or counts[unused] != 0:
        raise AssertionError(f"{name}: launches {counts} do not show the {used} path")


def _runs(prompts):
    """The served configurations of phases 6 and 7: (name, mode, paged,
    server arguments, slots re-admitted)."""
    from repro_torch.core.tree import bucket_for

    # the server's own reservation: prompt + GEN_TOKENS + two tree buckets
    slack = 2 * bucket_for(1 + SERVER["draft_k"] + 2 * SERVER["tree_expansions"])
    return [("tree_fused dense", "tree_fused", False, {}, ()),
            ("tree_fused paged", "tree_fused", True, {}, ()),
            ("chain_fused paged", "chain_fused", True, {}, ()),
            ("tree_fused paged, undersubscribed pool, 2 re-admissions", "tree_fused", True,
             dict(num_pages=sum(-(-(len(p) + GEN_TOKENS + slack) // PAGE) for p in prompts)),
             (0, 1))]


def phase_server(torch, ar_streams: list, results: dict) -> dict:
    """The batched server at vicuna-7b width, float32, four slots, in split
    rounds: tree_fused dense and paged, chain_fused paged, and tree_fused on
    a pool sized for the requests alone with two slots released and
    re-admitted. Every stream equals the AR stream of its prompt; a dense
    and a paged decode_step over the same admitted state give bitwise-equal
    logits. Then one profiled window of split rounds. Returns what phase 7
    serves again."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.core import SpecEngine, layer_sparsity
    from repro_torch.models import decode_step, init_params
    from repro_torch.serving import BatchedSpecServer

    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="float32")
    params = init_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 2)
    long_prompt = np.tile(rng.integers(0, cfg.vocab_size, size=50), 4).astype(np.int32)
    prompts = _prompts(cfg.vocab_size) + [long_prompt]
    eng = SpecEngine(cfg, params)
    eng.start(long_prompt)
    ar_streams = list(ar_streams) + [eng.generate_ar(GEN_TOKENS)]
    del eng
    spec = layer_sparsity(cfg, 0.5)

    def server(mode, paged, draft=True, **kw):
        return BatchedSpecServer(cfg, params, mode=mode, draft_spec=spec if draft else None,
                                 paged=paged, page_size=PAGE, **SERVER, **kw)

    # one dense and one paged decode_step over the same admitted state
    dense, paged = (server("tree_fused", p, round_mode="split") for p in (False, True))
    for srv in (dense, paged):
        for b, p in enumerate(prompts):
            srv.add_request(b, p)
    T = dense.tree_bucket
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, T)), device="cuda")
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))
    tm[6:, 5] = False
    logits = [decode_step(cfg, params, srv.cache, toks, tree_mask=tm)[0] for srv in (dense, paged)]
    torch.cuda.synchronize()
    same = torch.equal(*logits)
    print(f"[phase 6] dense vs paged decode_step over the admitted state (B=4, T={T}): "
          f"bitwise equal logits={same}, max abs diff {_err(*logits):.3e}")
    if not same:
        raise AssertionError("paged decode_step logits differ from dense")
    del dense, paged, logits
    torch.cuda.empty_cache()

    paged_launches, split_ms = 0, {}
    # what phase 17 serves again on the mesh, and holds to these runs
    results["p17"] = dict(prompts=prompts, ar=ar_streams, split={}, single={})
    for name, mode, is_paged, kw, readmit in _runs(prompts):
        srv = server(mode, is_paged, round_mode="split", **kw)
        rec = _serve(torch, srv, prompts, ar_streams, readmit)
        split_ms[name] = rec["ms_per_round"]
        results["p17"]["split"][name] = {k: rec[k] for k in (
            "rounds", "target_calls", "draft_dispatches", "host_syncs", "ms_per_round")}
        pages = f", pool {len(srv._free_pages)} pages free at the end" if is_paged else ""
        print(f"[phase 6] {name}: {rec['requests']} requests identical to AR | {rec['rounds']} rounds, "
              f"{rec['target_calls']} target calls, {rec['draft_dispatches']} draft passes, "
              f"{rec['tokens']} tokens, {rec['tokens_per_slot_round']:.2f} tokens per slot-round, "
              f"{rec['wall_s']:.3f} s ({rec['ms_per_round']:.2f} ms per round), "
              f"{rec['host_syncs'] / rec['rounds']:.2f} host syncs per round{pages} | "
              "launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        _check_launches(name, rec["launches"], is_paged)
        paged_launches += rec["launches"]["flash_decode_paged"]
        del srv
        torch.cuda.empty_cache()
    results["flash_decode_paged"]["launches"] = paged_launches
    _profile_rounds(torch, server("tree_fused", False, round_mode="split"), prompts, 6)
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, spec=spec, prompts=prompts, ar_streams=ar_streams,
                split_ms=split_ms, server=server, greedy={})


# ------------------------------------------------------------------ phase 7
def _profile_rounds(torch, srv, prompts, phase: int, n_rounds: int = 8) -> None:
    """Device time by kernel group over a steady window of server rounds
    (after 4 warm-up rounds, four slots), and the device's idle share of the
    window's wall time. The profiler's own overhead lengthens the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    for b, p in enumerate(prompts):
        srv.add_request(b, p)
    for _ in range(4):
        srv.step()
    torch.cuda.synchronize()
    rounds0 = srv.stats["steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            srv.step()
        srv.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    launches = 0
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", 0.0)
        if dt > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + dt / 1e3
            launches += e.count
    busy = sum(groups.values())
    rounds = srv.stats["steps"] - rounds0
    drafted = srv.stats["draft_rounds"] + srv.stats["draft_dispatches"]
    print(f"[phase {phase}] profile {srv.mode} {'paged' if srv.paged else 'dense'} {srv.round_mode} "
          f"rounds ({rounds} rounds, "
          f"{drafted} of {srv.stats['steps']} rounds needed the draft so far): "
          f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}, {launches} device kernels; by group (ms): "
          + ", ".join(f"{g} {t:.2f}" for g, t in sorted(groups.items(), key=lambda x: -x[1])))
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time in the server's rounds")


def _profile_launches(torch, srv, prompts, n_max: int = 30) -> None:
    """Profile single rounds one at a time (four slots admitted) until one
    that ran the draft and one that skipped it are seen, and print each
    one's device activities and device time: a skipped launch runs none of
    the draft's kernels."""
    from torch.profiler import ProfilerActivity, profile

    for b, p in enumerate(prompts):
        srv.add_request(b, p)
    seen = {}
    for _ in range(n_max):
        d0 = srv.stats["draft_rounds"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            srv.step()
            torch.cuda.synchronize()
        kind = "ran the draft" if srv.stats["draft_rounds"] > d0 else "skipped the draft"
        if kind in seen:
            continue
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        groups: dict = {}
        for e in evs:
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0) + e.count
        seen[kind] = (sum(e.count for e in evs), sum(e.self_device_time_total for e in evs) / 1e3,
                      groups)
        if len(seen) == 2:
            break
    for kind, (n, ms, groups) in seen.items():
        print(f"[phase 7] one launch that {kind}: {n} device activities, device time {ms:.2f} ms; "
              "by group: " + ", ".join(f"{g} {c}" for g, c in sorted(groups.items())))
    if len(seen) != 2 or seen["skipped the draft"][0] >= seen["ran the draft"][0]:
        raise AssertionError(f"phase 7: no pair of launches that ran and skipped the draft, or the "
                             f"skipped one ran as many kernels: {seen}")


def phase_single(torch, served: dict, results: dict) -> None:
    """The batched server of phase 6 in single-dispatch rounds: each round
    one launch of a graph assembled at build from the round's captured
    segments, the draft behind a conditional node on the round's own
    predicate (``kernels/graph_cond.py``). The same four runs as phase 6 at
    sync_every=1 (the draft's KV carried, the default), tree_fused dense
    with recomputed draft KV, at sync_every=4, and with PLD alone (no
    drafter at all), and chain_fused paged with chunked prefill (64 tokens
    a round, behind a conditional node of its own) of the 200-token prompt
    admitted mid-stream; every stream equals AR. Rounds that ran the draft
    and rounds that skipped it are timed apart; the skipped rounds of
    tree_fused dense must cost within 1.25x of a PLD-only round. Then one
    launch of each kind profiled, and a steady window of rounds."""
    prompts, ar_streams = served["prompts"], served["ar_streams"]
    runs = [r + ((),) for r in _runs(prompts)]
    runs += [("tree_fused dense, recompute", "tree_fused", False, dict(draft_kv="recompute"), (), ()),
             ("tree_fused dense, sync_every=4", "tree_fused", False, dict(sync_every=4), (), ()),
             ("tree_fused dense, PLD only", "tree_fused", False, dict(draft=False), (), ()),
             ("chain_fused paged, prefill_chunk=64, 200-token prompt admitted mid-stream",
              "chain_fused", True, dict(prefill_chunk=64), (), (3,))]
    launches = {"flash_decode": 0, "tree_attention": 0, "flash_decode_paged": 0, "set_cond": 0}
    recs = {}
    for name, mode, is_paged, kw, readmit, late in runs:
        _reset_counts()
        srv = served["server"](mode, is_paged, round_mode="single", **kw)
        if srv._graph is None:
            raise AssertionError(f"{name}: no CUDA graph was captured")
        rec = recs[name] = _serve(torch, srv, prompts, ar_streams, readmit, late)
        split = served["split_ms"].get(name, served["split_ms"].get(name.split(", ")[0]))
        split = f" (split rounds, phase 6: {split:.2f})" if split else ""
        seg = {k: sum(v.values()) for k, v in srv.segment_launches.items()}
        kinds = ""
        if srv.sync_every == 1:
            kinds = "; " + ", ".join(f"{rec['ms_' + k][1]} {text} at {rec['ms_' + k][0]:.2f} ms"
                                     for k, text in (("prefilled", "prefilled a chunk"),
                                                     ("ran", "ran the draft"),
                                                     ("skipped", "skipped it"))
                                     if rec["ms_" + k][1])
        print(f"[phase 7] {name}: {rec['requests']} requests identical to AR | {rec['rounds']} rounds, "
              f"{rec['tokens_per_slot_round']:.2f} tokens per slot-round, {rec['wall_s']:.3f} s, "
              f"{rec['ms_per_round']:.2f} ms per round{split}{kinds}, "
              f"{rec['prefill_rounds']} rounds prefilled | {rec['host_syncs'] / rec['rounds']:.2f} host "
              f"syncs and {rec['graph_replays'] / rec['rounds']:.2f} graph launches per round | capture "
              f"{srv.capture_s * 1e3:.1f} ms, graph pool {srv.graph_pool_bytes / 2**20:.1f} MiB, "
              f"kernel launches per segment {seg} | launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        if (rec["host_syncs"] * srv.sync_every != rec["rounds"] or rec["draft_dispatches"]
                or rec["graph_replays"] != rec["rounds"]):
            raise AssertionError(f"{name}: {rec['host_syncs']} host syncs and "
                                 f"{rec['graph_replays']} replays in {rec['rounds']} rounds")
        if srv.prefill_chunk and rec["prefill_rounds"] < 4:
            raise AssertionError(f"{name}: {rec['prefill_rounds']} prefill rounds")
        _check_launches(name, rec["launches"], is_paged)
        for k in launches:
            launches[k] += rec["launches"][k]
        served["greedy"][name] = dict(rec, capture_s=srv.capture_s, pool=srv.graph_pool_bytes)
        results["p17"]["single"][name] = {k: rec[k] for k in (
            "rounds", "target_calls", "draft_dispatches", "host_syncs", "graph_replays",
            "ms_per_round", "streams")}
        del srv
        torch.cuda.empty_cache()
    for k, v in launches.items():
        results[k]["launches"] += v
    skipped = recs["tree_fused dense"]["ms_skipped"][0]
    pld = recs["tree_fused dense, PLD only"]["ms_skipped"][0]
    print(f"[phase 7] tree_fused dense rounds that skipped the draft: {skipped:.2f} ms, "
          f"{skipped / pld:.3f}x a PLD-only round ({pld:.2f} ms)")
    if not skipped <= 1.25 * pld:
        raise AssertionError("phase 7: rounds that skip the draft cost more than 1.25x a PLD-only round")
    _profile_launches(torch, served["server"]("tree_fused", False, round_mode="single"), prompts)
    torch.cuda.empty_cache()
    srv = served["server"]("tree_fused", False, round_mode="single")
    _profile_rounds(torch, srv, prompts, 7)
    del srv
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 8
def _dispatches(step: dict) -> int:
    """Model dispatches of one split round from its stats deltas: drafting
    passes, rescores and the verify, which rides the last rescore in a
    round that rescored."""
    return (step["draft_dispatches"] + step["rescore_dispatches"] + step["target_calls"]
            - (step["rescore_dispatches"] > 0))


def _drafter_decodes(torch, cfg, params, bank, cache) -> None:
    """One decode of the mixing bank's drafter (LS0.6+Q8: 13 layers) at
    B=4 x 2 = 8 rows (a carry step) and B=4 x 32 = 128 rows (the seed block
    of the 32-node bucket) over the admitted state: through the W8A8 kernel
    on the MLP weights quantized once (the served path), the same layers in
    float32, and the W8A8 kernel with the weights quantized on every call
    (the reference's path, which serving does not take). CUDA events, mean
    of 10 after 2 warm-up calls. The two int8 decodes give bitwise-equal
    logits."""
    import numpy as np

    from repro_torch.models import decode_step

    lvl, dev = bank.drafter, cache["pos"].device
    rng = np.random.default_rng(SEED + 3)
    for T in (2, 32):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, T)), device=dev)
        kw = dict(tree_mask=torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev)),
                  layer_ids=lvl.layer_ids)
        variants = {
            "int8 quantized once": lambda: decode_step(cfg, lvl.params, cache, toks,
                                                       quantize="int8", **kw),
            "float32": lambda: decode_step(cfg, params, cache, toks, **kw),
            "int8 quantized per call": lambda: decode_step(cfg, params, cache, toks,
                                                           quantize="int8", **kw)}
        once, per_call = variants["int8 quantized once"]()[0], variants["int8 quantized per call"]()[0]
        torch.cuda.synchronize()
        if not torch.equal(once, per_call) or not bool(torch.isfinite(once).all()):
            raise AssertionError(f"phase 8: the drafter's int8 decode at {4 * T} rows differs "
                                 "between weights quantized once and per call")
        ms = {k: _time_ms(f, lambda: None, iters=10, warmup=2) for k, f in variants.items()}
        busy = {k: _busy_ms(f) for k, f in variants.items()}
        print(f"[phase 8] one {lvl.name} decode ({len(lvl.layer_ids)} layers), {4 * T} rows, ms by "
              "events (device busy): "
              + ", ".join(f"{k} {v:.2f} ({busy[k]:.2f})" for k, v in ms.items())
              + f"; quantized once vs per call bitwise equal logits; float32 / int8 once "
              f"{ms['float32'] / ms['int8 quantized once']:.2f}x by events, "
              f"{busy['float32'] / busy['int8 quantized once']:.2f}x device busy")


def phase_cascade(torch, served: dict, results: dict) -> None:
    """The multi-level cascade and the per-step baseline at vicuna-7b width,
    float32, in split rounds, with phase 6's prompts and settings:
    ``cascade_fused`` with the mixing hierarchy (LS0.4 over LS0.6+Q8, the
    int8 level's MLP weights quantized once and run through the W8A8
    kernel), dense and paged; with the scaling hierarchy (LS0.4 over LS0.6,
    no int8 level); and ``legacy`` with layer sparsity 0.5. Every stream
    equals AR; no round makes more model dispatches than
    ``expected_dispatches_per_round()`` and a cascade round that drafts and
    rescores makes exactly that many; the W8A8 kernel launches in the
    mixing runs and not in the others. Before serving, one decode of the
    int8 drafter is timed three ways (``_drafter_decodes``); after, a
    profiled window of mixing rounds gives the device's idle share."""
    from repro_torch.core import build_hierarchy, layer_sparsity
    from repro_torch.serving import BatchedSpecServer

    cfg, params, prompts, ar_streams = (served[k] for k in ("cfg", "params", "prompts",
                                                            "ar_streams"))
    runs = [("cascade_fused mixing dense", False, {}),
            ("cascade_fused mixing paged", True, {}),
            ("cascade_fused scaling dense", False, dict(hierarchy=build_hierarchy(cfg, "scaling"))),
            ("legacy LS0.5 dense", False, dict(mode="legacy", draft_spec=layer_sparsity(cfg, 0.5)))]
    for i, (name, paged, kw) in enumerate(runs):
        kw = dict(dict(mode="cascade_fused"), **kw)
        srv = BatchedSpecServer(cfg, params, paged=paged, page_size=PAGE, round_mode="split",
                                **SERVER, **kw)
        bank = srv.bank
        if bank is not None and bank.int8_exec != "kernel":
            raise AssertionError(f"{name}: int8_exec resolved to {bank.int8_exec!r} on the card")
        if i == 0:
            for b, p in enumerate(prompts):
                srv.add_request(b, p)
            _drafter_decodes(torch, cfg, params, bank, srv.cache)
        rec = _serve(torch, srv, prompts, ar_streams)
        steps, expected = rec["per_step"], srv.expected_dispatches_per_round()
        disp = [_dispatches(st) for st in steps]
        if max(disp) > expected or (bank is not None and max(disp) != expected):
            raise AssertionError(f"{name}: dispatches per round {disp}, expected {expected}")
        rescored = [st for st in steps if st["rescore_dispatches"]]
        plain = [st for st in steps if not st["rescore_dispatches"]]
        drafted = sum(st["draft_dispatches"] for st in steps)

        def per(key, sts, n):
            return sum(st[key] for st in sts) * 1e3 / n if n else float("nan")

        mid = sum(st["rescore_dispatches"] - 1 for st in rescored)
        w8a8 = rec["launches_per_round"]["int8_matmul"]
        with_int8 = bank is not None and any(lv.quantize for lv in bank.levels)
        bank_text = (f" | bank {len(bank)} levels {[lv.name for lv in bank.levels]}, int8_exec "
                     f"{bank.int8_exec}, param_bytes {bank.param_bytes / 2**30:.3f} GiB"
                     if bank is not None else "")
        print(f"[phase 8] {name}: {rec['requests']} requests identical to AR | {rec['rounds']} rounds "
              f"({len(rescored)} rescored, {sum(1 for st in plain if st['draft_dispatches'])} drafted "
              f"without rescore), {rec['target_calls']} target calls, "
              f"{rec['tokens_per_slot_round']:.2f} tokens per slot-round, {rec['wall_s']:.3f} s "
              f"({rec['ms_per_round']:.2f} ms per round) | dispatches per round: mean "
              f"{sum(disp) / len(disp):.2f}, max {max(disp)}, expected {expected} (draft "
              f"{drafted / len(steps):.2f}, rescore {sum(st['rescore_dispatches'] for st in steps) / len(steps):.2f}, "
              f"verify {rec['target_calls'] / len(steps):.2f}) | ms per dispatch: drafting "
              f"{'scan' if srv.mode == 'cascade_fused' else 'step'} {per('draft_time', steps, drafted):.2f}, "
              f"intermediate rescore {per('rescore_time', steps, mid):.2f} ({mid}), rescore+verify "
              f"{per('verify_time', rescored, len(rescored)):.2f} ({len(rescored)}), verify "
              f"{per('verify_time', plain, len(plain)):.2f} ({len(plain)}) | W8A8 launches per "
              f"round {w8a8:.2f}{bank_text} | launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        _check_launches(name, rec["launches"], paged)
        if (w8a8 > 0) != with_int8:
            raise AssertionError(f"{name}: {w8a8:.2f} W8A8 launches per round "
                                 f"({'an' if with_int8 else 'no'} int8 level)")
        results["int8_matmul"]["launches"] += rec["launches"]["int8_matmul"]
        served["greedy"][name] = rec
        del srv, bank
        torch.cuda.empty_cache()
    srv = BatchedSpecServer(cfg, params, mode="cascade_fused", round_mode="split", **SERVER)
    _profile_rounds(torch, srv, prompts, 8)
    del srv
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9
STOCH = dict(temperature=0.8, top_k=20, top_p=0.9)


def _bits(torch, t):
    return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()


def _sampling_on_card(torch, vocab: int) -> None:
    """The sampled path's plain-PyTorch pieces on the card: the threefry key
    stream bitwise against the same calls on the CPU, the warp
    (``sampling_probs``) within 1e-6 of the CPU's with the same support at
    a cascade verify's shape (B=4, 32 nodes, the full vocabulary), and the
    key split, warp and stochastic walk of one verify timed at the
    tree_fused (16 nodes) and cascade (32) buckets: CUDA events, graph
    replay (as the single round runs them) and the profiler's device time."""
    from repro_torch.core import prng, verify

    keys = prng.split(prng.prng_key(SEED + 11), 4)
    kd = keys.cuda()
    pairs = {"prng_key": (prng.prng_key(2**31 - 1, device="cuda"), prng.prng_key(2**31 - 1)),
             "split": (prng.split(kd, 5), prng.split(keys, 5)),
             "fold_in": (prng.fold_in(kd, 3), prng.fold_in(keys, 3)),
             "round_uniforms": (verify.round_uniforms(kd, 32)[1],
                                verify.round_uniforms(keys, 32)[1])}
    for n in (1, 5, 33):
        pairs[f"uniform n={n}"] = (prng.uniform(kd, n), prng.uniform(keys, n))
    bad = [k for k, (g, w) in pairs.items() if not torch.equal(_bits(torch, g), _bits(torch, w))]
    print(f"[phase 9] threefry on the card against the CPU: {len(pairs) - len(bad)} of "
          f"{len(pairs)} bitwise equal ({', '.join(pairs)})")
    if bad:
        raise AssertionError(f"phase 9: the card's key stream differs from the CPU's: {bad}")
    gen = torch.Generator().manual_seed(SEED + 9)
    B = 4
    params = (torch.tensor([0.8, 0.0, 1.0, 0.6]), torch.tensor([20, 0, 0, 50], dtype=torch.int32),
              torch.tensor([0.9, 1.0, 0.5, 1.0]))
    logits = torch.randn(B, 32, vocab, generator=gen) * 3
    want = verify.sampling_probs(logits, *params)
    p_dev = [t.cuda() for t in params]
    got = verify.sampling_probs(logits.cuda(), *p_dev).cpu()
    err = (got - want).abs().max().item()
    print(f"[phase 9] sampling_probs (4, 32, {vocab}) on the card against the CPU: max abs "
          f"{err:.3e} (tolerance 1e-6), same support {torch.equal(got > 0, want > 0)}")
    if err > 1e-6 or not torch.equal(got > 0, want > 0):
        raise AssertionError("phase 9: sampling_probs on the card differs from the CPU's")
    for N in (16, 32):
        lg = (torch.randn(B, N, vocab, generator=gen) * 3).cuda()
        q = verify.sampling_probs(lg, *p_dev)
        # a random tree per slot whose first child at each node is the
        # target's head token there, so that walks go deep
        parents = torch.tensor([[-1] + [int(torch.randint(0, j, (1,), generator=gen))
                                        for j in range(1, N)] for _ in range(B)], dtype=torch.int32)
        tokens = torch.randint(0, vocab, (B, N), generator=gen, dtype=torch.int32)
        head = q.argmax(-1).cpu()
        for b in range(B):
            seen = set()
            for j in range(1, N):
                p = int(parents[b, j])
                if p not in seen:
                    tokens[b, j] = head[b, p]
                    seen.add(p)
        tokens, parents = tokens.cuda(), parents.cuda()
        count = torch.full((B,), N, dtype=torch.int32).cuda()
        u = verify.round_uniforms(kd, N)[1]
        fns = {"key split": lambda: verify.round_uniforms(kd, N),
               "warp": lambda: verify.sampling_probs(lg, *p_dev),
               "walk": lambda: verify.sample_accept_tree_batched(tokens, parents, count, q, u)}
        ms = {k: (_time_ms(f, lambda: None), _graph_ms(f, lambda: None), _busy_ms(f))
              for k, f in fns.items()}
        n_acc = verify.sample_accept_tree_batched(tokens, parents, count, q, u)[1]
        print(f"[phase 9] one verify's sampling, B=4, {N} nodes, V={vocab}, ms by events / graph "
              "replay / device (profiler): "
              + ", ".join(f"{k} {a:.4f} / {g:.4f} / {d:.4f}" for k, (a, g, d) in ms.items())
              + f"; all three {sum(v[1] for v in ms.values()):.4f} ms by graph replay "
              f"(accepted nodes per slot {n_acc.tolist()})")


CONTRACTS: list = []               # (phase, label, summary) of each round held to its contracts
_PHASE = {"now": ""}


def _round_contracts(srv):
    """A single-round server's captured graph held to its dispatch contracts
    (``analysis.contracts.check_round``: no host node or host transfer, the
    gated segments behind IF nodes, each segment's hand kernels as its
    wrappers counted, no collective, no copy of the cache, the cache and
    state in place and no second copy of the cache left live, the replays
    as the dispatches); prints its nodes by kind and its pool and logs it
    for phase 16. Returns the contracts, None for a server with no graph."""
    from repro_torch.analysis import contracts as K

    if srv.round_mode != "single" or srv._graph is None:
        return None
    t0 = time.perf_counter()
    cons = K.check_round(srv)
    dt = time.perf_counter() - t0
    summ = cons["round"].summary()
    label = f"{srv.cfg.name} {srv.mode} {'paged' if srv.paged else 'dense'}"
    CONTRACTS.append((_PHASE["now"], label, summ))
    ranges = [v for k, v in srv.capture_ptrs.items() if k.startswith("cache")]
    mib = 2 ** 20
    print(f"[{_PHASE['now']}] contracts of {label}: held in {dt:.2f} s | {len(cons)} graph a "
          f"round, nodes {summ['nodes']}, {summ['if']} IF, hand kernels {summ['hand']}, "
          f"unresolved names {summ['unresolved']} | cache {sum(n for _, n in ranges) / mib:.1f} "
          f"MiB, copied out of it by memcpy nodes {cons['round'].cache_copy_bytes(ranges)} B, "
          f"left live by the capture {srv.graph_live_bytes / mib:.1f} MiB; graph pool "
          f"{srv.graph_pool_bytes / mib:.1f} MiB, by segment "
          + ", ".join(f"{k} {v / mib:.1f}" for k, v in srv.segment_pool_bytes.items()))
    return cons


def _check_single(name: str, rec: dict, srv) -> None:
    if (rec["host_syncs"] * srv.sync_every != rec["rounds"] or rec["draft_dispatches"]
            or rec["graph_replays"] != rec["rounds"]):
        raise AssertionError(f"{name}: {rec['host_syncs']} host syncs and "
                             f"{rec['graph_replays']} replays in {rec['rounds']} rounds")


def _check_dispatches(name: str, rec: dict, srv) -> list:
    disp = [_dispatches(st) for st in rec["per_step"]]
    if max(disp) > srv.expected_dispatches_per_round():
        raise AssertionError(f"{name}: dispatches per round {disp}, expected at most "
                             f"{srv.expected_dispatches_per_round()}")
    return disp


def _line(rec: dict) -> str:
    return (f"{rec['rounds']} rounds, {rec['tokens_per_slot_round']:.2f} tokens per slot-round, "
            f"{rec['ms_per_round']:.2f} ms per round")


def _replay_equals_eager(torch, served, samp) -> None:
    """One captured sampled tree_fused round against the same round run
    eagerly by a twin server on the card: the tokens, every carried state
    tensor (the keys included) and every cache leaf bitwise equal."""
    from repro_torch.models.model import tree_map
    from repro_torch.serving.sampler import SamplingParams

    twins = [served["server"]("tree_fused", False, round_mode="single",
                              sampling=SamplingParams(**STOCH)) for _ in range(2)]
    twins[1]._graph = None
    outs = []
    for srv in twins:
        for b, p in enumerate(served["prompts"]):
            srv.add_request(b, p, sampling=samp[b])
        outs.append(srv.step())
    torch.cuda.synchronize()
    leaves = [[], []]
    for srv, acc in zip(twins, leaves):
        tree_map(acc.append, srv.cache)
    same = (outs[0] == outs[1]
            and all(torch.equal(twins[0].dstate[k], twins[1].dstate[k]) for k in twins[0].dstate)
            and all(torch.equal(a, b) for a, b in zip(*leaves)))
    print(f"[phase 9] one sampled tree_fused round, graph replay against eager on the card: "
          f"tokens, dstate ({len(twins[0].dstate)} tensors) and {len(leaves[0])} cache leaves "
          f"bitwise equal {same}")
    if not same:
        raise AssertionError("phase 9: a captured sampled round differs from the eager round")


def phase_sampled(torch, served: dict, results: dict) -> None:
    """Sampled serving at vicuna-7b width, float32, four slots, phase 6's
    prompts, GEN_TOKENS a request. A sampled build at temperature 0 serves
    tree_fused dense in single and in split rounds, chain_fused paged with
    chunked prefill (the 200-token prompt admitted mid-stream), the mixing
    cascade and legacy: every stream equals AR. At temperature 0.8, top-k
    20, top-p 0.9 and per-request seeds 11 + i, tree_fused single and the
    mixing cascade are each served by two fresh servers: identical streams,
    every token in the vocabulary, one graph launch and 1 / sync_every host
    syncs a single round, at most ``expected_dispatches_per_round()`` model
    dispatches a cascade round. Before serving, the device checks of
    ``_sampling_on_card``; then one captured sampled round against the
    eager one. Rounds are timed beside phases 7 and 8's greedy ones."""
    from repro_torch.serving.sampler import SamplingParams

    cfg, prompts, ar_streams = served["cfg"], served["prompts"], served["ar_streams"]
    _sampling_on_card(torch, cfg.vocab_size)
    greedy0 = SamplingParams(temperature=0.0)
    stoch = SamplingParams(**STOCH)
    seeded = [SamplingParams(**STOCH, seed=11 + i) for i in range(len(prompts))]
    make = served["server"]
    launches = {k: 0 for k in _counters()}

    def count(rec):
        for k in launches:
            launches[k] += rec["launches"][k]

    zero_runs = [
        ("tree_fused dense, single", dict(mode="tree_fused", paged=False, round_mode="single"), ()),
        ("chain_fused paged, single, prefill_chunk=64, 200-token prompt admitted mid-stream",
         dict(mode="chain_fused", paged=True, round_mode="single", prefill_chunk=64), (3,)),
        ("tree_fused dense, split", dict(mode="tree_fused", paged=False, round_mode="split"), ()),
        ("cascade_fused mixing dense", dict(mode="cascade_fused", paged=False, draft=False,
                                            round_mode="split"), ()),
        ("legacy LS0.5 dense", dict(mode="legacy", paged=False, round_mode="split"), ()),
    ]
    for name, kw, late in zero_runs:
        srv = make(sampling=greedy0, **kw)
        rec = _serve(torch, srv, prompts, ar_streams, late=late)
        count(rec)
        extra = ""
        if srv.round_mode == "single":
            _check_single(name, rec, srv)
            extra = (f", {rec['host_syncs'] / rec['rounds']:.2f} host syncs and "
                     f"{rec['graph_replays'] / rec['rounds']:.2f} graph launches per round")
        else:
            disp = _check_dispatches(name, rec, srv)
            extra = (f", dispatches per round max {max(disp)} "
                     f"(expected {srv.expected_dispatches_per_round()})")
        if srv.prefill_chunk and rec["prefill_rounds"] < 4:
            raise AssertionError(f"{name}: {rec['prefill_rounds']} prefill rounds")
        print(f"[phase 9] temperature 0, {name}: {rec['requests']} requests identical to AR | "
              f"{_line(rec)}{extra} | launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        del srv
        torch.cuda.empty_cache()

    greedy = served["greedy"]
    for name, kw, ref in (
            ("tree_fused dense, single", dict(mode="tree_fused", paged=False, round_mode="single"),
             "tree_fused dense"),
            ("cascade_fused mixing dense", dict(mode="cascade_fused", paged=False, draft=False,
                                                round_mode="split"), "cascade_fused mixing dense")):
        recs, streams = [], []
        for _ in range(2):
            srv = make(sampling=stoch, **kw)
            rec = _serve(torch, srv, prompts, None, sampling=seeded)
            count(rec)
            recs.append(rec)
            streams.append(sorted((i, s[:GEN_TOKENS]) for i, s in rec["streams"]))
            if srv.round_mode == "single":
                _check_single(name, rec, srv)
                cap = (f"capture {srv.capture_s * 1e3:.1f} ms (greedy "
                       f"{greedy[ref]['capture_s'] * 1e3:.1f}), graph pool "
                       f"{srv.graph_pool_bytes / 2**20:.1f} MiB (greedy "
                       f"{greedy[ref]['pool'] / 2**20:.1f})")
                kinds = ", ".join(f"{rec['ms_' + k][1]} that {text} at {rec['ms_' + k][0]:.2f} ms "
                                  f"(greedy {greedy[ref]['ms_' + k][0]:.2f})"
                                  for k, text in (("ran", "ran the draft"),
                                                  ("skipped", "skipped it")) if rec["ms_" + k][1])
                detail = (f"{rec['host_syncs'] / rec['rounds']:.2f} host syncs and "
                          f"{rec['graph_replays'] / rec['rounds']:.2f} graph launches per round; "
                          f"{kinds}; {cap}")
            else:
                disp = _check_dispatches(name, rec, srv)
                # the Eq. 4 observations the routing warms up on (min_obs each)
                bank = srv.bank
                obs = [srv.acceptance.counts(bank.slot_key(0, b))
                       + srv.acceptance.counts(bank.direct_key(b)) for b in range(len(prompts))]
                rescored = [sum(1 for st in r["per_step"] if st["rescore_dispatches"])
                            for r in (rec, greedy[ref])]
                detail = (f"dispatches per round mean {sum(disp) / len(disp):.2f}, max {max(disp)} "
                          f"(expected at most {srv.expected_dispatches_per_round()}), "
                          f"{rescored[0]} rounds rescored (greedy {rescored[1]}), Eq. 4 "
                          f"observations of the last requests per slot {obs} (min_obs "
                          f"{srv.min_obs})")
            print(f"[phase 9] T 0.8 top-k 20 top-p 0.9, seeds 11-{10 + len(prompts)}, {name}: "
                  f"{_line(rec)} (greedy {greedy[ref]['ms_per_round']:.2f} ms, "
                  f"{greedy[ref]['tokens_per_slot_round']:.2f} tokens per slot-round) | {detail} | "
                  "launches per round: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
            del srv
            torch.cuda.empty_cache()
        if streams[0] != streams[1]:
            raise AssertionError(f"{name}: two fresh sampled servers gave different streams")
        toks = [t for _, s in streams[0] for t in s]
        if len(streams[0]) != len(prompts) or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name}: streams {streams[0]}")
        print(f"[phase 9] {name}: the two servers' stochastic streams are identical "
              f"({len(toks)} tokens, all in the vocabulary; "
              f"{sum(t == a for (i, s) in streams[0] for t, a in zip(s, ar_streams[i]))} "
              f"agree with AR position by position)")
    _replay_equals_eager(torch, served, seeded)
    print(f"[phase 9] kernel launches of the served runs: {launches}")
    for k, v in launches.items():
        results[k]["launches"] += v


# ------------------------------------------------------------------ phase 10
LOOP_TASKS = ("summarization", "rag", "math", "translation")
LOOP_SPANS = {"admit", "drain", "dispatch", "route", "retire"}


def _loop_prompts(vocab: int):
    """Eight requests of the synthetic Spec-Bench suite, two of each task, 96
    tokens each (``repro_torch.data.make_task_prompts``)."""
    from repro_torch.data import SPEC_TASKS, make_task_prompts

    return [p for task in LOOP_TASKS for p in make_task_prompts(SPEC_TASKS[task], 2, vocab)]


def _serve_loop(torch, srv, prompts, ar_streams) -> dict:
    """Serve ``prompts`` (GEN_TOKENS each) through ``ServeLoop`` on the
    server's slots, more requests than slots, so slots are re-admitted.
    Every stream must equal its AR stream, the telemetry must reconcile
    exactly (accepted = delivered + overshoot + unrouted + discarded +
    leftover), a single-round server's device buffer must equal the fold of
    its drained ring, the latency histograms must be populated and the
    loop's spans present. Returns a record of the run."""
    from repro_torch.serving import Request, RequestScheduler, ServeLoop, TraceRecorder

    sched = RequestScheduler(srv.B)
    reqs = [Request(prompt=p, max_new_tokens=GEN_TOKENS) for p in prompts]
    for r in reqs:
        sched.submit(r)
    trace = TraceRecorder()
    loop = ServeLoop(srv, sched, trace=trace)
    torch.cuda.synchronize()
    _reset_counts()
    graph0, st0 = dict(srv.graph_launches), dict(srv.stats)
    t0 = time.perf_counter()
    loop.run()
    leftover = srv.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    for k, v in srv.graph_launches.items():
        counts[k] += v - graph0.get(k, 0)
    st = {k: v - st0[k] for k, v in srv.stats.items()}
    for i, r in enumerate(reqs):
        if r.generated != ar_streams[i][:GEN_TOKENS]:
            raise AssertionError(f"request {i}: the served stream left AR:\n"
                                 f"AR     {ar_streams[i][:GEN_TOKENS]}\nserved {r.generated}")
    tot = srv.telemetry_totals()
    snap = srv.metrics.snapshot()
    c = snap["counters"]
    delivered = sum(len(r.generated) for r in reqs)
    parts = {k: int(c.get(f"serve_{k}_tokens_total", 0))
             for k in ("overshoot", "unrouted", "discarded")}
    parts["leftover"] = sum(len(v) for v in leftover.values())
    accepted = int(tot["accepted"].sum())
    if accepted != delivered + sum(parts.values()):
        raise AssertionError(f"telemetry does not reconcile: accepted {accepted}, delivered "
                             f"{delivered}, {parts}")
    if srv.round_mode == "single":
        bad = [k for k, v in srv.ring_totals.items() if not (tot[k] == v).all()]
        if bad:
            raise AssertionError(f"the device telemetry {bad} differs from the ring fold")
    hists = snap["histograms"]
    lat = {}
    for h in ("ttft", "tpot", "itl"):
        rec = hists[f"serve_request_{h}_seconds"]
        if rec["count"] <= 0:
            raise AssertionError(f"no {h} observations")
        lat[h] = (rec["sum"] / rec["count"] * 1e3, rec["count"])
    spans = {e["name"] for e in trace.events}
    if not LOOP_SPANS <= spans:
        raise AssertionError(f"loop spans {spans} lack {LOOP_SPANS - spans}")
    _round_contracts(srv)
    return dict(requests=len(sched.finished), rounds=st["steps"], wall_s=wall,
                ms_per_round=wall / st["steps"] * 1e3, delivered=delivered, accepted=accepted,
                parts=parts, host_syncs=st["host_syncs"], graph_replays=st["graph_replays"],
                target_calls=st["target_calls"], launches=counts, lat=lat,
                summary=srv.metrics_summary(),
                launches_per_round={k: v / st["steps"] for k, v in counts.items()})


def _baselines(torch, cfg, params, prompt, ar) -> dict:
    """The seven single-stream baselines the CLI offers besides DyTC (AR,
    PLD k=8, and SD, VC, HC, VC+HC and Tree over LS0.4), at its settings, and
    Tr+VC over LS0.4; GEN_TOKENS each, every stream equal to AR."""
    from repro_torch.core import SpecEngine, TreeVCScheduler, layer_sparsity
    from repro_torch.launch.serve import SCHEDULERS

    makers = {name: SCHEDULERS[name] for name in ("ar", "pld", "swift", "vc", "hc", "vchc", "tree")}
    makers["trvc"] = lambda e, c: TreeVCScheduler(e, layer_sparsity(c, 0.4))
    launches = {k: 0 for k in _counters()}
    for name, build in makers.items():
        eng = SpecEngine(cfg, params, max_len=1024)
        eng.start(prompt)
        sched = build(eng, cfg)
        torch.cuda.synchronize()
        before = _read_counts()
        t0 = time.perf_counter()
        out = sched.generate(GEN_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in _read_counts().items()}
        for k, v in counts.items():
            launches[k] += v
        st = eng.stats
        if out != ar[:GEN_TOKENS]:
            raise AssertionError(f"baseline {name} left AR:\nAR       {ar[:GEN_TOKENS]}\n{name:8s} {out}")
        print(f"[phase 10] baseline {name:5s} ({type(sched).__name__}): {GEN_TOKENS} tokens identical "
              f"to AR | {st['rounds']} rounds, {st['target_calls']} target calls, "
              f"{st['draft_calls']} draft calls, {st['accepted_tokens'] / st['rounds']:.2f} tokens per "
              f"round, {wall:.3f} s ({wall / st['rounds'] * 1e3:.2f} ms per round) | launches per "
              "round: " + ", ".join(f"{k} {v / st['rounds']:.2f}" for k, v in counts.items()))
        del eng, sched
    return launches


def phase_serving(torch, served: dict, results: dict) -> None:
    """The serving entry point at vicuna-7b width, float32, random weights
    (seed 0), one card: the seven single-stream baselines on phase 3's
    128-token prompt; ``ServeLoop`` over eight requests of the synthetic
    task suite on four slots (each slot re-admitted once) in tree_fused
    dense single rounds at sync_every=4, chain_fused paged single rounds
    with prefill_chunk=64, and the mixing cascade in split rounds; and
    tree_fused single with the round telemetry on against off, in turns:
    the same graph launches, host syncs, kernels and tokens."""
    from repro_torch.core import SpecEngine

    cfg, params, make = served["cfg"], served["params"], served["server"]
    launches = _baselines(torch, cfg, params, served["prompts"][2], served["ar_streams"][2])

    prompts = _loop_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    ar = []
    for p in prompts:
        eng = SpecEngine(cfg, params, max_len=1024)
        eng.start(p)
        ar.append(eng.generate_ar(GEN_TOKENS))
        del eng
    print(f"[phase 10] AR streams of the {len(prompts)} requests ({', '.join(LOOP_TASKS)}, two each, "
          f"{len(prompts[0])} tokens) in {time.perf_counter() - t0:.1f} s")
    for name, kw in (
            ("tree_fused dense, single, sync_every=4",
             dict(mode="tree_fused", paged=False, round_mode="single", sync_every=4)),
            ("chain_fused paged, single, prefill_chunk=64",
             dict(mode="chain_fused", paged=True, round_mode="single", prefill_chunk=64)),
            ("cascade_fused mixing dense, split", dict(mode="cascade_fused", paged=False,
                                                       draft=False, round_mode="split"))):
        srv = make(**kw)
        rec = _serve_loop(torch, srv, prompts, ar)
        for k, v in rec["launches"].items():
            launches[k] += v
        summ, lat = rec["summary"], rec["lat"]
        # the ring drains every sync_every rounds and at each admission
        if srv.round_mode == "single" and (
                rec["graph_replays"] != rec["rounds"]
                or rec["host_syncs"] > rec["rounds"] // srv.sync_every + len(prompts) + 1):
            raise AssertionError(f"{name}: {rec['graph_replays']} replays and {rec['host_syncs']} "
                                 f"host syncs in {rec['rounds']} rounds")
        casc = (f", cascade acceptance by level {summ['cascade_acceptance']}, routed rounds "
                f"{summ['cascade_routed_rounds']}" if "cascade_acceptance" in summ else "")
        print(f"[phase 10] ServeLoop {name}: {rec['requests']} requests on {srv.B} slots identical "
              f"to AR | {rec['rounds']} rounds, {rec['wall_s']:.3f} s ({rec['ms_per_round']:.2f} ms "
              f"per round), {rec['delivered'] / rec['wall_s']:.1f} delivered tokens/s, "
              f"{rec['host_syncs'] / rec['rounds']:.2f} host syncs and "
              f"{rec['graph_replays'] / rec['rounds']:.2f} graph launches per round | telemetry: "
              f"accepted {rec['accepted']} = delivered {rec['delivered']} + {rec['parts']}, "
              f"accepted per round {summ['accepted_per_round']:.3f}, spec accept rate "
              f"{summ['spec_accept_rate']:.3f}{casc} | mean TTFT {lat['ttft'][0]:.1f} ms, TPOT "
              f"{lat['tpot'][0]:.2f} ms, ITL {lat['itl'][0]:.2f} ms ({lat['itl'][1]} gaps) | "
              "launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        if srv.mode == "cascade_fused" and rec["launches"]["int8_matmul"] <= 0:
            raise AssertionError(f"{name}: the int8 level launched no W8A8 kernel")
        del srv
        torch.cuda.empty_cache()

    # telemetry on against off, in turns (off, on, on, off)
    runs = {True: [], False: []}
    for telem in (False, True, True, False):
        srv = make(mode="tree_fused", paged=False, round_mode="single", telemetry=telem)
        rec = _serve(torch, srv, served["prompts"], served["ar_streams"])
        for k, v in rec["launches"].items():
            launches[k] += v
        runs[telem].append((rec, srv.graph_pool_bytes))
        del srv
        torch.cuda.empty_cache()
    for key in ("graph_replays", "host_syncs", "tokens", "rounds", "launches", "streams"):
        vals = [rec[key] for telem in (True, False) for rec, _ in runs[telem]]
        if any(v != vals[0] for v in vals):
            raise AssertionError(f"telemetry on/off: {key} differs: {vals}")
    from repro_torch.analysis.contracts import assert_telemetry_transparent

    added = assert_telemetry_transparent(runs[False][0][0]["contracts"], runs[True][0][0]["contracts"])
    print(f"[phase 10] telemetry on against off, the captured rounds: the same segments and IF nodes, "
          f"no host node, every segment's nodes equal but the tail's, where telemetry adds {added}")
    rec = runs[True][0][0]
    print(f"[phase 10] tree_fused dense single, telemetry on against off (off, on, on, off): identical "
          f"streams, {rec['rounds']} rounds, {rec['graph_replays']} graph launches, "
          f"{rec['host_syncs']} host syncs, {rec['tokens']} tokens and kernel launches | ms per round "
          "on " + " / ".join(f"{r['ms_per_round']:.2f}" for r, _ in runs[True])
          + ", off " + " / ".join(f"{r['ms_per_round']:.2f}" for r, _ in runs[False])
          + " | rounds that skipped the draft on " + " / ".join(f"{r['ms_skipped'][0]:.2f}"
                                                              for r, _ in runs[True])
          + ", off " + " / ".join(f"{r['ms_skipped'][0]:.2f}" for r, _ in runs[False])
          + f" | graph pool on {runs[True][0][1] / 2**20:.1f} MiB, off {runs[False][0][1] / 2**20:.1f} MiB")
    _telemetry_cost(torch)
    print(f"[phase 10] kernel launches of the baselines, the loops and the on/off runs: {launches}")
    for k, v in launches.items():
        results[k]["launches"] += v


def _telemetry_cost(torch) -> None:
    """What the in-graph round telemetry adds to a single round: one
    ``accumulate_round`` at the server's shapes (B=4, budgets 0-5), its
    device kernels (profiler), its device time and its time by graph
    replay (each replay also pays the graph's fixed launch cost)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import telemetry as TM

    B, K = SERVER["max_batch"], SERVER["tree_expansions"]
    buf = TM.init_device_telemetry(TM.telemetry_schema(B, K), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {k: torch.randint(0, hi, (B,), generator=gen, device="cuda", dtype=torch.int32)
           for k, hi in (("n_acc", 6), ("drafted", 4), ("pld_have", 5), ("budget", K + 1))}
    live = torch.ones((B,), dtype=torch.bool, device="cuda")

    def fn():
        TM.accumulate_round(buf, out, live)

    iters = 20
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.count for e in evs) / iters
    busy = sum(e.self_device_time_total for e in evs) / iters / 1e3
    if kernels <= 0:
        raise AssertionError("the profiler recorded no kernel of accumulate_round")
    graph = _graph_ms(fn, lambda: None, iters=50)
    print(f"[phase 10] accumulate_round alone (B={B}, budgets 0-{K}): {kernels:.1f} device kernels "
          f"and {busy:.4f} ms of device time a call (profiler, {iters} calls), graph replay "
          f"{graph:.4f} ms (replay floor: phase 2's one-element add)")


def _cli(args, env, timeout: int = 600) -> tuple:
    """Run ``python -m repro_torch.launch.serve`` with ``args``; returns its
    summary (the last line) and its stdout."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args], cwd=HERE,
                          env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"serve {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    if summary.get("kind") != "serve_summary":
        raise AssertionError(f"serve {' '.join(args)}: last line {summary}")
    return summary, proc.stdout


def phase_cli(torch) -> None:
    """``python -m repro_torch.launch.serve`` as a subprocess on the card, at
    full width (the parent holds no model then): the DyTC single stream,
    and the batched server on the one-device mesh through ServeLoop with
    its /metrics endpoint, trace and JSONL sink."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    summary, out = _cli(["--scheduler", "dytc", "--tokens", "32"], env)
    if summary["delivered_tokens"] != 32 or summary["scheduler"] != "dytc":
        raise AssertionError(f"serve --scheduler dytc: {summary}")
    print(f"[phase 10] serve --scheduler dytc --tokens 32: exit 0 in {time.perf_counter() - t0:.1f} s | "
          f"{out.strip().splitlines()[-3]} | {summary['rounds']} rounds, {summary['target_calls']} "
          f"target calls, {summary['mean_accepted']:.2f} tokens per round")
    with tempfile.TemporaryDirectory() as tmp:
        trace, jsonl = os.path.join(tmp, "trace.json"), os.path.join(tmp, "summary.jsonl")
        args = ["--mesh", "model=1,data=1", "--mode", "tree_fused", "--batch", "4", "--tokens", "32",
                "--metrics-port", "0", "--trace-out", trace, "--metrics-jsonl", jsonl]
        t0 = time.perf_counter()
        summary, out = _cli(args, env)
        wall = time.perf_counter() - t0
        rate = summary["spec_accept_rate"]
        if summary["delivered_tokens"] != 128 or rate is None or not 0.0 <= rate <= 1.0:
            raise AssertionError(f"serve {' '.join(args)}: {summary}")
        with open(trace) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
        if not LOOP_SPANS <= spans:
            raise AssertionError(f"serve trace spans {spans} lack {LOOP_SPANS - spans}")
        with open(jsonl) as f:
            records = [json.loads(line) for line in f]
        if records != [summary]:
            raise AssertionError(f"serve JSONL records {records} != the summary line")
    lines = out.strip().splitlines()
    print(f"[phase 10] serve {' '.join(args[:8])} (metrics, trace, JSONL): exit 0 in {wall:.1f} s | "
          f"{next(x for x in lines if x.startswith('mode='))} | delivered {summary['delivered_tokens']}, "
          f"{summary['rounds']} rounds, {summary['host_syncs']} host syncs, spec accept rate "
          f"{rate:.3f}, accepted per round {summary['accepted_per_round']:.3f} | trace spans "
          f"{sorted(spans)}; the JSONL record equals the last line")


# ------------------------------------------------------------------ phase 11
# the recipe of the reference's benchmarks/common.py::trained_params, at
# vicuna-7b width: float32 params, gradients and two moments take 16 B a
# parameter, so 8 layers (1.88 B parameters, 30 GB) fit the card; 32 do not
TRAIN = dict(layers=8, steps=60, batch=8, seq=96, peak_lr=1e-3, warmup=10, corpus=60_000)


def _matmul_params(cfg) -> int:
    """Parameters that enter a matrix product for every token: each layer's
    projections and the LM head (the embedding is a gather)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = d * cfg.d_ff * (3 if cfg.mlp_gated else 2)
    return cfg.num_layers * (attn + mlp) + d * cfg.padded_vocab


def _split_step(torch, T, M, cfg, params, opt, batch) -> tuple:
    """One step of ``make_train_step``'s work in its three parts, each timed
    by CUDA events: forward (``loss_fn``), backward (``autograd.grad``) and
    the optimizer (``cosine_lr`` + ``adamw_update``). Returns (params, opt,
    (forward, backward, optimizer) ms, the peak device memory of each part)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    peaks = []

    def mark(i):
        ev[i].record()
        if i:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    leaves = [p.detach().requires_grad_() for p in M.tree_leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark(0)
    with torch.enable_grad():
        loss, _ = T.loss_fn(cfg, M.tree_unflatten(params, leaves), batch, remat=False)
        mark(1)
        grads = torch.autograd.grad(loss, leaves)
    mark(2)
    lr = T.cosine_lr(opt.step, peak=TRAIN["peak_lr"], warmup=TRAIN["warmup"], total=TRAIN["steps"])
    params, opt = T.adamw_update(params, M.tree_unflatten(params, grads), opt, lr=lr)
    mark(3)
    return params, opt, tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3)), peaks


def _train(torch, cfg, tmp: str) -> dict:
    """Train ``cfg`` from ``init_params(seed 0)`` through ``make_train_step``
    with TRAIN's recipe, check every step finite and the loss falling, save
    a checkpoint into ``tmp`` and read it back bitwise both ways, then time
    three more steps in their parts. Returns the numbers."""
    from repro_torch import training as T
    from repro_torch.bridge import params_from_checkpoint
    from repro_torch.data import lm_batches, synthetic_corpus
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED)
    opt = T.adamw_init(params)
    step = T.make_train_step(cfg, peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"],
                             total_steps=TRAIN["steps"], remat=False)
    it = lm_batches(synthetic_corpus(cfg.vocab_size, TRAIN["corpus"]), TRAIN["batch"], TRAIN["seq"])
    batches = [{"tokens": torch.as_tensor(next(it)["tokens"], device=params["embed"].device)}
               for _ in range(TRAIN["steps"] + 3)]
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(TRAIN["steps"])]
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN["steps"]):
        ev[i][0].record()
        params, opt, m = step(params, opt, batches[i])
        ev[i][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in ev]
    curve = {k: torch.stack([m[k] for m in metrics]).tolist() for k in ("ce", "loss", "lr", "grad_norm")}
    for i in list(range(0, TRAIN["steps"], 10)) + [TRAIN["steps"] - 1]:
        print(f"[phase 11] step {i:2d}: ce {curve['ce'][i]:.4f}, lr {curve['lr'][i]:.2e}, "
              f"grad_norm {curve['grad_norm'][i]:.4f}, {step_ms[i]:.2f} ms")
    bad = [i for i in range(TRAIN["steps"])
           if not all(math.isfinite(curve[k][i]) for k in ("loss", "grad_norm"))]
    if bad:
        raise AssertionError(f"phase 11: steps {bad} have a loss or grad_norm that is not finite")
    last5 = sum(curve["ce"][-5:]) / 5
    if last5 > curve["ce"][0] - 1.0:
        raise AssertionError(f"phase 11: the mean ce of the last 5 steps, {last5:.4f}, is not 1 nat "
                             f"below step 0's {curve['ce'][0]:.4f}")

    t0 = time.perf_counter()
    T.save_checkpoint(tmp, params, opt, step=TRAIN["steps"])
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    t0 = time.perf_counter()
    trained = params_from_checkpoint(tmp, cfg)
    read_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(M.tree_leaves(trained), M.tree_leaves(params)))
    p2, o2, ck_step = T.load_checkpoint(tmp, params, opt)
    same_all = ck_step == TRAIN["steps"] and all(
        torch.equal(a, b) for a, b in zip(M.tree_leaves((p2, o2)), M.tree_leaves((params, opt))))
    del p2, o2
    print(f"[phase 11] checkpoint ({size / 1e9:.2f} GB in {len(os.listdir(tmp))} files): saved in "
          f"{save_s:.1f} s, params_from_checkpoint in {read_s:.1f} s, bitwise equal: params "
          f"{same}, load_checkpoint params, AdamW state and step {same_all}")
    if not (same and same_all):
        raise AssertionError("phase 11: the checkpoint does not give back the trained state bitwise")

    split = []
    for i in range(3):
        params, opt, ms, split_peaks = _split_step(torch, T, M, cfg, params, opt,
                                                   batches[TRAIN["steps"] + i])
        split.append(ms)
    del params, opt, metrics
    torch.cuda.empty_cache()
    return dict(trained=trained, step_ms=step_ms, wall=wall, peak=peak, curve=curve,
                split=split, split_peaks=split_peaks, last5=last5)


def _serve_model(torch, cfg, params, prompts) -> dict:
    """AR and DyTC (the scaling hierarchy) on each prompt, every DyTC stream
    equal to AR, then ``ServeLoop`` over the prompts on four slots in
    tree_fused dense single rounds (sync_every=4, LS0.5), every stream equal
    to AR. Returns the numbers and the kernel launches."""
    from repro_torch.core import SpecEngine, layer_sparsity
    from repro_torch.serving import BatchedSpecServer

    _reset_counts()
    ar, ar_s, dytc = [], 0.0, dict(rounds=0, accepted=0, wall=0.0, target_calls=0)
    for p in prompts:
        eng = SpecEngine(cfg, params, max_len=1024)
        eng.start(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ar.append(eng.generate_ar(GEN_TOKENS))
        torch.cuda.synchronize()
        ar_s += time.perf_counter() - t0
        del eng
        out, st, wall, finite = _generate(torch, cfg, params, p, dytc=True)
        if out != ar[-1] or not finite:
            raise AssertionError(f"phase 11: DyTC left AR (finite logits {finite}):\n"
                                 f"AR   {ar[-1]}\nDyTC {out}")
        dytc["rounds"] += st["rounds"]
        dytc["accepted"] += st["accepted_tokens"]
        dytc["target_calls"] += st["target_calls"]
        dytc["wall"] += wall
    launches = _read_counts()
    srv = BatchedSpecServer(cfg, params, mode="tree_fused", draft_spec=layer_sparsity(cfg, 0.5),
                            paged=False, round_mode="single", sync_every=4, **SERVER)
    loop = _serve_loop(torch, srv, prompts, ar)
    loop["draft_rounds"] = srv.stats["draft_rounds"]
    del srv
    torch.cuda.empty_cache()
    for k, v in loop["launches"].items():
        launches[k] += v
    return dict(ar_ms=ar_s / (len(prompts) * GEN_TOKENS) * 1e3, dytc=dytc, loop=loop,
                launches=launches)


def phase_training(torch, results: dict) -> None:
    """Attention-only training on the card: vicuna-7b at full width and 8
    layers, float32, trained from seed 0 with the reference benchmarks'
    recipe through ``repro_torch.training``; the checkpoint round trip; then
    the trained model (read back with ``params_from_checkpoint``) and the
    same config with random seed-0 weights served on phase 10's requests."""
    import tempfile

    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves

    before = torch.cuda.memory_allocated()
    gc.collect()                   # earlier phases' servers may sit in reference cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[phase 11] device memory held before training: {before / 2**20:.1f} MiB, "
          f"{held / 2**20:.1f} MiB after a garbage collection")
    if held > 2**30:
        live = sorted((o for o in gc.get_objects() if torch.is_tensor(o) and o.is_cuda),
                      key=lambda t: -t.untyped_storage().nbytes())[:5]
        raise AssertionError(f"phase 11: {held / 2**30:.2f} GiB still allocated before training; "
                             f"the largest live tensors: {[tuple(t.shape) for t in live]}")
    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=TRAIN["layers"], dtype="float32")
    n_params = sum(math.prod(p.shape) for p in tree_leaves(init_params(cfg, device="meta")))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    flops = 6 * _matmul_params(cfg) * tokens
    with tempfile.TemporaryDirectory() as tmp:
        print(f"[phase 11] vicuna-7b width, {cfg.num_layers} layers, float32: {n_params / 1e9:.3f} B "
              f"parameters ({16 * n_params / 1e9:.1f} GB with gradients and AdamW moments); "
              f"{TRAIN['steps']} steps of {TRAIN['batch']} x {TRAIN['seq']} tokens, peak lr "
              f"{TRAIN['peak_lr']}, warm-up {TRAIN['warmup']}; checkpoint directory on a disk with "
              f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free")
        tr = _train(torch, cfg, tmp)
    served = {"trained": tr.pop("trained")}
    ms = sorted(tr["step_ms"][5:])
    med = ms[len(ms) // 2]
    results["p11_step_ms"] = med
    fwd, bwd, opt = (sum(s[i] for s in tr["split"]) / len(tr["split"]) for i in range(3))
    print(f"[phase 11] {TRAIN['steps']} steps in {tr['wall']:.2f} s; one step (CUDA events, steps "
          f"5-{TRAIN['steps'] - 1}): median {med:.2f} ms, min {ms[0]:.2f}, max {ms[-1]:.2f}; split "
          f"(3 more steps): forward {fwd:.2f} ms, backward {bwd:.2f}, optimizer {opt:.2f}; "
          f"{tokens / med * 1e3:.0f} tokens/s; model FLOPs 6 x {_matmul_params(cfg) / 1e9:.3f} B "
          f"x {tokens} = {flops / 1e12:.2f} TFLOP a step, {flops / (med / 1e3) / 1e12:.2f} TFLOP/s "
          f"= {flops / (med / 1e3) / PEAK_FLOPS['float32']:.3f} of 67 TFLOP/s float32; peak "
          f"device memory {tr['peak'] / 2**30:.2f} GiB (forward / backward / optimizer of the "
          f"last split step: " + " / ".join(f"{b / 2**30:.2f}" for b in tr["split_peaks"])
          + f" GiB); ce {tr['curve']['ce'][0]:.4f} at step 0, {tr['last5']:.4f} over the last 5")
    if any(p.requires_grad for p in tree_leaves(served["trained"])):
        raise AssertionError("phase 11: the served params record autograd")

    prompts = _loop_prompts(cfg.vocab_size)
    rows = {}
    for name in ("trained", "random seed 0"):
        params = served.pop(name) if name in served else init_params(cfg, SEED)
        t0 = time.perf_counter()
        rec = _serve_model(torch, cfg, params, prompts)
        del params
        torch.cuda.empty_cache()
        if rec["launches"]["flash_decode"] <= 0 or rec["launches"]["tree_attention"] <= 0:
            raise AssertionError(f"phase 11: {name}: launches {rec['launches']} do not show the "
                                 "flash decode and tree attention kernels")
        for k, v in rec["launches"].items():
            results[k]["launches"] += v
        d, lp = rec["dytc"], rec["loop"]
        rows[name] = rec
        print(f"[phase 11] {name} weights, {len(prompts)} requests x {GEN_TOKENS} tokens "
              f"({time.perf_counter() - t0:.1f} s): DyTC streams identical to AR | AR "
              f"{rec['ar_ms']:.2f} ms a token; DyTC {d['rounds']} rounds, "
              f"{d['accepted'] / d['rounds']:.3f} tokens per round, {d['wall'] / d['rounds'] * 1e3:.2f} "
              f"ms a round | ServeLoop tree_fused single LS0.5, 4 slots: identical to AR, "
              f"{lp['rounds']} rounds ({lp['draft_rounds']} ran the draft), "
              f"{lp['accepted'] / lp['rounds']:.3f} tokens per round, "
              f"{lp['summary']['accepted_per_round']:.3f} per slot-round, spec accept rate "
              f"{lp['summary']['spec_accept_rate']:.3f}, {lp['ms_per_round']:.2f} ms a round | "
              f"launches: {rec['launches']}")
    t, r = rows["trained"], rows["random seed 0"]
    print("[phase 11] trained against random weights: DyTC tokens per round "
          f"{t['dytc']['accepted'] / t['dytc']['rounds']:.3f} / "
          f"{r['dytc']['accepted'] / r['dytc']['rounds']:.3f}; ServeLoop tokens per round "
          f"{t['loop']['accepted'] / t['loop']['rounds']:.3f} / "
          f"{r['loop']['accepted'] / r['loop']['rounds']:.3f}, per slot-round "
          f"{t['loop']['summary']['accepted_per_round']:.3f} / "
          f"{r['loop']['summary']['accepted_per_round']:.3f}, ms a round "
          f"{t['loop']['ms_per_round']:.2f} / {r['loop']['ms_per_round']:.2f}")


# ------------------------------------------------------------------ phase 12
# the other attention-only models at full width, random weights from seed 0;
# internlm2-20b cut to 24 of its 48 layers in float32 (42.0 GB of weights;
# all 48 would take 79.4 GB)
OTHER_MODELS = (("stablelm-1.6b", {}), ("starcoder2-3b", {}), ("gemma3-1b", {}),
                ("internlm2-20b", dict(num_layers=24)))


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def _first_divergence(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _single_stream(torch, cfg, params, prompts, label: str, exact: bool = True,
                   phase: int = 12) -> list:
    """AR and DyTC (LS0.5 over PLD: ``SpecEngine``) on each prompt,
    GEN_TOKENS each. Prints tokens a round, ms a token and the draft's cost
    coefficient c (the engine's measured draft / target latency); with
    ``exact`` every DyTC stream must equal AR, else the first divergence is
    printed. Returns the AR streams."""
    from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, layer_sparsity
    from repro_torch.core.dsia import PLD_SPEC

    spec = layer_sparsity(cfg, 0.5)
    ar_streams = []
    for i, prompt in enumerate(prompts):
        runs = {}
        for name in ("AR", "DyTC"):
            eng = SpecEngine(cfg, params)
            eng.start(prompt)
            sched = (DyTCScheduler(eng, [spec, PLD_SPEC]) if name == "DyTC"
                     else ARScheduler(eng))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sched.generate(GEN_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not bool(torch.isfinite(eng.last_logits).all()):
                raise AssertionError(f"{label}: prompt {i}: non-finite logits ({name})")
            runs[name] = (out, dict(eng.stats), wall, eng.costs.c_hat(spec.name, spec.prior_c))
            del eng, sched
        (ar, _, ar_wall, _), (dy, st, dy_wall, c) = runs["AR"], runs["DyTC"]
        ar_streams.append(ar)
        div = _first_divergence(ar, dy)
        # c measured: a draft call's mean wall time over a target call's
        c_ms = (st["draft_time"] / st["draft_calls"] / (st["verify_time"] / st["target_calls"])
                if st["draft_calls"] else float("nan"))
        print(f"[phase {phase}] {label} prompt {i} ({len(prompt)} tokens): AR "
              f"{ar_wall / GEN_TOKENS * 1e3:.2f} ms a token | DyTC {st['rounds']} rounds, "
              f"{st['accepted_tokens'] / st['rounds']:.2f} tokens a round, "
              f"{dy_wall / GEN_TOKENS * 1e3:.2f} ms a token, {st['draft_calls']} {spec.name} draft "
              f"calls, c: draft call / target call {c_ms:.3f} by wall time, the tracker's c_hat "
              f"{c:.3f} (prior {spec.prior_c:.3f}) | identical={div is None}"
              + ("" if div is None else f", first divergence at token {div}"))
        if exact and div is not None:
            raise AssertionError(f"{label}: prompt {i}: DyTC left AR at token {div}:\n"
                                 f"AR   {ar}\nDyTC {dy}")
    return ar_streams


def _serve_single(torch, cfg, params, prompts, ar_streams, label: str, launches: dict,
                  phase: int = 12, **kw) -> dict:
    """One BatchedSpecServer run in single rounds (LS0.5, phase 6's
    settings unless ``kw`` overrides them): every stream equal to AR (none
    held with ``ar_streams`` None), one graph launch and one host sync a
    round."""
    from repro_torch.core import layer_sparsity
    from repro_torch.serving import BatchedSpecServer

    srv_kw = dict(SERVER, mode="tree_fused", paged=False, page_size=PAGE, round_mode="single")
    srv_kw.update(kw)
    srv = BatchedSpecServer(cfg, params, draft_spec=layer_sparsity(cfg, 0.5), **srv_kw)
    if srv._graph is None:
        raise AssertionError(f"{label}: no CUDA graph was captured")
    rec = _serve(torch, srv, prompts, ar_streams)
    _check_single(label, rec, srv)
    _check_launches(label, rec["launches"], srv.paged)
    exec_text = (f"slice exec, {len(srv._layer_ids)} layers" if srv._layer_ids is not None
                 else f"mask exec, {int(srv._gates.sum())} of {cfg.num_layers} gates open")
    held = "identical to AR" if ar_streams is not None else "not held to AR"
    print(f"[phase {phase}] {label}: {rec['requests']} requests {held} | " + _line(rec)
          + f", {rec['draft_rounds']} rounds drafted ({exec_text}), "
          f"{rec['graph_replays'] / rec['rounds']:.2f} graph launches and "
          f"{rec['host_syncs'] / rec['rounds']:.2f} host syncs a round, capture "
          f"{srv.capture_s * 1e3:.1f} ms | launches per round: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
    for k, v in rec["launches"].items():
        launches[k] += v
    del srv
    torch.cuda.empty_cache()
    return rec


def _long_prompts(vocab: int):
    """Two prompts past gemma3's 1024-token window, made of repeated motifs:
    1100 tokens (a 100-token motif 11 times) and 1056 (a 96-token motif)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    return [np.tile(rng.integers(0, vocab, size=m), n).astype(np.int32)
            for m, n in ((100, 11), (96, 11))]


def phase_models(torch, results: dict) -> None:
    """The other attention-only models at full width, random weights from
    seed 0, one at a time (each freed before the next):

    (a) float32 single stream: AR and DyTC (LS0.5) on phase 3's three
        prompts, every stream equal to AR, for stablelm-1.6b (hd 64),
        starcoder2-3b (GQA rep 12, the 2-matrix GeLU MLP), gemma3-1b (hd
        288, MQA, 22 sliding and 4 global layers: mask exec) and
        internlm2-20b (GQA rep 6) at 24 of its 48 layers;
    (b) the batched server in single rounds, ``tree_fused`` dense, B=4,
        phase 6's four prompts, every stream equal to AR, one graph launch
        a round; for gemma3 also paged and ``chain_fused`` paged with
        chunked prefill (64 a round): single rounds over a mixed stack;
    (c) gemma3 past its window: two prompts of 1100 and 1056 tokens,
        ``max_len`` 2048, AR, DyTC and ``tree_fused`` single, every stream
        equal to AR (the window mask cuts keys on 22 of 26 layers);
    (d) starcoder2 in ``cascade_fused`` mixing (LS0.4 over LS0.6+Q8), split
        rounds: streams equal AR and the W8A8 kernel on the 2-matrix MLP;
    (e) internlm2-20b at all 48 layers in bfloat16 (39.7 GB), AR and DyTC,
        not held to AR (as phase 4): the first divergence is printed.

    Prints the memory allocated at the start and each model's peak."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.serving import BatchedSpecServer

    t_phase = time.perf_counter()
    print(f"[phase 12] memory allocated at the start: {_gib(torch.cuda.memory_allocated())}")
    launches = dict.fromkeys(_counters(), 0)

    def count(fn, *args, **kw):
        _reset_counts()
        out = fn(*args, **kw)
        for k, v in _read_counts().items():
            launches[k] += v
        return out

    def load(name, dtype, **kw):
        cfg = dataclasses.replace(get_config(name), dtype=dtype, **kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, SEED)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        # init_params draws in place, one layer at a time: its peak is the
        # params plus at most one 2^26-element float32 temporary
        print(f"[phase 12] {name} {dtype}, {cfg.num_layers} layers, d {cfg.d_model}, heads "
              f"{cfg.num_heads} / kv {cfg.num_kv_heads}, hd {cfg.resolved_head_dim()}, d_ff "
              f"{cfg.d_ff}{'' if cfg.mlp_gated else ' (2-matrix MLP)'}, vocab {cfg.vocab_size}: "
              f"{n / 1e9:.3f} B parameters, {_gib(n * torch.finfo(getattr(torch, dtype)).bits // 8)}"
              f" in {time.perf_counter() - t0:.1f} s; peak memory of the draw "
              f"{_gib(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        return cfg, params

    def done(name):
        torch.cuda.synchronize()
        print(f"[phase 12] {name}: peak memory serving {_gib(torch.cuda.max_memory_allocated())}")
        gc.collect()
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 2)
    for name, kw in OTHER_MODELS:
        cfg, params = load(name, "float32", **kw)
        label = name + (f" ({cfg.num_layers} layers)" if kw else "")
        prompts = _prompts(cfg.vocab_size)
        ar = count(_single_stream, torch, cfg, params, prompts, label)
        long_prompt = np.tile(rng.integers(0, cfg.vocab_size, size=50), 4).astype(np.int32)
        prompts = prompts + [long_prompt]
        ar = ar + [count(_generate, torch, cfg, params, long_prompt, False)[0]]
        _serve_single(torch, cfg, params, prompts, ar, f"{label} tree_fused dense single",
                      launches)
        if name == "gemma3-1b":
            results["p17_gemma"] = dict(prompts=prompts, ar=ar)
            _serve_single(torch, cfg, params, prompts, ar, f"{label} tree_fused paged single",
                          launches, paged=True)
            _serve_single(torch, cfg, params, prompts, ar,
                          f"{label} chain_fused paged single, prefill_chunk=64", launches,
                          mode="chain_fused", paged=True, prefill_chunk=64)
            # (c) past the window
            longs = _long_prompts(cfg.vocab_size)
            long_ar = count(_single_stream, torch, cfg, params, longs, f"{label} past its window")
            _serve_single(torch, cfg, params, longs, long_ar,
                          f"{label} past its window, tree_fused dense single", launches,
                          max_batch=2, max_len=2048)
        if name == "starcoder2-3b":
            # (d) the cascade, its int8 level on the W8A8 kernel
            srv = BatchedSpecServer(cfg, params, mode="cascade_fused", round_mode="split",
                                    paged=False, **SERVER)
            if srv.bank.int8_exec != "kernel":
                raise AssertionError(f"{label}: int8_exec resolved to {srv.bank.int8_exec!r}")
            rec = _serve(torch, srv, prompts, ar)
            disp = _check_dispatches(f"{label} cascade_fused", rec, srv)
            _check_launches(f"{label} cascade_fused", rec["launches"], False)
            w8a8 = rec["launches"]["int8_matmul"]
            print(f"[phase 12] {label} cascade_fused mixing dense split: {rec['requests']} requests "
                  f"identical to AR | " + _line(rec) + f", dispatches per round max {max(disp)} of "
                  f"{srv.expected_dispatches_per_round()} | bank {[lv.name for lv in srv.bank.levels]}, "
                  f"param_bytes {_gib(srv.bank.param_bytes)} | W8A8 launches {w8a8} "
                  f"({w8a8 / rec['rounds']:.2f} a round) | launches per round: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
            if w8a8 <= 0:
                raise AssertionError(f"{label}: the cascade's int8 level launched no W8A8 kernel")
            for k, v in rec["launches"].items():
                launches[k] += v
            del srv
        del params
        done(label)
    # (e) internlm2-20b at full depth in bfloat16
    cfg, params = load("internlm2-20b", "bfloat16")
    count(_single_stream, torch, cfg, params, _prompts(cfg.vocab_size),
          f"internlm2-20b bfloat16 ({cfg.num_layers} layers)", exact=False)
    del params
    done("internlm2-20b bfloat16")
    print(f"[phase 12] kernel launches: {launches}")
    for name in ("flash_decode", "tree_attention", "flash_decode_paged", "int8_matmul", "set_cond"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 12: {name} was not launched")
        results[name]["launches"] += launches[name]
    print(f"[phase 12] {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 13
# the MoE models at full width, random weights from seed 0: qwen2-moe-a2.7b
# at all 24 layers (14.3 B parameters, ~53 GiB in float32), then the same in
# bfloat16; mixtral-8x22b cut to 4 of its 56 layers in float32 (a layer holds
# 2.5 B parameters, 10 GB: 4 layers take ~39 GiB)
MOE_MODELS = (("qwen2-moe-a2.7b", "float32", {}), ("qwen2-moe-a2.7b", "bfloat16", {}),
              ("mixtral-8x22b", "float32", dict(num_layers=4)))


def _largest_layer_leaf(params) -> int:
    """Bytes of the largest one-layer slice of a stacked leaf."""
    from repro_torch.models.model import tree_leaves

    return max(t[0].numel() * t.element_size() for seg in params["segments"] for unit in seg
               for t in tree_leaves(unit))


def phase_moe(torch, results: dict) -> None:
    """The MoE models at full width, one at a time (each freed before the
    next), every MoE layer through the grouped expert GEMM:

    (a) qwen2-moe-a2.7b, 24 layers, float32: AR and DyTC (LS0.5 over PLD)
        on phase 3's three prompts; ``tree_fused`` single, B=4, dense and
        paged (pages of 64), and ``chain_fused`` paged in split rounds, on
        phase 6's four prompts; every stream equal to AR, one graph launch a
        single round;
    (b) the same model in bfloat16: AR and DyTC, ``tree_fused`` single, not
        held to AR (as phase 4): the first divergence is printed;
    (c) mixtral-8x22b at 4 layers, float32: AR and DyTC, ``tree_fused``
        single B=4, every stream equal to AR.

    Each model prints its parameters, GiB, the draw's peak memory above the
    params (at most one layer's largest leaf), the draft's cost ratio c, ms
    a round and the grouped GEMM's launches a round."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.core import layer_sparsity
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.serving import BatchedSpecServer

    t_phase = time.perf_counter()
    print(f"[phase 13] memory allocated at the start: {_gib(torch.cuda.memory_allocated())}")
    launches = dict.fromkeys(_counters(), 0)

    def count(fn, *args, **kw):
        _reset_counts()
        out = fn(*args, **kw)
        for k, v in _read_counts().items():
            launches[k] += v
        return out

    rng = np.random.default_rng(SEED + 2)
    for name, dtype, kw in MOE_MODELS:
        cfg = dataclasses.replace(get_config(name), dtype=dtype, **kw)
        label = f"{name} {dtype}" + (f" ({cfg.num_layers} layers)" if kw else "")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, SEED)
        torch.cuda.synchronize()
        leaves = tree_leaves(params)
        n = sum(t.numel() for t in leaves)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        over, largest = torch.cuda.max_memory_allocated() - base - nbytes, _largest_layer_leaf(params)
        m = cfg.moe
        shared = f", a shared block of {m.d_ff_shared}" if m.num_shared_experts else ""
        print(f"[phase 13] {label}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
              f"{cfg.num_heads} / kv {cfg.num_kv_heads}, {m.num_experts} experts top-{m.top_k} of "
              f"d_ff {m.d_ff_expert}{shared}, vocab {cfg.vocab_size}: {n / 1e9:.3f} B parameters, "
              f"{_gib(nbytes)} in {time.perf_counter() - t0:.1f} s; the draw's peak memory is "
              f"{_gib(over)} above the params (one layer's largest leaf: {_gib(largest)})")
        if over > largest:
            raise AssertionError(f"{label}: the draw's peak exceeds the params by more than one "
                                 f"layer's largest leaf")
        exact = dtype == "float32"
        prompts = _prompts(cfg.vocab_size)
        ar = count(_single_stream, torch, cfg, params, prompts, label, exact=exact, phase=13)
        long_prompt = np.tile(rng.integers(0, cfg.vocab_size, size=50), 4).astype(np.int32)
        prompts = prompts + [long_prompt]
        ar = ar + [count(_generate, torch, cfg, params, long_prompt, False)[0]]
        rec = _serve_single(torch, cfg, params, prompts, ar if exact else None,
                            f"{label} tree_fused dense single", launches, phase=13)
        if not exact:
            divs = [_first_divergence(s[:GEN_TOKENS], ar[i][:GEN_TOKENS]) for i, s in rec["streams"]]
            print(f"[phase 13] {label} tree_fused dense single against AR: first divergence per "
                  f"request {divs} (None: identical)")
        if name == "qwen2-moe-a2.7b" and exact:
            _serve_single(torch, cfg, params, prompts, ar, f"{label} tree_fused paged single",
                          launches, phase=13, paged=True)
            srv = BatchedSpecServer(cfg, params, draft_spec=layer_sparsity(cfg, 0.5),
                                    mode="chain_fused", round_mode="split", paged=True,
                                    page_size=PAGE, **SERVER)
            rec = _serve(torch, srv, prompts, ar)
            _check_launches(f"{label} chain_fused paged split", rec["launches"], True)
            print(f"[phase 13] {label} chain_fused paged split: {rec['requests']} requests "
                  f"identical to AR | " + _line(rec) + ", launches per round: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
            for k, v in rec["launches"].items():
                launches[k] += v
            del srv
        del params, leaves
        torch.cuda.synchronize()
        print(f"[phase 13] {label}: peak memory serving {_gib(torch.cuda.max_memory_allocated())}")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[phase 13] kernel launches: {launches}")
    for name in ("flash_decode", "tree_attention", "flash_decode_paged", "set_cond", "moe_grouped",
                 "moe_grouped_bf16"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 13: {name} was not launched")
    for k, v in launches.items():
        results[k]["launches"] += v
    print(f"[phase 13] {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 14
# the Mamba-2 stacks at full width, random weights from seed 0: mamba2-130m at
# all 24 layers (0.129 B parameters, 0.48 GiB in float32) and jamba-v0.1-52b
# cut to one whole 8-layer unit, so its 7:1 mamba/attention interleave and
# its MoE period survive (7 mamba layers, the attention layer at offset 4,
# MoE on the 4 odd layers: 13.3 B parameters, ~49.4 GiB in float32; one MoE
# layer holds 2.82 B, so all 32 layers, ~52 B, do not fit one card)
SSM_MODELS = (("mamba2-130m", {}), ("jamba-v0.1-52b", dict(num_layers=8)))
SSM_SERVED = (("chain_fused dense single", dict(mode="chain_fused", round_mode="single")),
              ("chain_fused paged single", dict(mode="chain_fused", round_mode="single",
                                                paged=True)),
              ("chain_fused dense split", dict(mode="chain_fused", round_mode="split")),
              ("legacy dense split", dict(mode="legacy")))


def _ssm_prompts(vocab: int):
    """Phase 3's three prompts and one of 1100 tokens (a 100-token motif 11
    times), whose SSD prefill spans five chunks of 256."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    return _prompts(vocab) + [np.tile(rng.integers(0, vocab, size=100), 11).astype(np.int32)]


def _ssm_single_stream(torch, cfg, params, prompts, label: str, exact: bool) -> list:
    """AR, PLD (k 8) and SD (LS0.5, k 5) through ``SpecEngine`` on each
    prompt, GEN_TOKENS each; with ``exact`` every stream must equal AR, else
    the first divergence is printed. ``DyTCScheduler`` must refuse the
    stack. Prints ms a token, tokens a round and SD's cost ratio c (a draft
    call's mean wall time over a target call's). Returns the AR streams."""
    from repro_torch.core import (ARScheduler, DyTCScheduler, PLDScheduler, SDScheduler,
                                  SpecEngine, build_hierarchy, layer_sparsity)

    spec = layer_sparsity(cfg, 0.5)
    makers = {"AR": ARScheduler, "PLD": lambda e: PLDScheduler(e, k=8),
              "SD": lambda e: SDScheduler(e, spec, k=5)}
    ar_streams = []
    for i, prompt in enumerate(prompts):
        runs = {}
        for name, make in makers.items():
            eng = SpecEngine(cfg, params)
            eng.start(prompt)
            sched = make(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sched.generate(GEN_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not bool(torch.isfinite(eng.last_logits).all()):
                raise AssertionError(f"{label}: prompt {i}: non-finite logits ({name})")
            runs[name] = (out, dict(eng.stats), wall)
            if i == 0 and name == "AR":
                try:
                    DyTCScheduler(eng, build_hierarchy(cfg))
                except ValueError as e:
                    print(f"[phase 14] {label}: DyTCScheduler refused: {e}")
                else:
                    raise AssertionError(f"{label}: DyTCScheduler accepted a stack with mamba "
                                         "layers")
            del eng, sched
        ar = runs["AR"][0]
        ar_streams.append(ar)
        parts = []
        for name, (out, st, wall) in runs.items():
            div = _first_divergence(ar, out)
            text = (f"{name} {wall / GEN_TOKENS * 1e3:.2f} ms a token, "
                    f"{st['accepted_tokens'] / st['rounds']:.2f} tokens a round")
            if st["draft_calls"]:
                c = (st["draft_time"] / st["draft_calls"]) / (st["verify_time"] / st["target_calls"])
                text += f", {st['draft_calls']} {spec.name} draft calls, c {c:.3f}"
            text += "" if div is None else f", first divergence at token {div}"
            parts.append(text)
            if exact and div is not None:
                raise AssertionError(f"{label}: prompt {i}: {name} left AR at token {div}:\n"
                                     f"AR {ar}\n{name} {out}")
        held = "every stream identical to AR" if exact else "not held to AR"
        print(f"[phase 14] {label} prompt {i} ({len(prompt)} tokens), {held}: " + " | ".join(parts))
    return ar_streams


def _ssm_layer_times(torch, cfg, params, label: str) -> None:
    """One mamba layer of ``cfg`` alone (the stack's first, B=1 prefill at
    200 and 1100 tokens, B=4 decode of T=5): ms by CUDA events (L2 flushed),
    the T=5 decode also by graph replay, and the kernels one decode
    launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    s, d = cfg.ssm, cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    p_l = {k: v[0] for k, v in params["segments"][0][0]["mamba"].items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    parts = []
    for S in (200, 1100):
        h = torch.randn((1, S, d), generator=gen, device="cuda").to(dtype)
        st0 = ssm.init_state(d, s, 1, dtype, "cuda")
        ms = _time_ms(lambda: ssm.mamba_forward(p_l, h, d, s, st0, mode="prefill"), flush, iters=10)
        parts.append(f"prefill S={S} {ms:.3f} ms")
    h = torch.randn((4, 5, d), generator=gen, device="cuda").to(dtype)
    st0 = ssm.init_state(d, s, 4, dtype, "cuda")
    fn = lambda: ssm.mamba_forward(p_l, h, d, s, st0, mode="decode")  # noqa: E731
    ev = _time_ms(fn, flush, iters=10)
    gr = _graph_ms(fn, flush, iters=10)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    del flush_buf
    print(f"[phase 14] {label}: one mamba layer (d_inner {s.d_inner(d)}, {s.num_heads(d)} heads of "
          f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk_size}), ms by CUDA events: "
          + ", ".join(parts) + f"; decode B=4 T=5 {ev:.3f} (graph replay {gr:.3f}), "
          f"{kernels} kernel launches (profiler)")


def phase_ssm(torch, results: dict) -> None:
    """The Mamba-2 stacks at full width, one at a time (each freed before
    the next), through every path that serves them: mamba2-130m at all 24
    layers, then jamba-v0.1-52b at one 8-layer unit, each in float32 and
    then in bfloat16 (not held to AR, as phase 4):

    (a) single stream: AR, PLD and SD (LS0.5) on phase 3's three prompts
        and an 1100-token one (the SSD prefill over five chunks), every
        float32 stream equal to AR; ``DyTCScheduler`` refused;
    (b) the batched server, B=4, phase 6's four prompts, recomputed draft
        KV (``draft_kv="auto"``): ``chain_fused`` in single rounds, dense
        and paged, in split rounds, and ``legacy``; every float32 stream
        equal to AR; one graph launch and one host sync a single round;
        ``tree_fused`` refused;
    (c) one mamba layer alone: its prefill at 200 and 1100 tokens and its
        T=5 decode recurrence by CUDA events, and the decode's kernels.

    jamba's runs must launch ``flash_decode``, ``tree_attention``, the
    paged split and ``moe_grouped``. bfloat16 runs the single stream on
    phase 3's prompts and the dense single round."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.core import layer_sparsity
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.serving import BatchedSpecServer

    t_phase = time.perf_counter()
    print(f"[phase 14] memory allocated at the start: {_gib(torch.cuda.memory_allocated())}")
    launches = dict.fromkeys(_counters(), 0)
    mamba_launches: dict = {}

    def count(fn, *args, **kw):
        _reset_counts()
        out = fn(*args, **kw)
        for k, v in _read_counts().items():
            launches[k] += v
        return out

    for name, kw in SSM_MODELS:
        for dtype in ("float32", "bfloat16"):
            exact = dtype == "float32"
            cfg = dataclasses.replace(get_config(name), dtype=dtype, **kw)
            label = f"{name} {dtype}" + (f" ({cfg.num_layers} layers)" if kw else "")
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = init_params(cfg, SEED)
            torch.cuda.synchronize()
            leaves = tree_leaves(params)
            n = sum(t.numel() for t in leaves)
            nbytes = sum(t.numel() * t.element_size() for t in leaves)
            over = torch.cuda.max_memory_allocated() - base - nbytes
            kinds = "".join("A" if cfg.block_kind(i).value == "attention" else "M"
                            for i in range(cfg.num_layers))
            moe = [i for i in range(cfg.num_layers) if cfg.is_moe_layer(i)]
            s = cfg.ssm
            cut = (f"cut from {get_config(name).num_layers} to {cfg.num_layers} layers (one whole "
                   f"unit of {cfg.attn_layer_period})" if kw else f"all {cfg.num_layers} layers")
            print(f"[phase 14] {label}: {cut}, layers {kinds} (A attention, M mamba), MoE on "
                  f"{moe or 'none'}, d {cfg.d_model}, d_inner {s.d_inner(cfg.d_model)}, "
                  f"{s.num_heads(cfg.d_model)} SSM heads of {s.head_dim}, d_state {s.d_state}, "
                  f"vocab {cfg.vocab_size}: {n / 1e9:.3f} B parameters, {_gib(nbytes)} in "
                  f"{time.perf_counter() - t0:.1f} s; the draw's peak memory is {_gib(over)} above "
                  f"the params")
            prompts = _ssm_prompts(cfg.vocab_size) if exact else _prompts(cfg.vocab_size)
            ar = count(_ssm_single_stream, torch, cfg, params, prompts, label, exact)
            # phase 6's prompts: phase 3's three and a 200-token one
            served = _prompts(cfg.vocab_size)
            long_prompt = np.tile(np.random.default_rng(SEED + 2).integers(
                0, cfg.vocab_size, size=50), 4).astype(np.int32)
            served = served + [long_prompt]
            served_ar = ar[:3] + [count(_generate, torch, cfg, params, long_prompt, False)[0]]
            try:
                BatchedSpecServer(cfg, params, draft_spec=layer_sparsity(cfg, 0.5),
                                  mode="tree_fused", **SERVER)
            except ValueError as e:
                print(f"[phase 14] {label}: tree_fused refused: {e}")
            else:
                raise AssertionError(f"{label}: tree_fused accepted a stack with mamba layers")
            for run, srv_kw in (SSM_SERVED if exact else SSM_SERVED[:1]):
                srv = BatchedSpecServer(cfg, params, draft_spec=layer_sparsity(cfg, 0.5),
                                        page_size=PAGE, **dict(SERVER, **srv_kw))
                if srv.draft_kv != "recompute":
                    raise AssertionError(f"{label}: draft_kv resolved to {srv.draft_kv!r}")
                if srv.round_mode == "single" and srv._graph is None:
                    raise AssertionError(f"{label}: no CUDA graph was captured")
                rec = _serve(torch, srv, served, served_ar if exact else None)
                if srv.round_mode == "single":
                    _check_single(f"{label} {run}", rec, srv)
                exec_text = (f"slice exec, {len(srv._layer_ids)} layers"
                             if srv._layer_ids is not None
                             else f"mask exec, {int(srv._gates.sum())} of {cfg.num_layers} gates open")
                held = "identical to AR" if exact else "not held to AR"
                divs = "" if exact else " | first divergence per request " + str(
                    [_first_divergence(st[:GEN_TOKENS], served_ar[i][:GEN_TOKENS])
                     for i, st in rec["streams"]])
                print(f"[phase 14] {label} {run}: {rec['requests']} requests {held} | " + _line(rec)
                      + f", {rec['draft_rounds'] if srv.round_mode == 'single' else rec['draft_dispatches']}"
                      f" {'rounds drafted' if srv.round_mode == 'single' else 'draft passes'} "
                      f"({exec_text}), {rec['graph_replays'] / rec['rounds']:.2f} graph launches and "
                      f"{rec['host_syncs'] / rec['rounds']:.2f} host syncs a round"
                      + (f", capture {srv.capture_s * 1e3:.1f} ms" if srv.round_mode == "single" else "")
                      + " | launches per round: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items())
                      + divs)
                for k, v in rec["launches"].items():
                    launches[k] += v
                del srv
                torch.cuda.empty_cache()
            if exact:
                _ssm_layer_times(torch, cfg, params, label)
            del params, leaves
            torch.cuda.synchronize()
            print(f"[phase 14] {label}: peak memory serving {_gib(torch.cuda.max_memory_allocated())}")
            gc.collect()
            torch.cuda.empty_cache()
        if name == "mamba2-130m":
            mamba_launches = dict(launches)
    print(f"[phase 14] kernel launches: {launches}")
    jamba = {k: launches[k] - mamba_launches[k] for k in launches}
    print(f"[phase 14] jamba's kernel launches: flash_decode {jamba['flash_decode']}, tree_attention "
          f"{jamba['tree_attention']}, flash_decode_paged {jamba['flash_decode_paged']}, moe_grouped "
          f"{jamba['moe_grouped']}, moe_grouped_bf16 {jamba['moe_grouped_bf16']}, set_cond "
          f"{jamba['set_cond']}")
    for k in ("flash_decode", "tree_attention", "flash_decode_paged", "moe_grouped",
              "moe_grouped_bf16", "set_cond"):
        if jamba[k] <= 0:
            raise AssertionError(f"phase 14: jamba launched no {k}")
    for k, v in launches.items():
        results[k]["launches"] += v
    print(f"[phase 14] {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 15
# llava-next-mistral-7b at all 32 layers (7.24 B parameters, 27 GiB in
# float32) with anyres's 2880 image positions; musicgen-medium at all 48
# layers (1.38 B); training on the reference benchmarks' recipe, 20 steps:
# mamba2-130m at all 24 layers, qwen2-moe-a2.7b cut to 4 of its 24 layers
# (2.9 B parameters: 43 GiB of float32 params, gradients and AdamW moments;
# all 24 layers, 14.3 B, would take 213 GiB) and musicgen-medium at all 48
IMAGE_TEXT = 128                  # text tokens after the image positions
IMAGE_STEPS = 32                  # greedy steps after the image prefill
IMAGE_HELD = (1, 8, 32)           # steps whose logits a fresh prefill holds
MUSIC_PROMPT = 200
TRAIN15 = dict(steps=20, batch=8, seq=96, peak_lr=1e-3, warmup=10, corpus=60_000)
TRAINED = (("mamba2-130m", {}), ("qwen2-moe-a2.7b", dict(num_layers=4)),
           ("musicgen-medium", {}))


def _load15(torch, name: str, **kw):
    """The config in float32 (``kw`` cuts it), its seed-0 params, and a line
    with its cut, parameters, GiB and the draw's peak above the params."""
    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves

    cfg = dataclasses.replace(get_config(name), dtype="float32", **kw)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, SEED)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n, nbytes = sum(t.numel() for t in leaves), sum(t.numel() * t.element_size() for t in leaves)
    full = get_config(name).num_layers
    cut = (f"cut from {full} to {cfg.num_layers} layers" if cfg.num_layers != full
           else f"all {full} layers")
    heads = (f", heads {cfg.num_heads} / kv {cfg.num_kv_heads}, hd {cfg.resolved_head_dim()}"
             if cfg.num_heads else "")
    print(f"[phase 15] {name} float32, {cut}, d {cfg.d_model}{heads}, vocab {cfg.vocab_size}"
          + (f", {cfg.num_codebooks} codebooks" if cfg.num_codebooks else "")
          + (f", {cfg.num_image_tokens} image positions" if cfg.num_image_tokens else "")
          + f": {n / 1e9:.3f} B parameters, {_gib(nbytes)} in {time.perf_counter() - t0:.1f} s; "
          f"the draw's peak is {_gib(torch.cuda.max_memory_allocated() - base - nbytes)} above "
          "the params")
    return cfg, params, n


def _greedy_steps(torch, M, cfg, params, cache, first, n_steps: int, keep=()):
    """``n_steps`` greedy steps through ``decode_step`` and ``commit_cache``
    from the next tokens ``first`` (B, 1[, nc]), each codebook by its own
    argmax. Returns (the tokens fed (B, n_steps[, nc]), {step k in
    ``keep``: its logits}, ms a step by wall time, the next tokens)."""
    B, dev = first.shape[0], first.device
    path = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    one = torch.ones((B,), dtype=torch.int32, device=dev)
    fed, held, nxt = [], {}, first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, n_steps + 1):
        fed.append(nxt)
        logits, staged = M.decode_step(cfg, params, cache, nxt)
        M.commit_cache(cfg, cache, staged, path, one)
        if k in keep:
            held[k] = logits[:, 0]
        nxt = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    return torch.cat(fed, dim=1), held, (time.perf_counter() - t0) / n_steps * 1e3, nxt


def _llava_image(torch, cfg, params, results: dict) -> dict:
    """The image prefill (B=1: 2880 image positions from a seeded generator
    times 0.02, then IMAGE_TEXT text tokens), IMAGE_STEPS greedy steps over
    the committed cache, each held step's logits against a fresh prefill
    of the extended batch (argmax equal, within 1e-3), and
    ``flash_decode_partial`` at the longest live length against its plain
    version. Returns the launch counts of the prefill and the steps."""
    from repro_torch.analysis import costs as C
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models import model as M

    Ti, d = cfg.num_image_tokens, cfg.d_model
    S = Ti + IMAGE_TEXT
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    img = torch.randn((1, Ti, d), generator=gen, device="cuda") * 0.02
    text = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, size=(1, S))
    batch = {"tokens": torch.as_tensor(text, dtype=torch.int32, device="cuda"),
             "image_embeds": img,
             "image_mask": (torch.arange(S, device="cuda") < Ti).to(torch.int32)[None]}
    cache = M.init_cache(cfg, 1, 4096)
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last, _ = M.prefill(cfg, params, batch, cache)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_peak = torch.cuda.max_memory_allocated()
    fed, held, step_ms, _ = _greedy_steps(torch, M, cfg, params, cache,
                                          last.argmax(-1)[:, None], IMAGE_STEPS, keep=IMAGE_HELD)
    counts = _read_counts()
    live = int(cache["pos"][0])
    n = sum(t.numel() for t in M.tree_leaves(params))
    print(f"[phase 15] llava image prefill, B=1, {Ti} image positions + {IMAGE_TEXT} text tokens "
          f"(S = {S}): {pre_ms:.1f} ms wall (peak {_gib(pre_peak)}), "
          f"{2 * n * S / (pre_ms / 1e3) / 1e12:.1f} TFLOP/s by 2 x parameters x positions; then "
          f"{IMAGE_STEPS} greedy steps (decode_step + commit_cache, max_len 4096, the cache read "
          f"at S = {S}-{live}): {step_ms:.2f} ms a step | launches {counts}")
    worst = 0.0
    for k in IMAGE_HELD:
        ext = {"tokens": torch.cat([batch["tokens"], fed[:, :k]], dim=1), "image_embeds": img,
               "image_mask": torch.nn.functional.pad(batch["image_mask"], (0, k))}
        fresh, _ = M.prefill(cfg, params, ext, M.init_cache(cfg, 1, S + k))
        e = _err(held[k], fresh)
        same = bool(torch.equal(held[k].argmax(-1), fresh.argmax(-1)))
        print(f"[phase 15] llava step {k} (the cache read at S = {S + k - 1}) against a fresh "
              f"prefill of {S + k} positions: max abs logit err {e:.3e}, argmax equal {same}")
        if e > 1e-3 or not same:
            raise AssertionError(f"phase 15: llava's step {k} differs from a fresh prefill")
        worst = max(worst, e)
    # flash_decode_partial at the live length the steps reached
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    KV, rep, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim()
    q, kc, vc, kv_pos, q_pos, *_ = _attn_inputs(torch, gen, 1, KV, rep, 1, live, hd,
                                                torch.float32, live)
    q_pos[:, 0] = live                                    # every row sees the cache
    k_, v_ = kc.transpose(1, 2), vc.transpose(1, 2)
    got = fd.flash_decode_partial(q, k_, v_, kv_pos, q_pos)
    want = ref.flash_decode_partial(q, k_, v_, kv_pos, q_pos)
    e = _err(got[0] / got[2][..., None], want[0] / want[2][..., None])
    bound, by = C.flash_decode(1, KV, rep, hd, live, "float32").bound_ms()
    ev = _time_ms(lambda: fd.flash_decode_partial(q, k_, v_, kv_pos, q_pos), flush_buf.zero_)
    gr = _graph_ms(lambda: fd.flash_decode_partial(q, k_, v_, kv_pos, q_pos), flush_buf.zero_)
    pl = _time_ms(lambda: ref.flash_decode_partial(q, k_, v_, kv_pos, q_pos), flush_buf.zero_)
    del flush_buf
    print(f"[phase 15] flash_decode_partial float32 at llava's decode shape (B=1, KV {KV}, rep "
          f"{rep}, hd {hd}, S = {live}): out err abs={e:.3e} | kernel {ev:.4f} ms (graph replay "
          f"{gr:.4f}), plain {pl:.4f}, bound {bound:.4f} ms ({by})")
    if e > TOL["attention"]:
        raise AssertionError(f"phase 15: flash_decode_partial at S = {live} disagrees")
    results["flash_decode"]["max_abs_err"] = max(results["flash_decode"]["max_abs_err"], e)
    del cache
    return counts


def _musicgen_decode(torch, cfg, params) -> dict:
    """B=4, a MUSIC_PROMPT-step prompt of (B, S, 4) codes, GEN_TOKENS greedy
    steps; then five more greedy single steps against a T=5 joint decode of
    the same codes and its commit at ``n_accept`` 5 a slot: the logits
    within 1e-4 with equal argmax, the committed caches within 1e-4 and
    the same ``pos``. Returns the launch counts."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models.model import tree_map

    B, nc = 4, cfg.num_codebooks
    codes = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, size=(B, MUSIC_PROMPT, nc))
    cache = M.init_cache(cfg, B, 256)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, _ = M.prefill(cfg, params, {"tokens": torch.as_tensor(codes, device="cuda")}, cache)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    _, _, step_ms, nxt = _greedy_steps(torch, M, cfg, params, cache, last.argmax(-1)[:, None],
                                       GEN_TOKENS)
    # the sequential reference: five greedy single steps on a copy of the cache
    seq_cache = tree_map(lambda a: a.clone(), cache)
    t5, held, _, _ = _greedy_steps(torch, M, cfg, params, seq_cache, nxt, 5, keep=(1, 2, 3, 4, 5))
    joint, staged = M.decode_step(cfg, params, cache, t5)
    M.commit_cache(cfg, cache, staged, torch.arange(5, device="cuda"),
                   torch.full((B,), 5, dtype=torch.int32, device="cuda"))
    counts = _read_counts()
    e_log = max(_err(joint[:, k - 1], held[k]) for k in held)
    same = all(bool(torch.equal(joint[:, k - 1].argmax(-1), held[k].argmax(-1))) for k in held)
    e_cache = max(_err(a, b) for a, b in zip(M.tree_leaves(cache), M.tree_leaves(seq_cache)))
    print(f"[phase 15] musicgen B=4, a {MUSIC_PROMPT}-step prompt of (B, S, {nc}) codes: prefill "
          f"{pre_ms:.1f} ms; {GEN_TOKENS} greedy steps (each codebook by its own argmax) "
          f"{step_ms:.2f} ms a step | T=5 joint decode against five single steps: logits max abs "
          f"err {e_log:.3e}, argmax equal {same}; after the commit at n_accept 5 a slot: cache "
          f"max abs err {e_cache:.3e}, pos {cache['pos'].tolist()} / {seq_cache['pos'].tolist()} "
          f"| launches {counts}")
    if (e_log > 1e-4 or not same or e_cache > 1e-4
            or not torch.equal(cache["pos"], seq_cache["pos"])):
        raise AssertionError("phase 15: musicgen's joint decode differs from single steps")
    return counts


def _train_batches(torch, cfg):
    """TRAIN15's batches from the synthetic corpus (numpy seed 0): text
    windows (B, S); on a codebook stack the delay pattern over one corpus,
    codebook c lagging c positions, (B, S, nc)."""
    import numpy as np

    from repro_torch.data import lm_batches, synthetic_corpus

    nc, S = cfg.num_codebooks, TRAIN15["seq"]
    it = lm_batches(synthetic_corpus(cfg.vocab_size, TRAIN15["corpus"]), TRAIN15["batch"],
                    S + max(nc - 1, 0))
    out = []
    for _ in range(TRAIN15["steps"] + 1):
        t = next(it)["tokens"]
        if nc:
            t = np.stack([t[:, nc - 1 - c: nc - 1 - c + S] for c in range(nc)], axis=-1)
        out.append({"tokens": torch.as_tensor(t, device="cuda")})
    return out


def _dropped(torch, cfg, params, batch) -> tuple:
    """One forward of ``loss_fn`` on ``batch`` that records, MoE layer by
    layer, the share of (token, k) pairs the grouped dispatch drops.
    Returns (the shares, G, C)."""
    from repro_torch import training as T
    from repro_torch.models import moe

    shares, orig = [], moe._grouped_capacity

    def counted(p, xf, top_w, top_ids, m_cfg, act, gated, cf, *rest):
        _, keep, C = moe.capacity_slots(top_ids, m_cfg, cf)
        shares.append((1 - keep.float().mean(), keep.shape[0], C))
        return orig(p, xf, top_w, top_ids, m_cfg, act, gated, cf, *rest)

    moe._grouped_capacity = counted
    try:
        with torch.no_grad():
            T.loss_fn(cfg, params, batch, remat=False)
    finally:
        moe._grouped_capacity = orig
    return [float(s) for s, _, _ in shares], shares[0][1], shares[0][2]


def _train15(torch, name: str, kw: dict) -> None:
    """TRAIN15's steps of ``make_train_step`` from seed-0 params: each step
    by CUDA events, then one more split into forward, backward and the
    optimizer; every loss and grad_norm finite and ce lower at the last
    step than at the first. On an MoE stack the grouped dispatch's dropped
    share of (token, k) pairs, layer by layer, in a forward before the
    first step and one after the last (``_dropped``)."""
    from repro_torch import training as T
    from repro_torch.models import model as M

    cfg, params, n = _load15(torch, name, **kw)
    batches = _train_batches(torch, cfg)
    drops0 = _dropped(torch, cfg, params, batches[0]) if cfg.moe is not None else None
    torch.cuda.reset_peak_memory_stats()
    opt = T.adamw_init(params)
    step = T.make_train_step(cfg, peak_lr=TRAIN15["peak_lr"], warmup=TRAIN15["warmup"],
                             total_steps=TRAIN15["steps"], remat=False)
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(TRAIN15["steps"])]
    metrics = []
    for i in range(TRAIN15["steps"]):
        ev[i][0].record()
        params, opt, m = step(params, opt, batches[i])
        ev[i][1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(a.elapsed_time(b) for a, b in ev[2:])
    med = ms[len(ms) // 2]
    curve = {k: torch.stack([m[k] for m in metrics]).tolist()
             for k in ("ce", "loss", "moe_aux", "grad_norm")}
    params, opt, split, _ = _split_step(torch, T, M, cfg, params, opt, batches[-1])
    drops = ""
    if cfg.moe is not None:
        shares, G, C = _dropped(torch, cfg, params, batches[-1])
        drops = (f"; the grouped dispatch (capacity factor {cfg.moe.capacity_factor}, G {G}, C "
                 f"{C} a group) drops, layer by layer, "
                 + ", ".join(f"{x:.4f}" for x in drops0[0]) + " of the (token, k) pairs before "
                 "the first step and " + ", ".join(f"{x:.4f}" for x in shares) + " after the last")
    tokens = TRAIN15["batch"] * TRAIN15["seq"]
    print(f"[phase 15] train {name} ({cfg.num_layers} layers, {n / 1e9:.3f} B parameters, "
          f"{16 * n / 2**30:.1f} GiB of float32 params, gradients and AdamW moments): "
          f"{TRAIN15['steps']} steps of {TRAIN15['batch']} x {TRAIN15['seq']}"
          + (f" x {cfg.num_codebooks}" if cfg.num_codebooks else "")
          + f" tokens, peak lr {TRAIN15['peak_lr']}, warm-up {TRAIN15['warmup']}: a step (CUDA "
          f"events, steps 2-{TRAIN15['steps'] - 1}) median {med:.2f} ms, min {ms[0]:.2f}, max "
          f"{ms[-1]:.2f}; one more split: forward {split[0]:.2f} ms, backward {split[1]:.2f}, "
          f"optimizer {split[2]:.2f}; {tokens / med * 1e3:.0f} tokens/s; peak device memory "
          f"{_gib(peak)}; ce {curve['ce'][0]:.4f} at step 0, {curve['ce'][-1]:.4f} at step "
          f"{TRAIN15['steps'] - 1}; moe_aux {curve['moe_aux'][0]:.4f} / "
          f"{curve['moe_aux'][-1]:.4f}; "
          f"grad_norm {curve['grad_norm'][0]:.4f} / {curve['grad_norm'][-1]:.4f}" + drops)
    bad = [i for i in range(TRAIN15["steps"])
           if not all(math.isfinite(curve[k][i]) for k in ("loss", "grad_norm"))]
    if bad or curve["ce"][-1] >= curve["ce"][0]:
        raise AssertionError(f"phase 15: training {name}: steps {bad} not finite, or ce did not "
                             f"fall ({curve['ce'][0]:.4f} -> {curve['ce'][-1]:.4f})")
    if (curve["moe_aux"][0] > 0) != (cfg.moe is not None):
        raise AssertionError(f"phase 15: training {name}: moe_aux {curve['moe_aux'][0]}")
    del params, opt, metrics, batches


def phase_media(torch, results: dict) -> None:
    """The codebook and image stacks at full width, then MoE, Mamba-2 and
    codebook training, float32, random weights from seed 0, one model at a
    time (each freed before the next):

    (a) llava-next-mistral-7b, all 32 layers: the image prefill and the
        greedy steps after it, held to fresh prefills (``_llava_image``);
        AR and DyTC (LS0.5 over PLD) on phase 3's prompts, ``tree_fused``
        single B=4 dense and paged and ``cascade_fused`` mixing in split
        rounds on phase 6's prompts, every stream equal to AR; #1-#4 each
        launched, #3 by the cascade's int8 level;
    (b) musicgen-medium, all 48 layers: the codebook decode and the T=5
        joint decode against single steps (``_musicgen_decode``);
        ``SpecEngine`` and every server mode refuse it;
    (c) training (``_train15``): mamba2-130m, qwen2-moe-a2.7b at 4 layers,
        musicgen-medium."""
    import numpy as np

    from repro_torch.core import SpecEngine
    from repro_torch.serving import BatchedSpecServer

    t_phase = time.perf_counter()
    print(f"[phase 15] memory allocated at the start: {_gib(torch.cuda.memory_allocated())}")
    launches = dict.fromkeys(_counters(), 0)

    def count(fn, *args, **kw):
        _reset_counts()
        out = fn(*args, **kw)
        for k, v in _read_counts().items():
            launches[k] += v
        return out

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) llava
    cfg, params, _ = _load15(torch, "llava-next-mistral-7b")
    add(_llava_image(torch, cfg, params, results))
    label = "llava-next-mistral-7b"
    prompts = _prompts(cfg.vocab_size)
    ar = count(_single_stream, torch, cfg, params, prompts, label, phase=15)
    long_prompt = np.tile(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, size=50),
                          4).astype(np.int32)
    prompts = prompts + [long_prompt]
    ar = ar + [count(_generate, torch, cfg, params, long_prompt, False)[0]]
    _serve_single(torch, cfg, params, prompts, ar, f"{label} tree_fused dense single", launches,
                  phase=15)
    _serve_single(torch, cfg, params, prompts, ar, f"{label} tree_fused paged single", launches,
                  phase=15, paged=True)
    srv = BatchedSpecServer(cfg, params, mode="cascade_fused", round_mode="split", paged=False,
                            **SERVER)
    if srv.bank.int8_exec != "kernel":
        raise AssertionError(f"{label}: int8_exec resolved to {srv.bank.int8_exec!r}")
    rec = _serve(torch, srv, prompts, ar)
    disp = _check_dispatches(f"{label} cascade_fused", rec, srv)
    _check_launches(f"{label} cascade_fused", rec["launches"], False)
    print(f"[phase 15] {label} cascade_fused mixing dense split: {rec['requests']} requests "
          f"identical to AR | " + _line(rec) + f", dispatches per round max {max(disp)} of "
          f"{srv.expected_dispatches_per_round()} | W8A8 launches {rec['launches']['int8_matmul']} "
          f"| launches per round: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
    if rec["launches"]["int8_matmul"] <= 0:
        raise AssertionError(f"{label}: the cascade's int8 level launched no W8A8 kernel")
    add(rec["launches"])
    del srv, params
    torch.cuda.synchronize()
    print(f"[phase 15] {label}: peak memory serving {_gib(torch.cuda.max_memory_allocated())}")

    # (b) musicgen
    cfg, params, _ = _load15(torch, "musicgen-medium")
    add(_musicgen_decode(torch, cfg, params))
    for who in ("SpecEngine", "chain_fused", "legacy", "tree_fused", "cascade_fused"):
        try:
            if who == "SpecEngine":
                SpecEngine(cfg, params)
            else:
                BatchedSpecServer(cfg, params, mode=who, **SERVER)
        except ValueError as e:
            print(f"[phase 15] musicgen-medium: {who} refused: {e}")
        else:
            raise AssertionError(f"phase 15: {who} accepted a codebook stack")
    del params
    print(f"[phase 15] kernel launches of the served runs: {launches}")
    for name in ("flash_decode", "tree_attention", "flash_decode_paged", "int8_matmul"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 15: {name} was not launched")
    for k, v in launches.items():
        results[k]["launches"] += v

    # (c) training
    for name, kw in TRAINED:
        _train15(torch, name, kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[phase 15] {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ phase 16
GEMM_ROWS = (1, 16, 64, 128)        # decode, the server's verify, the cascade's 128 rows
CALL_S = 512                        # committed slots of phase 16's model calls
CALL_T = (1, 16, 64)
BLR_T = (1, 2, 4, 8, 16, 32, 64)    # the BLR's observations
BLR_HELD = (12, 48)                 # held out, predicted


def _gemm_shares(torch, flush) -> None:
    """Every weight GEMM of one vicuna-7b layer and the unembedding at M =
    GEMM_ROWS rows, float32 and bfloat16, by graph replay beside its bound
    from ``analysis.costs`` (bytes or operations) and its roofline share."""
    from repro_torch.analysis import costs as C
    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import unembed

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=1, dtype=dtype)
        params = init_params(cfg, SEED)
        a, mlp, d = params["segments"][0][0]["attn"], params["segments"][0][0]["mlp"], cfg.d_model
        weights = {"q": a["wq"][0].reshape(d, -1), "k": a["wk"][0].reshape(d, -1),
                   "v": a["wv"][0].reshape(d, -1), "o": a["wo"][0].reshape(-1, d),
                   "gate": mlp["w_gate"][0], "up": mlp["w_up"][0], "down": mlp["w_down"][0]}
        head = params["lm_head"]
        # the float32 upcast ``unembed`` makes of a bfloat16 head on every
        # call: the implementation's waste, outside the head's bound
        upcast = _graph_ms(lambda: head.float(), flush) if dtype != "float32" else 0.0  # noqa: B023
        for m in GEMM_ROWS:
            parts, layer_ms, layer_bound = [], 0.0, 0.0
            for g in C.layer_gemms(cfg, 0, m):
                w = weights[g.name]
                x = torch.randn(m, w.shape[0], generator=gen, device="cuda").to(w.dtype)
                ms = _graph_ms(lambda: x @ w, flush)  # noqa: B023
                bound, by = g.bound_ms()
                layer_ms, layer_bound = layer_ms + ms, layer_bound + bound
                parts.append(f"{g.name} {ms:.4f} ({bound:.4f} {by}, {bound / ms:.2f})")
            h = torch.randn(m, d, generator=gen, device="cuda").to(getattr(torch, dtype))
            ms = _graph_ms(lambda: unembed(h, head), flush)  # noqa: B023
            bound, by = C.unembed(cfg, m).bound_ms()
            parts.append(f"unembed {ms:.4f} ({bound:.4f} {by}, {bound / ms:.2f}"
                         + (f"; the head's float32 upcast alone {upcast:.4f} ms, "
                            f"{upcast / ms:.2f} of the call)" if upcast else ")"))
            print(f"[phase 16] GEMMs of a vicuna-7b layer, {dtype}, M={m}, graph replay ms (bound ms, "
                  f"bound by, share): " + "; ".join(parts) + f" | the layer's seven: {layer_ms:.4f} "
                  f"ms against {layer_bound:.4f}, share {layer_bound / layer_ms:.2f}")
        del params, weights, a, mlp, head
        torch.cuda.empty_cache()


def _call_ms(torch, cfg, params, T, flush, layers=None) -> tuple:
    """One B=1 ``decode_step`` of T chain rows over CALL_S committed slots
    (``layers``: slice exec): (graph replay ms, CUDA-event ms of the eager
    call, its ``analysis.costs`` count)."""
    from repro_torch.analysis import costs as C
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, 1, CALL_S + T)
    cache["pos"].fill_(CALL_S)
    tokens = torch.arange(T, device="cuda")[None] % cfg.vocab_size + 2
    run = lambda: M.decode_step(cfg, params, cache, tokens, layer_ids=layers)  # noqa: E731
    out = (_graph_ms(run, flush, iters=10), _time_ms(run, flush, iters=5, warmup=1),
           C.decode_step(cfg, 1, T, CALL_S, layers=layers))
    del cache
    return out


def _call_shares(torch, flush, results: dict) -> None:
    """One vicuna-7b layer's ``decode_step`` (a 1-layer model: the layer,
    the embedding and the head) at T = CALL_T and the full 32-layer B=1
    target call, float32, each with its counted FLOPs and bytes and its
    roofline share by graph replay; then the BLR over the roofline
    features of the target's and the LS0.5 draft's calls at T = BLR_T,
    predicting BLR_HELD, and the cost ratio c three ways: the roofline's,
    graph replay's and phase 3's by wall time."""
    from repro_torch.config import get_config
    from repro_torch.core.dsia import layer_sparsity
    from repro_torch.core.latency import BayesianLinearLatency, roofline_features, roofline_latency
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="float32")

    def line(label, ms, ev, cost):
        return (f"{label}: {cost.flops / 1e9:.2f} GFLOP, {cost.bytes_hbm / 1e6:.1f} MB, bound "
                f"{cost.t_bound * 1e3:.4f} ms ({cost.bottleneck}) | graph replay {ms:.4f} ms, share "
                f"{cost.share(ms):.3f} | eager by events {ev:.4f} ms, share {cost.share(ev):.3f}")

    one = dataclasses.replace(cfg, num_layers=1)
    params = init_params(one, SEED)
    for T in CALL_T:
        print(f"[phase 16] " + line(f"one layer's decode_step (B=1, T={T}, S={CALL_S})",
                                    *_call_ms(torch, one, params, T, flush)))
    del params
    torch.cuda.empty_cache()

    params = init_params(cfg, SEED)
    spec = layer_sparsity(cfg, 0.5)
    ids = [i for i, g in enumerate(spec.gates) if g]
    obs = {}
    for T in BLR_T + BLR_HELD:
        for name, layers in (("target", None), (spec.name, ids)):
            obs[name, T] = _call_ms(torch, cfg, params, T, flush, layers)
    print(f"[phase 16] " + line(f"the 32-layer target call (B=1, T=16, S={CALL_S})",
                                *obs["target", 16]))
    del params
    torch.cuda.empty_cache()

    def feats(cost):
        return roofline_features(cost.flops, cost.bytes_hbm, 0.0, dtype="float32")

    blr = BayesianLinearLatency(dim=4, noise=1e-8)
    for (name, T), (ms, _, cost) in obs.items():
        if T in BLR_T:
            blr.observe(feats(cost), ms / 1e3)
    errs = {"held out": [], "fitted": []}
    for (name, T), (ms, _, cost) in obs.items():
        pred = blr.predict(feats(cost)) * 1e3
        tag = "held out" if T in BLR_HELD else "fitted"
        errs[tag].append(abs(pred - ms) / ms)
        roof = roofline_latency(cost.flops, cost.bytes_hbm, dtype="float32") * 1e3
        print(f"[phase 16] BLR {name} T={T} ({tag}): graph replay {ms:.4f} ms, predicted {pred:.4f} "
              f"ms, relative error {abs(pred - ms) / ms:.4f}, roofline {roof:.4f} ms")
    print(f"[phase 16] BLR weights [1, compute, memory, collective] {blr.weights.tolist()}; relative "
          f"error held out {min(errs['held out']):.4f}-{max(errs['held out']):.4f}, fitted "
          f"{min(errs['fitted']):.4f}-{max(errs['fitted']):.4f}")
    c_roof = {T: roofline_latency(obs[spec.name, T][2].flops, obs[spec.name, T][2].bytes_hbm,
                                  dtype="float32")
              / roofline_latency(obs["target", T][2].flops, obs["target", T][2].bytes_hbm,
                                 dtype="float32") for T in (1, 16)}
    c_graph = {T: obs[spec.name, T][0] / obs["target", T][0] for T in (1, 16)}
    c3 = results.get("phase3_c") or [float("nan")]
    print(f"[phase 16] {spec.name}'s c (draft call / target call): roofline {c_roof[1]:.3f} (T=1), "
          f"{c_roof[16]:.3f} (T=16); graph replay {c_graph[1]:.3f} (T=1), {c_graph[16]:.3f} (T=16); "
          f"phase 3 by wall time (DyTC, the scaling hierarchy's drafts) "
          + ", ".join(f"{c:.3f}" for c in c3))


def _contract_summary() -> None:
    """Every captured single round of phases 7, 9, 10 and 12-15 held to its
    dispatch contracts (``_round_contracts``), and the telemetry pair."""
    by_phase = collections.Counter(p for p, _, _ in CONTRACTS)
    nodes = collections.Counter()
    for _, _, summ in CONTRACTS:
        nodes.update(summ["nodes"])
    print(f"[phase 16] dispatch contracts held on {len(CONTRACTS)} captured single rounds ("
          + ", ".join(f"{p}: {n}" for p, n in by_phase.items()) + f"); their nodes by kind, summed: "
          f"{dict(nodes)}; unresolved kernel names {sum(s['unresolved'] for _, _, s in CONTRACTS)}")
    missing = {f"phase {i}" for i in (7, 9, 10, 12, 13, 14, 15)} - set(by_phase)
    if missing:
        raise AssertionError(f"phase 16: no captured single round was held to its contracts in "
                             f"{sorted(missing)}")


def phase_analysis(torch, results: dict) -> None:
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    _gemm_shares(torch, flush_buf.zero_)
    _call_shares(torch, flush_buf.zero_, results)
    del flush_buf
    _contract_summary()
    print(f"[phase 16] {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 17
MESH_TIMEOUT_S = 300                # the longest any collective of phase 17 may wait
DRYRUN_ARCHS = ("vicuna-7b", "internlm2-20b", "jamba-v0.1-52b", "mixtral-8x22b")


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _collective_clock(torch) -> dict:
    """Time every ``torch.distributed.all_reduce`` of this process (the
    port's only collective) on the host clock, the device synchronised
    first so that a collective's seconds hold none of the kernels before
    it. Returns the running totals {"s", "n"}."""
    import torch.distributed as dist

    spent = {"s": 0.0, "n": 0}
    orig = dist.all_reduce

    def timed(t, *args, **kwargs):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = orig(t, *args, **kwargs)
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1
        return out

    dist.all_reduce = timed
    return spent


def _mesh_rank_record(rec: dict, spent: dict, rounds_s: float) -> dict:
    keep = ("rounds", "target_calls", "draft_dispatches", "host_syncs", "graph_replays",
            "ms_per_round", "tokens_per_slot_round", "launches")
    out = {k: rec[k] for k in keep}
    out.update(collective_s=spent["s"], collectives=spent["n"],
               collective_share=spent["s"] / rounds_s if rounds_s else float("nan"))
    return out


def _phase17_rank(rank: int, world: int, job: dict, out_dir: str) -> None:
    """One rank of phase 17 (b) or (c): two processes sharing the card over
    gloo, each holding its model=2 shard; split rounds on four slots, every
    stream held to the one-device AR stream; (c) also one context-parallel
    decode_attention at gemma3-1b's shapes. Saves its records."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.core import layer_sparsity
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import init_params
    from repro_torch.models import shard_utils as SU
    from repro_torch.models.model import tree_leaves
    from repro_torch.serving import BatchedSpecServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0 if job.get("share", True) else rank)
    mesh = Mesh((1, world), ("data", "model"), device=dev)
    cfg = dataclasses.replace(get_config(job["arch"]), dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, mesh=mesh)
    torch.cuda.synchronize()
    wk = params["segments"][0][0]["attn"]["wk"]
    out = {"init_s": time.perf_counter() - t0, "kv_local": int(wk.shape[2]),
           "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
           "runs": {}}
    spec = layer_sparsity(cfg, 0.5)
    spent = _collective_clock(torch)
    for name, mode, paged in job["runs"]:
        srv = BatchedSpecServer(cfg, params, mode=mode, draft_spec=spec, paged=paged,
                                page_size=PAGE, mesh=mesh, round_mode=job.get("round_mode", "split"),
                                **SERVER)
        spent.update(s=0.0, n=0)
        rec = _serve(torch, srv, job["prompts"], job["ar"])
        out["runs"][name] = _mesh_rank_record(rec, spent, rec["wall_s"])
        if rec["contracts"] is not None:
            out["runs"][name]["nccl_nodes"] = rec["contracts"]["round"].collective_counts()
        del srv
        torch.cuda.empty_cache()
    if "attention" in job:
        t = {k: torch.as_tensor(v, device=dev) for k, v in job["attention"].items()}
        S = t["k"].shape[1] // world
        with SU.use_mesh(mesh):
            o = attn.decode_attention(t["q"], t["k"][:, rank * S:(rank + 1) * S],
                                      t["v"][:, rank * S:(rank + 1) * S], t["pos"], t["kn"],
                                      t["vn"], t["q_pos"], tree_mask=t["tm"], seq_axes=("model",))
        out["attention"] = o.cpu().numpy()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _mesh_one_card(torch, results: dict) -> None:
    """(a): vicuna-7b, full width and 32 layers, float32, on a model=1,data=1
    mesh over a real NCCL group of one: tree_fused single rounds on four
    slots, the round's collectives captured in its graph; the streams,
    rounds, graph launches and host syncs of phase 7's one-device run, and
    the captured round held to its contracts (NCCL nodes counted apart)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.config import get_config
    from repro_torch.core import layer_sparsity
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedSpecServer

    p17 = results["p17"]
    want = p17["single"]["tree_fused dense"]
    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", rank=0, world=1, init_method=f"file://{tmp}/store",
                         device=torch.device("cuda", 0), timeout_s=MESH_TIMEOUT_S)
        try:
            mesh = Mesh((1, 1), ("data", "model"), device=torch.device("cuda", 0))
            params = init_params(cfg, SEED, mesh=mesh)
            srv = BatchedSpecServer(cfg, params, mode="tree_fused", draft_spec=layer_sparsity(cfg, 0.5),
                                    page_size=PAGE, mesh=mesh, round_mode="single", **SERVER)
            if srv._graph is None:
                raise AssertionError("phase 17 (a): no CUDA graph was captured on the mesh")
            rec = _serve(torch, srv, p17["prompts"], p17["ar"])
            summ = rec["contracts"]["round"].summary()
            coll = rec["contracts"]["round"].collective_counts()
            print(f"[phase 17] (a) vicuna-7b float32, 32 layers, mesh data=1,model=1 over "
                  f"{mesh.backend}: tree_fused dense single, {rec['requests']} requests identical to "
                  f"AR | {_line(rec)} (phase 7 one-device: {want['rounds']} rounds, "
                  f"{want['ms_per_round']:.2f} ms per round) | {rec['graph_replays'] / rec['rounds']:.2f} "
                  f"graph launches and {rec['host_syncs'] / rec['rounds']:.2f} host syncs a round "
                  f"(phase 7: {want['graph_replays'] / want['rounds']:.2f}, "
                  f"{want['host_syncs'] / want['rounds']:.2f}) | NCCL kernel nodes in the round "
                  f"{sum(coll.values())} {coll}, contracts held, nodes {summ['nodes']} | {_smi()}")
            same = dict(rec["streams"]) == dict(want["streams"])
            if not same or any(rec[k] != want[k] for k in ("rounds", "host_syncs", "graph_replays")):
                raise AssertionError(f"phase 17 (a): the mesh's run differs from phase 7's: streams "
                                     f"equal {same}, rounds {rec['rounds']} / {want['rounds']}, host "
                                     f"syncs {rec['host_syncs']} / {want['host_syncs']}, graph "
                                     f"launches {rec['graph_replays']} / {want['graph_replays']}")
            for k in ("flash_decode", "tree_attention", "set_cond"):
                results[k]["launches"] += rec["launches"][k]
            del srv, params
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()


def _spawn17(torch, job: dict) -> list:
    import tempfile

    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        spawn(_phase17_rank, 2, (job, tmp), device="cuda", share_card=job.get("share", True),
              timeout_s=MESH_TIMEOUT_S)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]


SPLIT_COUNTS = ("rounds", "target_calls", "draft_dispatches", "host_syncs")


def _print_ranks(label: str, ranks: list, baseline: dict, base_label: str, results: dict) -> None:
    """Print each rank's runs beside the one-device split run of the same
    name in ``baseline`` and fail where a rank's rounds, target calls,
    draft dispatches or host syncs differ from it."""
    smi = _smi()
    for r, rk in enumerate(ranks):
        for name, rec in rk["runs"].items():
            base = baseline[name]
            print(f"[phase 17] {label} rank {r}: {name} on a mesh of two ranks: streams "
                  f"identical to AR | {rec['rounds']} rounds, {rec['target_calls']} target calls, "
                  f"{rec['draft_dispatches']} draft dispatches, {rec['host_syncs']} host syncs "
                  f"({base_label}: {base['rounds']}, {base['target_calls']}, "
                  f"{base['draft_dispatches']}, {base['host_syncs']}), "
                  f"{rec['tokens_per_slot_round']:.2f} tokens per slot-round, "
                  f"{rec['ms_per_round']:.2f} ms per round ({base_label}: "
                  f"{base['ms_per_round']:.2f}) | {rec['collectives']} collectives, "
                  f"{rec['collective_s'] * 1e3 / rec['rounds']:.2f} ms a round, share of the round "
                  f"{rec['collective_share']:.3f} | local KV heads {rk['kv_local']}, launches "
                  + ", ".join(f"{k} {v}" for k, v in rec["launches"].items() if v) + f" | {smi}")
            for k, v in rec["launches"].items():
                results[k]["launches"] += v
            off = {k: (rec[k], base[k]) for k in SPLIT_COUNTS if rec[k] != base[k]}
            if off:
                raise AssertionError(f"phase 17 {label} rank {r}: {name} differs from the "
                                     f"{base_label} run in (mesh, one device) {off}")
        print(f"[phase 17] {label} rank {r}: params {_gib(rk['param_bytes'])} drawn in "
              f"{rk['init_s']:.1f} s, peak memory {_gib(rk['peak'])}")


def _gemma_split_one_device(torch, g: dict) -> dict:
    """(c)'s one-device yardstick: gemma3-1b float32 served by the same
    tree_fused dense split rounds in this process, with no mesh, on the
    prompts phase 12 served. Returns {"tree_fused dense": its record}."""
    from repro_torch.config import get_config
    from repro_torch.core import layer_sparsity
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedSpecServer

    cfg = dataclasses.replace(get_config("gemma3-1b"), dtype="float32")
    params = init_params(cfg, SEED)
    srv = BatchedSpecServer(cfg, params, mode="tree_fused", draft_spec=layer_sparsity(cfg, 0.5),
                            page_size=PAGE, round_mode="split", **SERVER)
    rec = _serve(torch, srv, g["prompts"], g["ar"])
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"tree_fused dense": {k: rec[k] for k in SPLIT_COUNTS + ("ms_per_round",)}}


def _gemma_attention_case(vocab_cfg):
    """One decode_attention at gemma3-1b's shapes (H 4, KV 1, hd 288), B=4,
    a 5-node tree over 600-1700 committed slots of a 2048-slot cache."""
    import numpy as np

    rng = np.random.default_rng(SEED + 17)
    B, T, S, H, KV, hd = 4, 5, 2048, vocab_cfg.num_heads, vocab_cfg.num_kv_heads, \
        vocab_cfg.resolved_head_dim()
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = tm[4, 2] = tm[4, 3] = False
    pos = np.array([600, 1023, 1024, 1700], np.int32)
    return dict(q=f(B, T, H, hd), k=f(B, S, KV, hd), v=f(B, S, KV, hd), pos=pos,
                kn=f(B, T, KV, hd), vn=f(B, T, KV, hd), tm=tm,
                q_pos=(pos[:, None] + np.array([0, 1, 1, 2, 2])[None]).astype(np.int32))


def _dryrun_table() -> None:
    """(d): the dry run's rows for four of the repo's largest configs on a
    (1, 2, 4)-card model axis at decode_32k, and which one H100 holds."""
    from repro_torch.analysis import report
    from repro_torch.config import get_config
    from repro_torch.launch import dryrun as D

    rows = [D.run_one(a, "decode_32k", mesh=D.shape_mesh(f"model={k}"), verbose=False)
            for a in DRYRUN_ARCHS for k in (1, 2, 4)]
    print("[phase 17] (d) dry run, decode_32k (B=128, S=32768, T=8), per device, by "
          "repro_torch.launch.dryrun (analytic; fits = params + cache + activations <= 80 GB):")
    for line in report.render(rows).splitlines():
        print(f"[phase 17]   {line}")
    for a in DRYRUN_ARCHS:
        cfg = get_config(a)
        fit = [k for k in (1, 2, 4)
               if next(r for r in rows if r["arch"] == a and r["mesh"] == f"1x{k}")["params_bytes"]
               <= report.HBM_GIB * 2 ** 30]
        print(f"[phase 17]   {a} ({cfg.dtype}): its params alone fit one H100's 80 GB at model = "
              f"{fit or 'none of 1, 2, 4'}")


def _shard_shape_kernels(torch) -> None:
    """The hand kernels the mesh runs at shapes no single-card path gives
    them, against their plain versions (comparison launches, not counted
    as the main path's): the W8A8 kernel on vicuna-7b's model=2 shards (the
    row-parallel down projection, K = 5504, and the column-parallel gate,
    N = 5504), bitwise; the grouped expert GEMM at qwen2-moe's local
    expert d_ff (1408 / 2 = 704), float32, within TOL["moe"], and in
    bfloat16 at 704 and at model=4's 352 (n and k ending inside a 64-wide
    tile of the tensor-core kernel), within one bfloat16 ulp plus
    TOL["moe"]."""
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    for M, K, N in ((16, 5504, 4096), (16, 4096, 5504), (128, 5504, 4096)):
        ops = _int8_operands(torch, gen, M, K, N)
        got, want = i8.int8_matmul(*ops), ref.ref_int8_matmul(*ops)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 17: int8_matmul at the shard shape {M}x{K}x{N} differs "
                                 f"by {_err(got, want)}")
    E, d = 60, 2048
    text = []
    for dtype, F in ((torch.float32, 704), (torch.bfloat16, 704), (torch.bfloat16, 352)):
        x, ids = _moe_route(torch, gen, 64, 4, E, d, dtype)
        x_s, offs, _ = _moe_sort(torch, x, ids, E)
        w_g, w_u = (torch.randn(E, d, F, generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
                    for _ in range(2))
        w_d = torch.randn(E, F, d, generator=gen, device="cuda").mul_(F ** -0.5).to(dtype)
        h = mg.moe_grouped(x_s, w_g, offs, act="silu", w_mul=w_u)
        pairs = ((h, ref.ref_moe_grouped(x_s, w_g, offs, act="silu", w_mul=w_u)),
                 (mg.moe_grouped(h, w_d, offs), ref.ref_moe_grouped(h, w_d, offs)))
        for a, b in pairs:
            ulp = 0.0 if dtype == torch.float32 else 2 ** -7 * b.float().abs()
            if bool(((a.float() - b.float()).abs() > TOL["moe"] + ulp).any()):
                raise AssertionError(f"phase 17: moe_grouped at the shard shape d_ff {F} "
                                     f"{str(dtype)[6:]} off by {_err(a, b)}")
        text.append(f"{str(dtype)[6:]} d_ff {F} max abs err {max(_err(a, b) for a, b in pairs):.2e}")
    print(f"[phase 17] shard shapes: int8_matmul at 16x5504x4096, 16x4096x5504 and 128x5504x4096 "
          f"bitwise equal to its plain version; moe_grouped at qwen2-moe's local d_ff (64 tokens, "
          f"top-4 of {E}), gated up and down: {'; '.join(text)} (tolerance {TOL['moe']}, plus one "
          f"ulp in bfloat16)")


def phase_mesh(torch, results: dict) -> None:
    """The mesh on the card: (a) vicuna-7b on a real NCCL group of one,
    single rounds captured with their collectives, against phase 7; (b)
    vicuna-7b at model=2 as two ranks sharing the card over gloo, split
    rounds dense and paged, against phase 6 and AR; (c) gemma3-1b at
    model=2 (policy q: the cache sequence-sharded), a context-parallel
    decode_attention against the one-device call and tree_fused split
    streams against AR; (d) the dry run's table; (e) model=2 over NCCL
    where the machine has two cards."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.models import attention as attn

    t0 = time.perf_counter()
    _shard_shape_kernels(torch)
    _mesh_one_card(torch, results)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase 17] (a) {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    p17 = results["p17"]
    job = dict(arch="vicuna-7b", prompts=p17["prompts"], ar=p17["ar"],
               runs=[("tree_fused dense", "tree_fused", False),
                     ("chain_fused paged", "chain_fused", True)])
    ranks = _spawn17(torch, job)
    _print_ranks("(b) vicuna-7b float32, model=2", ranks, p17["split"], "phase 6 one-device split",
                 results)
    for rk in ranks:
        if rk["kv_local"] != 16:
            raise AssertionError(f"phase 17 (b): {rk['kv_local']} local KV heads, not 16")
        for name, key in (("tree_fused dense", "flash_decode"), ("tree_fused dense", "tree_attention"),
                          ("chain_fused paged", "flash_decode_paged")):
            if rk["runs"][name]["launches"][key] <= 0:
                raise AssertionError(f"phase 17 (b): {name} launched no {key} on a rank")
    print(f"[phase 17] (b) {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    g = results["p17_gemma"]
    gcfg = get_config("gemma3-1b")
    one_device = _gemma_split_one_device(torch, g)
    case = _gemma_attention_case(gcfg)
    ranks = _spawn17(torch, dict(arch="gemma3-1b", prompts=g["prompts"], ar=g["ar"],
                                 runs=[("tree_fused dense", "tree_fused", False)], attention=case))
    t = {k: torch.as_tensor(v, device="cuda") for k, v in case.items()}
    want = attn.decode_attention(t["q"], t["k"], t["v"], t["pos"], t["kn"], t["vn"], t["q_pos"],
                                 tree_mask=t["tm"]).cpu().numpy()
    errs = [float(np.abs(rk["attention"] - want).max()) for rk in ranks]
    print(f"[phase 17] (c) gemma3-1b float32, model=2 (policy q, cache sequence-sharded): "
          f"context-parallel decode_attention (B=4, T=5, S=2048 in two slices of 1024, hd "
          f"{gcfg.resolved_head_dim()}) against the one-device call: max abs err by rank "
          f"{errs} (tolerance 1e-5)")
    if max(errs) > 1e-5:
        raise AssertionError(f"phase 17 (c): context-parallel attention off by {max(errs)}")
    _print_ranks("(c) gemma3-1b float32, model=2", ranks, one_device, "one-device split", results)
    print(f"[phase 17] (c) {time.perf_counter() - t2:.1f} s")

    _dryrun_table()
    if torch.cuda.device_count() >= 2:
        ranks = _spawn17(torch, dict(arch="vicuna-7b", prompts=p17["prompts"], ar=p17["ar"],
                                     share=False, round_mode="single",
                                     runs=[("tree_fused dense", "tree_fused", False)]))
        _print_ranks("(e) vicuna-7b float32, model=2 over nccl, single rounds", ranks,
                     p17["single"], "phase 7 one-device single", results)
    else:
        print(f"[phase 17] (e) model=2 over NCCL with captured rounds waits for a machine with two "
              f"cards: this one has {torch.cuda.device_count()}")
    print(f"[phase 17] {time.perf_counter() - t0:.1f} s | {_smi()}")


# ------------------------------------------------------------------ phase 18
# sharded training: phase 11's corpus and batches (8 x 96 tokens), float32,
# seed 0, the one-device run of the same depth as the yardstick
# (b) and (c) take 2 steps: through gloo's host staging a data=2 step of
# either takes 5-14 s on one H100 (PERF.md)
TRAIN18 = dict(steps=3, mesh_steps=2, moe_steps=2, tol_ce=1e-5, tol_gnorm=1e-4, timeout_s=600)
TRAIN18_ARCHS = ("vicuna-7b", "internlm2-20b", "jamba-v0.1-52b", "mixtral-8x22b")


def _batches18(cfg, n: int) -> list:
    """Phase 11's first ``n`` batches (numpy tokens (8, 96))."""
    from repro_torch.data import lm_batches, synthetic_corpus

    it = lm_batches(synthetic_corpus(cfg.vocab_size, TRAIN["corpus"]), TRAIN["batch"], TRAIN["seq"])
    return [next(it)["tokens"] for _ in range(n)]


def _steps18(torch, cfg, batches, remat: bool, dev, mesh=None, specs=None, slots=None) -> tuple:
    """``make_train_step`` (phase 11's recipe) from seed-0 params over
    ``batches`` on the card ``dev``, on this rank's shards and rows of ``mesh``
    (None: one device). ``slots``: a list that takes (top_ids, slot, keep)
    of every ``capacity_slots`` call of the first step. Returns (params,
    opt, the metrics of every step as floats, ms a step by the host clock
    after a synchronise, the collectives' seconds a step, peak memory)."""
    from repro_torch import training as T
    from repro_torch.launch import sharding as SH
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import shard_utils as SU

    params = init_params(cfg, SEED, device=dev, mesh=mesh, specs=specs)
    opt = T.adamw_init(params)
    step = T.make_train_step(cfg, peak_lr=TRAIN["peak_lr"], warmup=TRAIN["warmup"],
                             total_steps=TRAIN["steps"], remat=remat)
    rows = slice(None)
    if mesh is not None:
        n = TRAIN["batch"] // SH.dp_size(mesh)
        rows = slice(mesh.index(SU.DATA_AXES) * n, (mesh.index(SU.DATA_AXES) + 1) * n)
    spent = _collective_clock(torch) if mesh is not None and mesh.size > 1 else {"s": 0.0}
    orig = moe_lib.capacity_slots

    def recorded(top_ids, *a, **k):
        out = orig(top_ids, *a, **k)
        slots.append((top_ids.cpu(), out[0].cpu(), out[1].cpu()))
        return out

    metrics, ms, coll = [], [], []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        with SU.use_mesh(mesh):
            for i, b in enumerate(batches):
                if slots is not None:
                    moe_lib.capacity_slots = recorded if i == 0 else orig
                spent["s"] = 0.0
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, {"tokens": torch.as_tensor(b[rows], device=dev)})
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                coll.append(spent["s"])
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        moe_lib.capacity_slots = orig
    return params, opt, metrics, ms, coll, torch.cuda.max_memory_allocated(dev)


def _close18(label: str, got: list, want: list) -> str:
    """ce within TRAIN18's 1e-5 relative and grad_norm within 1e-4 at every
    step, lr equal; the worst relative errors as text."""
    worst = {"ce": 0.0, "grad_norm": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for k in worst:
            worst[k] = max(worst[k], abs(g[k] - w[k]) / abs(w[k]))
        if g["lr"] != w["lr"]:
            raise AssertionError(f"phase 18 {label}: step {i}'s lr {g['lr']} is not {w['lr']}")
    if worst["ce"] > TRAIN18["tol_ce"] or worst["grad_norm"] > TRAIN18["tol_gnorm"]:
        raise AssertionError(f"phase 18 {label}: relative errors {worst} past ce "
                             f"{TRAIN18['tol_ce']}, grad_norm {TRAIN18['tol_gnorm']}")
    return f"ce rel err {worst['ce']:.2e}, grad_norm {worst['grad_norm']:.2e}"


def _param_rule(torch, got: dict, want: dict, specs, mesh, coords) -> dict:
    """``got`` (this rank's shards) against the cut of ``want`` (the one-
    device params, CPU): the elements past 1e-5 (the rule of
    ``tests/test_torch_training.py``) and the largest difference; and the
    rule of ``tests/test_torch_train_stacks.py`` (at most one element in
    10^4 of a leaf past 1e-5, none past 3e-3: AdamW's update of a gradient
    that is rounding noise) held."""
    from repro_torch.launch import sharding as SH

    by_key = SH.specs_by_key(specs)
    past, worst, ok, n = 0, 0.0, True, 0
    for k, a in got.items():
        w = want[k][SH.local_slices(want[k].shape, by_key[k], mesh, coords)]
        d = (a.float() - w.to(a.device).float()).abs()
        bad = int((d > 1e-5).sum())
        past, worst, n = past + bad, max(worst, float(d.max())), n + d.numel()
        ok = ok and bad <= max(1, d.numel() // 10_000) and float(d.max()) <= 3e-3
    return {"past": past, "worst": worst, "ok": ok, "n": n}


def _phase18_rank(rank: int, world: int, job: dict, out_dir: str) -> None:
    """One rank of phase 18 (b), (c) or (e): its shards by ``train_specs``,
    its rows of the batches, the steps; the params against the one-device
    run's (the parent's tensors on the card, shared with the ranks through
    CUDA IPC) by the rules of ``_param_rule``."""
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.checkpoint import map_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0 if job["share"] else rank)
    shape = tuple(job["sizes"].values())
    mesh = Mesh(shape, tuple(job["sizes"]), device=dev)
    specs = SH.train_specs(job["cfg"], mesh)
    slots = [] if job["slots"] else None
    t0 = time.perf_counter()
    params, opt, metrics, ms, coll, peak = _steps18(torch, job["cfg"], job["batches"],
                                                    job["remat"], dev, mesh, specs, slots)
    out = {"metrics": metrics, "ms": ms, "coll": coll, "peak": peak, "slots": slots,
           "wall": time.perf_counter() - t0, "coords": dict(mesh.coords),
           "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
           "moment_bytes": sum(t.numel() * t.element_size() for t in tree_leaves((opt.mu, opt.nu))),
           "fsdp_leaves": sum("data" in SH.spec_axes(s) for s in
                              SH.specs_by_key(SH.placed_specs(job["cfg"], params, mesh)).values())}
    if job["want"] is not None:
        got = {}
        map_with_path(lambda k, t: got.__setitem__(k, t), params)
        out["params"] = _param_rule(torch, got, job["want"], specs, mesh, mesh.coords)
        job["want"] = None            # release the parent's tensors (CUDA IPC) before exiting
        gc.collect()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _spawn18(torch, cfg, sizes: dict, batches, want, *, remat: bool,
             slots: bool = False, share: bool = True) -> list:
    import tempfile

    from repro_torch.launch.mesh import spawn

    world = math.prod(sizes.values())
    job = dict(cfg=cfg, sizes=sizes, batches=batches, want=want, remat=remat, slots=slots,
               share=share)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_phase18_rank, world, (job, tmp), device="cuda", share_card=share,
              timeout_s=TRAIN18["timeout_s"])
        torch.cuda.ipc_collect()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _one_device18(torch, cfg, batches, remat: bool, dev, slots=None) -> tuple:
    """The yardstick: the same steps on one device, its moments freed.
    Returns (metrics, ms a step, peak memory, {checkpoint key: param} of
    the final params, on the card)."""
    from repro_torch.training.checkpoint import map_with_path

    params, opt, metrics, ms, _, peak = _steps18(torch, cfg, batches, remat, dev, slots=slots)
    flat = {}
    map_with_path(lambda k, t: flat.__setitem__(k, t), params)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, ms, peak, flat


def _rank_lines(label: str, ranks: list, plan: dict, base_ms: float) -> None:
    """Each rank's bytes against the dry run's plan, peak memory, ms a step
    after the first (median) and the collectives' share of it, and its
    params against the one-device run's where they were held."""
    smi = _smi()
    for r, rk in enumerate(ranks):
        first = 1 if len(rk["ms"]) > 1 else 0          # the steps after the first, where there are
        later = rk["ms"][first:]
        steady = sorted(later)[len(later) // 2]
        share = sum(rk["coll"][first:]) / (sum(later) / 1e3)
        pr = rk.get("params")
        held = ("" if pr is None else f"; params after step {len(rk['ms'])}: {pr['past']} of "
                f"{pr['n']} elements past 1e-5, largest difference {pr['worst']:.2e}")
        print(f"[phase 18] {label} rank {r} {rk['coords']}: params {_gib(rk['param_bytes'])} "
              f"(dry run {_gib(plan['params_bytes'])}), moments {_gib(rk['moment_bytes'])} "
              f"(dry run {_gib(plan['moment_bytes'])}), {rk['fsdp_leaves']} leaves cut over data; "
              f"peak memory {_gib(rk['peak'])}; {steady:.1f} ms a step{' after the first' * first} "
              f"(one device {base_ms:.1f}), collectives {share:.3f} of it{held} | {smi}")
        if rk["param_bytes"] != plan["params_bytes"] or rk["moment_bytes"] != plan["moment_bytes"]:
            raise AssertionError(f"phase 18 {label} rank {r}: params / moments "
                                 f"{rk['param_bytes']} / {rk['moment_bytes']} bytes, the dry run "
                                 f"planned {plan['params_bytes']} / {plan['moment_bytes']}")
        if pr is not None and not pr["ok"]:
            raise AssertionError(f"phase 18 {label} rank {r}: params off the one-device run's: {pr}")


def _train_one_rank_nccl(torch, results: dict, dev) -> None:
    """(a): vicuna-7b at full width and 8 layers (phase 11's config), three
    steps on a one-rank NCCL mesh against the same steps on one device:
    ce, grad_norm and every param leaf bitwise (a one-rank all-reduce is
    the identity)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.config import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh, init_distributed
    from repro_torch.training.checkpoint import map_with_path

    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=TRAIN["layers"], dtype="float32")
    batches = _batches18(cfg, TRAIN18["steps"])
    one, opt, m1, ms1, _, _ = _steps18(torch, cfg, batches, False, dev)
    del opt
    gc.collect()
    want = {}
    map_with_path(lambda k, t: want.__setitem__(k, t), one)
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", rank=0, world=1,
                         init_method=f"file://{tmp}/store", device=dev, timeout_s=MESH_TIMEOUT_S)
        try:
            mesh = Mesh((1, 1), ("data", "model"), device=dev)
            specs = SH.train_specs(cfg, mesh)
            two, opt, m2, ms2, _, peak = _steps18(torch, cfg, batches, False, dev, mesh, specs)
            del opt
        finally:
            dist.destroy_process_group()
    got = {}
    map_with_path(lambda k, t: got.__setitem__(k, t), two)
    same = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"[phase 18] (a) vicuna-7b float32, {cfg.num_layers} layers, mesh data=1,model=1 over "
          f"{mesh.backend}: {TRAIN18['steps']} steps, ce {[m['ce'] for m in m2]}, grad_norm "
          f"{[m['grad_norm'] for m in m2]} (one device: {[m['ce'] for m in m1]}, "
          f"{[m['grad_norm'] for m in m1]}); metrics bitwise {m1 == m2}, params bitwise in "
          f"{len(want) - len(same)} of {len(want)} leaves; ms a step after the first "
          f"{sorted(ms2[1:])[0]:.1f} on the mesh, {sorted(ms1[1:])[0]:.1f} on one device (phase 11 "
          f"median {results.get('p11_step_ms', float('nan')):.1f}); peak {_gib(peak)} | {_smi()}")
    if m1 != m2 or same:
        raise AssertionError(f"phase 18 (a): the one-rank mesh's steps differ from one device's: "
                             f"metrics equal {m1 == m2}, leaves differing {same}")
    del one, two, want, got
    gc.collect()


def _train_two_ranks(torch, dev) -> None:
    """(b) vicuna-7b at full width and 2 layers, two gloo ranks sharing the
    card at data=2 (FSDP, 4 rows a rank), then at model=2 (policy kv),
    two steps each; (e) the same over nccl where there are two cards."""
    from repro_torch.config import get_config
    from repro_torch.config.shapes import get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves

    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=2, dtype="float32")
    n_params = sum(t.numel() for t in tree_leaves(init_params(cfg, device="meta")))
    batches = _batches18(cfg, TRAIN18["mesh_steps"])
    want, ms, peak, final = _one_device18(torch, cfg, batches, True, dev)
    base = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"[phase 18] (b) vicuna-7b float32, 2 layers, {n_params / 1e9:.3f} B parameters "
          f"({16 * n_params / 1e9:.1f} GB with gradients and moments): one device, "
          f"{TRAIN18['mesh_steps']} steps with remat, {base:.1f} ms a step after the first, peak "
          f"{_gib(peak)}")
    runs = [("data=2 gloo", "data=2,model=1", True), ("model=2 gloo", "data=1,model=2", True)]
    if torch.cuda.device_count() >= 2:
        runs.append(("(e) data=2 nccl", "data=2,model=1", False))
    for label, spec, share in runs:
        t0 = time.perf_counter()
        sizes = {a: int(n) for a, n in (p.split("=") for p in spec.split(","))}
        ranks = _spawn18(torch, cfg, sizes, batches, final, remat=True, share=share)
        errs = [_close18(f"(b) {label}", rk["metrics"], want) for rk in ranks]
        _rank_lines(f"(b) {label}", ranks, D.plan(cfg, get_shape("train_4k"), D.shape_mesh(spec)),
                    base)
        print(f"[phase 18] (b) {label}: ce {[m['ce'] for m in ranks[0]['metrics']]}, grad_norm "
              f"{[m['grad_norm'] for m in ranks[0]['metrics']]} (one device "
              f"{[m['ce'] for m in want]}, {[m['grad_norm'] for m in want]}); by rank: {errs}; "
              f"{time.perf_counter() - t0:.1f} s")
    if torch.cuda.device_count() < 2:
        print(f"[phase 18] (e) (b) over NCCL, a card a rank, waits for a machine with two cards: "
              f"this one has {torch.cuda.device_count()}")


def _train_moe_two_ranks(torch, dev) -> None:
    """(c) qwen2-moe-a2.7b at full width and 2 layers, exec_groups 1, two
    gloo ranks sharing the card at data=2, two steps: the capacity slot
    table of each MoE call of the first step, both ranks' rows gathered,
    bitwise the unsharded table over the same ids; ce, moe_aux and
    grad_norm at each step and the params after the second (the first
    update: phase 11's warm-up gives step 0 a learning rate of 0) against
    one device."""
    import torch as _t

    from repro_torch.config import get_config
    from repro_torch.config.shapes import get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.models import moe as moe_lib

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2, dtype="float32")
    if cfg.moe.exec_groups != 1:
        raise AssertionError("phase 18 (c): qwen2-moe-a2.7b's exec_groups is not 1")
    batches = _batches18(cfg, TRAIN18["moe_steps"])
    slots_one: list = []
    want, ms, peak, final = _one_device18(torch, cfg, batches, False, dev, slots=slots_one)
    base = sorted(ms[1:])[len(ms[1:]) // 2]
    t0 = time.perf_counter()
    ranks = _spawn18(torch, cfg, {"data": 2, "model": 1}, batches, final, remat=False, slots=True)
    del final
    plan = D.plan(cfg, get_shape("train_4k"), D.shape_mesh("data=2,model=1"))
    for rk in ranks:
        err = _close18("(c)", rk["metrics"], want)
        aux = max(abs(g["moe_aux"] - w["moe_aux"]) / abs(w["moe_aux"])
                  for g, w in zip(rk["metrics"], want))
        if aux > TRAIN18["tol_ce"]:
            raise AssertionError(f"phase 18 (c): moe_aux off by {aux:.2e} relative")
    tables, same_ids = 0, 0
    for j, (ids1, _, _) in enumerate(slots_one):
        ids = _t.cat([rk["slots"][j][0] for rk in ranks])
        slot, keep, _ = moe_lib.capacity_slots(ids, cfg.moe, cfg.moe.capacity_factor)
        got_s = _t.cat([rk["slots"][j][1].reshape(-1) for rk in ranks])
        got_k = _t.cat([rk["slots"][j][2].reshape(-1) for rk in ranks])
        if not (_t.equal(got_s, slot.reshape(-1)) and _t.equal(got_k, keep.reshape(-1))):
            raise AssertionError(f"phase 18 (c): MoE call {j}'s slot table on the data ranks is "
                                 "not the unsharded table")
        tables += 1
        same_ids += int(_t.equal(ids, ids1))
    dropped = [1 - float(s[2].float().mean()) for s in slots_one]
    _rank_lines("(c) qwen2-moe-a2.7b float32, 2 layers, data=2", ranks, plan, base)
    print(f"[phase 18] (c) {err}, moe_aux rel err {aux:.2e}; slot tables of {tables} MoE calls "
          f"bitwise the unsharded table over the ranks' gathered ids (ids equal to one device's in "
          f"{same_ids} of {tables}); dropped share one device {['%.4f' % d for d in dropped]}; one "
          f"device {base:.1f} ms a step after the first, peak {_gib(peak)}; "
          f"{time.perf_counter() - t0:.1f} s")


def _train_dryrun_table() -> None:
    """(d): the dry run at train_4k (B=256, S=4096) for four of the repo's
    largest configs on a 1-, 2- and 4-card model axis (analytic)."""
    from repro_torch.analysis.report import HBM_GIB
    from repro_torch.launch import dryrun as D

    print("[phase 18] (d) dry run, train_4k (B=256, S=4096), per device, by "
          "repro_torch.launch.dryrun (analytic; FSDP at min_dim 512 over data, here 1):")
    for a in TRAIN18_ARCHS:
        for k in (1, 2, 4):
            r = D.run_one(a, "train_4k", mesh=D.shape_mesh(f"model={k}"), verbose=False)
            rf = r["roofline"]
            state = r["params_bytes"] + r["grad_bytes"] + r["moment_bytes"]
            print(f"[phase 18]   {a} model={k}: params {_gib(r['params_bytes'])} + grads "
                  f"{_gib(r['grad_bytes'])} + moments {_gib(r['moment_bytes'])} = {_gib(state)}; "
                  f"activations {_gib(r['act_bytes'])}; collectives "
                  f"{sum(rf['coll_bytes'].values()) / 1e9:.3f} GB a step "
                  f"({rf['t_collective'] * 1e3:.1f} ms at NVLink's rate); state fits one "
                  f"card (analysis.report's {HBM_GIB:.2f} GiB): {state <= HBM_GIB * 2**30}")


def phase_train_mesh(torch, results: dict) -> None:
    """Sharded training on the card: (a) vicuna-7b at 8 layers on a
    one-rank NCCL mesh, bitwise the one-device steps; (b) vicuna-7b at 2
    layers as two gloo ranks sharing the card at data=2 (FSDP) and at
    model=2; (c) qwen2-moe-a2.7b at 2 layers at data=2, its slot tables;
    (d) the dry run's training rows; (e) (b) over NCCL on two cards."""
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    _train_one_rank_nccl(torch, results, dev)
    print(f"[phase 18] (a) {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    _train_two_ranks(torch, dev)
    print(f"[phase 18] (b) {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    _train_moe_two_ranks(torch, dev)
    print(f"[phase 18] (c) {time.perf_counter() - t2:.1f} s")
    _train_dryrun_table()
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s | {_smi()}")


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2

    results: dict = {}
    t_all = time.perf_counter()

    def timed(phase: str, fn, *args):
        _PHASE["now"] = phase
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{phase}] done in {time.perf_counter() - t0:.1f} s; memory allocated "
              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB (after a garbage collection)")
        return out

    timed("phase 1", phase_env, torch)
    timed("phase 2", phase_kernels, torch, results)
    ar_streams = timed("phase 3", phase_main_path, torch, "float32", results, True)
    timed("phase 4", phase_main_path, torch, "bfloat16", results, False)
    timed("phase 5", phase_int8, torch, results)
    served = timed("phase 6", phase_server, torch, ar_streams, results)
    timed("phase 7", phase_single, torch, served, results)
    timed("phase 8", phase_cascade, torch, served, results)
    timed("phase 9", phase_sampled, torch, served, results)
    timed("phase 10", phase_serving, torch, served, results)
    del served
    torch.cuda.empty_cache()
    timed("phase 10 CLI", phase_cli, torch)
    timed("phase 11", phase_training, torch, results)
    timed("phase 12", phase_models, torch, results)
    timed("phase 13", phase_moe, torch, results)
    timed("phase 14", phase_ssm, torch, results)
    timed("phase 15", phase_media, torch, results)
    timed("phase 16", phase_analysis, torch, results)
    timed("phase 17", phase_mesh, torch, results)
    timed("phase 18", phase_train_mesh, torch, results)
    print(f"[chip_smoke] all phases in {time.perf_counter() - t_all:.1f} s")
    kernels = []
    for name, src, replaces in (
        ("flash_decode", "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:171"),
        ("tree_attention", "src/repro_torch/csrc/tree_attention.cu", "src/repro/kernels/tree_attention.py:54"),
        ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu", "src/repro/kernels/int8_matmul.py:55"),
        ("flash_decode_paged", "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:98"),
        # the counterpart of the reference's lax.cond skips, not of a Pallas kernel
        ("set_cond", "src/repro_torch/csrc/graph_cond.cu", "src/repro/core/engine.py:1083"),
        # the counterpart of the reference's lax.ragged_dot dispatch, not of a Pallas kernel
        ("moe_grouped", "src/repro_torch/csrc/moe_grouped.cu", "src/repro/models/moe.py:143"),
        ("moe_grouped_bf16", "src/repro_torch/csrc/moe_grouped.cu", "src/repro/models/moe.py:143"),
    ):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
