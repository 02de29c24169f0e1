#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card

Phase 1 prints the card and builds the hand-written kernels (one nvcc per
source, in parallel). Phase 2 holds each kernel against its plain PyTorch
version at the main path's shapes and times kernel, plain version, a
library call and the bound. Phases 3-5 drive the single-stream CAS-Spec
path at vicuna-7b width with random weights: float32 AR vs DyTC token
identity, the same in bfloat16, and decode_step through the W8A8 kernel.
The last line is the JSON device record; the line before it lists the
kernels. Exits non-zero, with no result, when any phase fails or when no
CUDA device (or no repro_torch beside this script) is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"attention": 1e-4, "int8": 0.0, "int8_decode_logits": 1e-3}
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


def _bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        log = (_build.BUILD / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    return {"smi": smi}


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


def phase_kernels(torch, results: dict) -> None:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    F = torch.nn.functional
    B, KV, hd, S, pos, window, sink = 1, 32, 128, 2048, 1500, 256, 4
    tol = TOL["attention"]

    # --- flash decode (#1): partials for every kind, dtype and T
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T in (1, 32):
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
            ms = _time_ms(lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree), flush)
            plain = _time_ms(lambda: ref.merge_partials(ref.flash_decode_partial(q, k, v, kv_pos, q_pos), tree), flush)
            # library yardstick: SDPA over [cache ++ staged] with an explicit mask
            qs = q.reshape(B, KV, T, hd)
            ks = torch.cat([kc, kn], dim=1).transpose(1, 2).contiguous()
            vs = torch.cat([vc, vn], dim=1).transpose(1, 2).contiguous()
            am = torch.cat([ref.visible(q_pos, kv_pos, "causal", 0, 0), tmask], dim=-1)[:, None]
            lib = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), flush)
            nbytes = _nbytes(q, k, v, kv_pos, q_pos, *tree) + 4 * q.numel()
            bound, by = _bound_ms(nbytes, 4 * B * KV * T * S_live * hd, str(dtype)[6:])
            timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
            print(f"[phase 2] flash_decode merge   {name:14s} kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"sdpa {lib:.4f} ms  bound {bound:.4f} ms ({by})")
    results["flash_decode"] = dict(max_abs_err=worst, **timing[f"float32_S{MAIN_PATH_S}"])

    # --- tree attention (#2)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for T in (8, 32):
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
                ms = _time_ms(lambda: ta.tree_attention_partial(q, kt, vt, tmask), flush)
                plain = _time_ms(lambda: ref.tree_attention_partial(q, kt, vt, tmask), flush)
                qs = q.reshape(B, KV, T, hd)
                ks, vs = kt.contiguous(), vt.contiguous()
                lib = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=tmask[:, None]), flush)
                nbytes = _nbytes(q, kt, vt, tmask) + 4 * q.numel() + 8 * q.numel() // hd
                bound, by = _bound_ms(nbytes, 4 * B * KV * T * T * hd, name)
                timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
                print(f"[phase 2] tree_attention   {name:8s} kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                      f"sdpa {lib:.4f} ms  bound {bound:.4f} ms ({by})")
    results["tree_attention"] = dict(max_abs_err=worst, **timing["float32"])

    # --- W8A8 (#3)
    worst, timing = 0.0, {}
    # a ragged M (two row tiles, the second partial) for agreement, then the
    # decode step's two MLP shapes, timed
    for (M, K, N) in ((40, 256, 192), (32, 4096, 11008), (32, 11008, 4096)):
        x_q = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        xs = torch.rand(M, 1, generator=gen, device="cuda") / 127
        ws = torch.rand(1, N, generator=gen, device="cuda") / 127
        got = i8.int8_matmul(x_q, w_q, xs, ws)
        want = ref.ref_int8_matmul(x_q, w_q, xs, ws)
        torch.cuda.synchronize()
        e = _err(got, want)
        print(f"[phase 2] int8_matmul ({M},{K})x({K},{N}) err abs={e:.3e} rel={_rel(got, want):.3e}")
        if e > TOL["int8"]:
            raise AssertionError(f"int8_matmul disagrees at ({M},{K},{N})")
        worst = max(worst, e)
        if M != 32:
            continue
        ms = _time_ms(lambda: i8.int8_matmul(x_q, w_q, xs, ws), flush)
        plain = _time_ms(lambda: ref.ref_int8_matmul(x_q, w_q, xs, ws), flush)
        lib = _time_ms(lambda: torch._int_mm(x_q, w_q), flush)
        bound, by = _bound_ms(_nbytes(x_q, w_q, xs, ws) + 4 * M * N, 2 * M * N * K, "int8")
        timing[f"{M}x{K}x{N}"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"[phase 2] int8_matmul ({M},{K})x({K},{N}) kernel {ms:.4f} ms  plain {plain:.4f} ms  "
              f"_int_mm {lib:.4f} ms  bound {bound:.4f} ms ({by})")
    results["int8_matmul"] = dict(max_abs_err=worst, **timing["32x4096x11008"])
    del flush_buf


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
    from repro_torch.kernels import flash_decode, int8_matmul, tree_attention

    return {"flash_decode": flash_decode, "tree_attention": tree_attention, "int8_matmul": int8_matmul}


def _reset_counts() -> None:
    for mod in _counters().values():
        mod.launches = 0


def _read_counts() -> dict:
    return {name: mod.launches for name, mod in _counters().items()}


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


def phase_main_path(torch, dtype: str, results: dict, exact: bool) -> None:
    """AR and DyTC over three prompts at vicuna-7b width in ``dtype``."""
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
    for i, prompt in enumerate(_prompts(cfg.vocab_size)):
        ar, ar_stats, ar_wall, ar_fin = _generate(torch, cfg, params, prompt, dytc=False)
        before = _read_counts()
        dy, dy_stats, dy_wall, dy_fin = _generate(torch, cfg, params, prompt, dytc=True)
        rounds = dy_stats["rounds"]
        per_round = {k: (v - before[k]) / rounds for k, v in _read_counts().items()}
        same = sum(a == b for a, b in zip(ar, dy)) / GEN_TOKENS
        finite = ar_fin and dy_fin
        print(f"[phase {phase}] prompt {i} ({len(prompt)} tokens): AR {ar_stats['target_calls']} target calls "
              f"{ar_wall:.3f} s | DyTC {dy_stats['target_calls']} target calls, {dy_stats['draft_calls']} "
              f"draft calls, {rounds} rounds, {dy_stats['accepted_tokens'] / rounds:.2f} tokens/round, "
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
    call with the plain W8A8 version."""
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
    phase_env(torch)
    phase_kernels(torch, results)
    phase_main_path(torch, "float32", results, exact=True)
    torch.cuda.empty_cache()
    phase_main_path(torch, "bfloat16", results, exact=False)
    torch.cuda.empty_cache()
    phase_int8(torch, results)
    kernels = []
    for name, src, replaces in (
        ("flash_decode", "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:171"),
        ("tree_attention", "src/repro_torch/csrc/tree_attention.cu", "src/repro/kernels/tree_attention.py:54"),
        ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu", "src/repro/kernels/int8_matmul.py:55"),
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
