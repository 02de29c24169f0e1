#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card

Phase 1 prints the card and builds the hand-written kernels (one nvcc per
source, in parallel). Phase 2 holds each kernel against its plain PyTorch
version at the main path's shapes (the paged flash decode also bitwise
against the dense kernel on the gathered view) and times kernel, plain
version, a library call and the bound, the kernels also by replaying a
captured CUDA graph. Phases 3-5 drive the single-stream CAS-Spec path at
vicuna-7b width with random weights: float32 AR vs DyTC token identity, the
same in bfloat16, and decode_step through the W8A8 kernel. Phase 6 drives
the batched server (tree_fused and chain_fused, dense and paged caches,
four slots) at the same width in float32 and holds every stream to AR.
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


def _paged_inputs(torch, gen, B, KV, T, P, n_pp, dtype, pos):
    """Paged verify inputs: pools (NP, P, KV, hd) in the model's layout with
    two spare pages, a scrambled table whose last batch row ends in -1
    entries, kv_pos from ``pos`` (B,) (partial tail pages)."""
    dev, hd = "cuda", 128
    NP = B * n_pp + 2
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    q = mk(B, KV, T, hd)
    k_pages, v_pages = mk(NP, P, KV, hd), mk(NP, P, KV, hd)
    perm = torch.randperm(NP, generator=gen, device=dev).to(torch.int32)
    table = perm[: B * n_pp].reshape(B, n_pp).contiguous()
    n_last = -(-int(pos[-1]) // P)
    table[-1, n_last:] = -1                              # an unallocated tail
    S = n_pp * P
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    pos_t = torch.as_tensor(pos, device=dev, dtype=torch.int32)[:, None]
    kv_pos = torch.where(slots < pos_t, slots, torch.full_like(slots, -1)).contiguous()
    q_pos = (pos_t + torch.arange(T, device=dev, dtype=torch.int32)[None]).contiguous()
    kn, vn = mk(B, T, KV, hd), mk(B, T, KV, hd)
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
    tm[3, 2] = False
    return q, k_pages, v_pages, table, kv_pos, q_pos, kn, vn, tm[None].expand(B, T, T).contiguous()


def _paged_kernel(torch, gen, flush, results: dict) -> None:
    """The paged flash decode (#4): against its plain version and bitwise
    against the dense kernel on the gathered view, at the agreement shapes
    and at the server's, where it is also timed."""
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
            if dtype is not torch.float32:
                continue
            run = lambda: fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree)  # noqa: E731
            ms, graph = _time_ms(run, flush), _graph_ms(run, flush)
            # the dense kernel over the gathered view: what reading through the table costs
            dense = lambda: fd.flash_decode_merge(q, kd, vd, kv_pos, q_pos, tree)  # noqa: E731
            dense_ms, dense_graph = _time_ms(dense, flush), _graph_ms(dense, flush)
            plain = _time_ms(lambda: ref.merge_partials(
                ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos), tree), flush)
            # library yardstick: index_select gather + SDPA with an explicit mask
            am = torch.cat([ref.visible(q_pos, kv_pos, "causal", 0, 0), tmask], dim=-1)[:, None]
            idx = table.clamp_min(0).flatten()

            def library():
                kg = kp.index_select(0, idx).reshape(B, S, KV, hd)
                vg = vp.index_select(0, idx).reshape(B, S, KV, hd)
                ks = torch.cat([kg, kn], dim=1).transpose(1, 2)
                vs = torch.cat([vg, vn], dim=1).transpose(1, 2)
                return F.scaled_dot_product_attention(q, ks, vs, attn_mask=am)

            lib = _time_ms(library, flush)
            del kd, vd
            # the least work this data needs: each slot's live rows, read once
            live = sum(pos)
            elt = q.element_size()
            nbytes = (_nbytes(q, kv_pos, q_pos, table, *tree) + 2 * live * KV * hd * elt
                      + 4 * q.numel())
            bound, by = _bound_ms(nbytes, 4 * KV * T * live * hd, "float32")
            timing[(T, n_pp)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                     bound_by=by)
            print(f"[phase 2] flash_decode paged merge {name} (S={S}, {live} live rows): "
                  f"kernel {ms:.4f} ms (graph replay {graph:.4f} ms)  dense kernel on the "
                  f"gathered view {dense_ms:.4f} ms (graph replay {dense_graph:.4f} ms)  plain "
                  f"{plain:.4f} ms  gather+sdpa {lib:.4f} ms  bound {bound:.4f} ms ({by}, "
                  f"{nbytes / 1e6:.2f} MB)")
    results["flash_decode_paged"] = dict(max_abs_err=worst, **timing[(16, 4)])


def phase_kernels(torch, results: dict) -> None:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ref
    from repro_torch.kernels import tree_attention as ta

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    F = torch.nn.functional
    _paged_kernel(torch, gen, flush, results)
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
            ms = _time_ms(lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree), flush)
            graph = _graph_ms(lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree), flush)
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
            print(f"[phase 2] flash_decode merge   {name:14s} kernel {ms:.4f} ms (graph replay "
                  f"{graph:.4f} ms)  plain {plain:.4f} ms  sdpa {lib:.4f} ms  bound {bound:.4f} ms ({by})")
    results["flash_decode"] = dict(max_abs_err=worst, **timing[f"float32_S{MAIN_PATH_S}"])

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
                ms = _time_ms(lambda: ta.tree_attention_partial(q, kt, vt, tmask), flush)
                graph = _graph_ms(lambda: ta.tree_attention_partial(q, kt, vt, tmask), flush)
                plain = _time_ms(lambda: ref.tree_attention_partial(q, kt, vt, tmask), flush)
                qs = q.reshape(B, KV, T, hd)
                ks, vs = kt.contiguous(), vt.contiguous()
                lib = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=tmask[:, None]), flush)
                nbytes = _nbytes(q, kt, vt, tmask) + 4 * q.numel() + 8 * q.numel() // hd
                bound, by = _bound_ms(nbytes, 4 * B * KV * T * T * hd, name)
                timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
                print(f"[phase 2] tree_attention   {name:8s} kernel {ms:.4f} ms (graph replay "
                      f"{graph:.4f} ms)  plain {plain:.4f} ms  sdpa {lib:.4f} ms  bound {bound:.4f} ms ({by})")
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
        graph = _graph_ms(lambda: i8.int8_matmul(x_q, w_q, xs, ws), flush)
        plain = _time_ms(lambda: ref.ref_int8_matmul(x_q, w_q, xs, ws), flush)
        lib = _time_ms(lambda: torch._int_mm(x_q, w_q), flush)
        bound, by = _bound_ms(_nbytes(x_q, w_q, xs, ws) + 4 * M * N, 2 * M * N * K, "int8")
        timing[f"{M}x{K}x{N}"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"[phase 2] int8_matmul ({M},{K})x({K},{N}) kernel {ms:.4f} ms (graph replay {graph:.4f} ms)  "
              f"plain {plain:.4f} ms  _int_mm {lib:.4f} ms  bound {bound:.4f} ms ({by})")
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
    """Kernel name -> (module, the module integer its wrapper counts in)."""
    from repro_torch.kernels import flash_decode, int8_matmul, tree_attention

    return {"flash_decode": (flash_decode, "launches"),
            "flash_decode_paged": (flash_decode, "paged_launches"),
            "tree_attention": (tree_attention, "launches"),
            "int8_matmul": (int8_matmul, "launches")}


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


# ------------------------------------------------------------------ phase 6
SERVER = dict(max_batch=4, max_len=1024, draft_k=4, tree_expansions=5, adaptive=True)
PAGE = 64


def _serve(torch, srv, prompts, ar_streams, readmit=()):
    """Admit ``prompts`` into slots 0.., step until every slot holds
    GEN_TOKENS tokens (a finished slot is released; the slots in
    ``readmit`` are admitted once more with the same prompt, onto the pages
    they gave back, in reverse order), and hold every stream to its AR
    stream. Returns a record of the run."""
    paged_kw = dict(max_new_tokens=GEN_TOKENS) if srv.paged else {}
    for b, p in enumerate(prompts):
        srv.add_request(b, p, **paged_kw)
    todo = list(readmit)
    gen = {b: [] for b in range(len(prompts))}
    done = []                                      # (prompt index, stream)
    torch.cuda.synchronize()
    _reset_counts()
    steps0 = dict(srv.stats)
    slot_rounds, t0 = 0, time.perf_counter()
    while gen:
        slot_rounds += len(gen)
        for b, toks in srv.step().items():
            gen[b].extend(toks)
        for b in [b for b, g in gen.items() if len(g) >= GEN_TOKENS]:
            done.append((b, gen.pop(b)))
            srv.release(b)
            if b in todo:
                todo.remove(b)
                srv.add_request(b, prompts[b], **paged_kw)
                gen[b] = []
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    st = {k: v - steps0[k] for k, v in srv.stats.items()}
    for i, stream in done:
        if stream[:GEN_TOKENS] != ar_streams[i][:GEN_TOKENS]:
            raise AssertionError(f"prompt {i}: the server's stream left AR:\n"
                                 f"AR     {ar_streams[i][:GEN_TOKENS]}\nserver {stream[:GEN_TOKENS]}")
    return dict(requests=len(done), rounds=st["steps"], target_calls=st["target_calls"],
                draft_dispatches=st["draft_dispatches"], tokens=st["tokens"],
                tokens_per_slot_round=st["tokens"] / slot_rounds, wall_s=wall,
                launches=counts, launches_per_round={k: v / st["steps"] for k, v in counts.items()})


def phase_server(torch, ar_streams: list, results: dict) -> None:
    """The batched server at vicuna-7b width, float32, four slots: tree_fused
    dense and paged, chain_fused paged, and tree_fused on a pool sized for
    the requests alone with two slots released and re-admitted. Every
    stream equals the AR stream of its prompt; a dense and a paged
    decode_step over the same admitted state give bitwise-equal logits."""
    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.core import SpecEngine, layer_sparsity
    from repro_torch.core.tree import bucket_for
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

    def server(mode, paged, **kw):
        return BatchedSpecServer(cfg, params, mode=mode, draft_spec=spec, paged=paged,
                                 page_size=PAGE, **SERVER, **kw)

    # one dense and one paged decode_step over the same admitted state
    dense, paged = server("tree_fused", False), server("tree_fused", True)
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

    # the server's own reservation: prompt + GEN_TOKENS + two tree buckets
    slack = 2 * bucket_for(1 + SERVER["draft_k"] + 2 * SERVER["tree_expansions"])
    runs = [("tree_fused dense", "tree_fused", False, {}, ()),
            ("tree_fused paged", "tree_fused", True, {}, ()),
            ("chain_fused paged", "chain_fused", True, {}, ()),
            ("tree_fused paged, undersubscribed pool, 2 re-admissions", "tree_fused", True,
             dict(num_pages=sum(-(-(len(p) + GEN_TOKENS + slack) // PAGE) for p in prompts)),
             (0, 1))]
    paged_launches = 0
    for name, mode, is_paged, kw, readmit in runs:
        srv = server(mode, is_paged, **kw)
        rec = _serve(torch, srv, prompts, ar_streams, readmit)
        pages = f", pool {len(srv._free_pages)} pages free at the end" if is_paged else ""
        print(f"[phase 6] {name}: {rec['requests']} requests identical to AR | {rec['rounds']} rounds, "
              f"{rec['target_calls']} target calls, {rec['draft_dispatches']} draft passes, "
              f"{rec['tokens']} tokens, {rec['tokens_per_slot_round']:.2f} tokens per slot-round, "
              f"{rec['wall_s']:.3f} s{pages} | launches per round: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rec["launches_per_round"].items()))
        counts = rec["launches"]
        used = "flash_decode_paged" if is_paged else "flash_decode"
        unused = "flash_decode" if is_paged else "flash_decode_paged"
        if counts[used] <= 0 or counts["tree_attention"] <= 0 or counts[unused] != 0:
            raise AssertionError(f"{name}: launches {counts} do not show the {used} path")
        paged_launches += counts["flash_decode_paged"]
        del srv
        torch.cuda.empty_cache()
    results["flash_decode_paged"]["launches"] = paged_launches
    del params
    torch.cuda.empty_cache()


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
    ar_streams = phase_main_path(torch, "float32", results, exact=True)
    torch.cuda.empty_cache()
    phase_main_path(torch, "bfloat16", results, exact=False)
    torch.cuda.empty_cache()
    phase_int8(torch, results)
    torch.cuda.empty_cache()
    phase_server(torch, ar_streams, results)
    kernels = []
    for name, src, replaces in (
        ("flash_decode", "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:171"),
        ("tree_attention", "src/repro_torch/csrc/tree_attention.cu", "src/repro/kernels/tree_attention.py:54"),
        ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu", "src/repro/kernels/int8_matmul.py:55"),
        ("flash_decode_paged", "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:98"),
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
