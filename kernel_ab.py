#!/usr/bin/env python3
"""Time the port's kernels from one source tree, for comparing two
versions on the same card.

    python3 kernel_ab.py SRC_ROOT TAG

SRC_ROOT holds a ``repro_torch`` package (``src`` of a checkout, or of an
older commit unpacked with ``git archive`` into a git-ignored directory).
Each run builds that tree's kernels and prints one line per case: the
verify merge of the dense flash decode (B=1, 32 heads, T=32, S=160 and
2048), tree attention (T=32) and the paged merge (B=4, T=16 over 4 pages
of 64 and T=32 over 32 pages), in float32 and bfloat16; the W8A8 product
at M = 4, 32, 64 rows in both MLP shapes (4096 -> 11008, 11008 -> 4096);
one MoE layer's grouped expert GEMM (the gated up projection and the down
projection, two launches) at qwen2-moe-a2.7b's and mixtral-8x22b's expert
shapes, N = 4, 16, 64 tokens in float32 and 4, 16, 64, 128 in bfloat16,
beside its bound and, in bfloat16, ``torch._grouped_mm``'s time.
Every case is timed by CUDA-graph replay with the L2 flushed before every
replay (``chip_smoke._graph_ms``), with the max abs error against the plain
version and, for the paged kernel, whether it is bitwise equal to the dense
kernel on the gathered view (for W8A8, whether it is bitwise equal to the
plain version). Run versions in turns in one call (A, B, B, A): two calls
may land on two cards.
"""
from __future__ import annotations

import os
import sys


def main(root: str, tag: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import tree_attention as ta

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree under {root}")
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        for S in (cs.MAIN_PATH_S, 2048):
            q, kc, vc, kv_pos, q_pos, kn, vn, tm = cs._attn_inputs(
                torch, gen, 1, 32, 32, 32, S, 128, dtype, S - 32)
            q_pos[:, 0] = S - 32
            k, v = kc.transpose(1, 2), vc.transpose(1, 2)
            kt, vt = kn.transpose(1, 2), vn.transpose(1, 2)
            tree = ta.tree_attention_partial(q, kt, vt, tm)
            got = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
            err = cs._err(got, ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kt, vt, tm))
            ms = cs._graph_ms(lambda: fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree), flush)
            rows.append((f"flash_decode merge {dn} T=32 S={S}", ms, err, ""))
        err = max(cs._err(a, b) for a, b in zip(ta.tree_attention_partial(q, kt, vt, tm),
                                                 ref.tree_attention_partial(q, kt, vt, tm)))
        ms = cs._graph_ms(lambda: ta.tree_attention_partial(q, kt, vt, tm), flush)
        rows.append((f"tree_attention {dn} T=32", ms, err, ""))
        for T, n_pp, pos in ((16, 4, (232, 168, 104, 40)), (32, 32, (2016,) * 4)):
            q, kp, vp, table, kv_pos, q_pos, kn, vn, tmask = cs._paged_inputs(
                torch, gen, 4, 32, T, 64, n_pp, dtype, pos)
            tree = ta.tree_attention_partial(q, kn.transpose(1, 2), vn.transpose(1, 2), tmask)
            got = fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree)
            kd, vd = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
            bitwise = torch.equal(got, fd.flash_decode_merge(q, kd, vd, kv_pos, q_pos, tree))
            want = ref.merge_partials(
                ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos), tree)
            ms = cs._graph_ms(
                lambda: fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree), flush)
            rows.append((f"paged merge {dn} B=4 T={T} {n_pp} pages", ms, cs._err(got, want),
                         f" bitwise dense={bitwise}"))
            del kd, vd
    for K, N in cs.W8A8_SHAPES:
        for M in (4, 32, 64):
            x_q, w_q, xs, ws = cs._int8_operands(torch, gen, M, K, N)
            got, want = i8.int8_matmul(x_q, w_q, xs, ws), ref.ref_int8_matmul(x_q, w_q, xs, ws)
            ms = cs._graph_ms(lambda: i8.int8_matmul(x_q, w_q, xs, ws), flush)
            rows.append((f"int8_matmul ({M},{K})x({K},{N})", ms, cs._err(got, want),
                         f" bitwise={torch.equal(got, want)}"))
    rows += _moe_rows(torch, cs, gen, flush)
    for name, ms, err, extra in rows:
        print(f"[{tag}] {name:40s} graph replay {ms:.4f} ms  err {err:.2e}{extra}")
    return 0


def _moe_rows(torch, cs, gen, flush) -> list:
    from repro_torch.analysis import costs as C
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ref

    silu = torch.nn.functional.silu
    rows = []
    for model, d, F, E, K in cs.MOE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype)[6:]
            w_gate, w_up = (torch.randn(E, d, F, generator=gen, device="cuda").mul_(d ** -0.5)
                            .to(dtype) for _ in range(2))
            w_down = torch.randn(E, F, d, generator=gen, device="cuda").mul_(F ** -0.5).to(dtype)
            for N in cs.MOE_TIMED_BF16 if dtype == torch.bfloat16 else cs.MOE_TIMED:
                x_s, offs, _ = cs._moe_sort(torch, *cs._moe_route(torch, gen, N, K, E, d, dtype), E)
                ends = offs[1:].contiguous()

                def layer():
                    h = mg.moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
                    return mg.moe_grouped(h, w_down, offs)

                def lib():
                    h = silu(torch._grouped_mm(x_s, w_gate, offs=ends)) * torch._grouped_mm(
                        x_s, w_up, offs=ends)
                    return torch._grouped_mm(h, w_down, offs=ends)

                h = ref.ref_moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
                err = cs._err(layer(), ref.ref_moe_grouped(h, w_down, offs))
                hit = int((offs[1:] > offs[:-1]).sum())
                bound, _ = C.moe_grouped(N, K, d, F, E, hit, dtype).bound_ms()
                ms = cs._graph_ms(layer, flush)
                extra = f" bound {bound:.4f}"
                if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
                    lib_ms = cs._graph_ms(lib, flush)
                    extra += f" _grouped_mm {lib_ms:.4f} (kernel / library {ms / lib_ms:.2f})"
                rows.append((f"moe_grouped {model} {dn} N={N}", ms, err, extra))
            del w_gate, w_up, w_down
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
