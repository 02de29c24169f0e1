#!/usr/bin/env python3
"""Time the port's served paths from one source tree, for comparing two
versions on the same card.

    python3 serve_ab.py SRC_ROOT TAG

SRC_ROOT holds a ``repro_torch`` package (``src`` of a checkout, or of an
older commit unpacked with ``git archive`` into a git-ignored directory).
Each run builds that tree's kernels, makes vicuna-7b at full width in
float32 with random weights (seed 0) and prints one line per case, with
``chip_smoke.py``'s prompts, settings and helpers: AR over the 128-token
prompt (ms per token, phase 3); the batched server's ``tree_fused`` dense
in split rounds (phase 6) and in single rounds (phase 7), ms per round and
tokens per slot-round, every stream held to AR; and one
``quantized_matmul`` at the gate/up product (32 x 4096 -> 11008, bfloat16)
by CUDA-graph replay (phase 5). Run versions in turns in one call (A, B, B,
A): two calls may land on two cards, and a one-card machine's host, which
drives these host-bound paths, varies from call to call.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time


def main(root: str, tag: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the tree under {root}")
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.core import ARScheduler, SpecEngine, layer_sparsity
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedSpecServer

    _build.build_all()
    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="float32")
    params = init_params(cfg, cs.SEED)
    prompts = cs._prompts(cfg.vocab_size)
    ar_streams = []
    for i, prompt in enumerate(prompts):
        eng = SpecEngine(cfg, params)
        eng.start(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ar_streams.append(ARScheduler(eng).generate(cs.GEN_TOKENS))
        torch.cuda.synchronize()
        if i == len(prompts) - 1:
            ms = (time.perf_counter() - t0) * 1e3 / cs.GEN_TOKENS
            print(f"[serve_ab {tag}] AR prompt {i} ({len(prompt)} tokens): {ms:.2f} ms per token")
        del eng
    spec = layer_sparsity(cfg, 0.5)
    for round_mode in ("split", "single"):
        srv = BatchedSpecServer(cfg, params, mode="tree_fused", draft_spec=spec,
                                round_mode=round_mode, **cs.SERVER)
        rec = cs._serve(torch, srv, prompts, ar_streams)
        print(f"[serve_ab {tag}] tree_fused dense {round_mode} rounds: {rec['requests']} requests "
              f"identical to AR | {rec['rounds']} rounds, {rec['tokens_per_slot_round']:.2f} tokens "
              f"per slot-round, {rec['ms_per_round']:.2f} ms per round")
        del srv
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(32, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(4096, 11008, generator=gen, device="cuda").to(torch.bfloat16)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = cs._graph_ms(lambda: ops.quantized_matmul(x, w), flush_buf.zero_)
    print(f"[serve_ab {tag}] quantized_matmul bfloat16 (32, 4096) x (4096, 11008), graph replay: "
          f"{ms:.4f} ms")
    print(f"[serve_ab {tag}] card {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2]))
