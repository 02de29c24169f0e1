"""Tiny cells for the harness's CPU tests: the benchmark's own configuration
and mix files with every size cut down, float32, on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from ptb import spec  # noqa: E402

MOE = "qwen2-moe-a2.7b"
DENSE = "internlm2-20b"


def tiny_config(arch: str) -> dict:
    cfg = dict(spec.load_json(spec.config_file(arch)), num_layers=4, d_model=64, num_heads=4,
               num_kv_heads=2 if arch == DENSE else 4, head_dim=16, d_ff=96, vocab_size=256,
               dtype="float32")
    if "moe" in cfg:
        cfg["moe"] = dict(num_experts=4, top_k=2, d_ff_expert=32, num_shared_experts=1,
                          d_ff_shared=64)
    cfg["server"] = dict(cfg["server"], max_batch=4)
    return cfg


def tiny_mix(kind: str) -> dict:
    mix = dict(spec.load_json(spec.traffic_file(kind)), requests=120,
               prompt=dict(median=16, sigma=0.5, min=8, max=40),
               output=dict(median=8, sigma=0.5, min=4, max=16))
    if kind == "chat":
        mix["lead_s"] = 0.3
    else:
        mix["open_after_rounds"] = 2
    return mix


def tiny_cell(arch: str, kind: str) -> spec.Cell:
    """The benchmark's cell of ``kind``'s mix, with ``arch``'s configuration
    at a tiny size."""
    real = spec.cell(f"{MOE}.{kind}")
    return spec.Cell(name=f"{arch}.{kind}", config=tiny_config(arch),
                     traffic=tiny_mix(kind), chips=1, end_to_end=real.end_to_end,
                     per_layer=real.per_layer, rate_per_s=8.0 if kind == "chat" else None)
