#!/usr/bin/env python3
"""Run one benchmark cell of ``repro_torch`` once.

    python3 ptbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's configuration
(``ptbench/configs/<config>.json``) is served by the program's batched
server through ``ServeLoop`` under its traffic mix
(``ptbench/traffic/<mix>.json``) for ``--seconds``; the last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, and with ``--trace 1`` ``breakdown``, then
``checks``: each number compared with its limit, also the last lines of
standard error). ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (``ptbench/metrics/<name>.py``).

Exits non-zero with no result when no card (or too few) is present, when
the program is missing, or when JAX or the JAX package got loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".ptbench_cache"


def _process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was loaded where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()
sys.path[:0] = [str(BENCH_DIR), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

from ptb import isolation  # noqa: E402

CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda", "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        age=_process_age) -> dict:
    """The result object of one run of ``cell`` (a ``ptb.spec.Cell``)."""
    import torch
    from ptb import harness

    cr = harness.CellRun(cell, device=device)
    cr.build()
    win = cr.serve(seed, seconds, trace=trace, setup_now=age)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = harness.read_metrics(win, entries)
    if device == "cpu":
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace and win.profile is not None:
        dev["busy_s"] = win.profile["busy_s"]
        dev["window_s"] = win.profile["window_s"]
    cr.free()
    verdict = harness.check(cr.params, cell.config, win, seed)
    out = {"correct": verdict["correct"], "attempted": harness.attempted(win),
           "failed": verdict["checks"]["stalled_requests"]["value"], "metrics": metrics,
           "device": dev}
    if trace and win.profile is not None:
        out["breakdown"] = {"device_ops": win.profile["device_ops"],
                            "idle_gaps": win.profile["idle_gaps"]}
    out["checks"] = verdict["checks"]
    return out


def main(argv=None) -> int:
    isolation.install()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE / sub)
    args = parse(sys.argv[1:] if argv is None else argv)
    from ptb import spec

    cell = spec.cell(args.workload)
    missing = [m["name"] for m in cell.end_to_end if not spec.metric_file(m["name"]).exists()]
    if missing:
        print(f"no reader for {missing}", file=sys.stderr)
        return 2
    try:
        import repro_torch.serving  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 6
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = isolation.loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    want = [m["name"] for m in (cell.per_layer if args.trace else cell.end_to_end)]
    lost = [n for n in want if n not in out["metrics"]]
    if not args.trace and lost:
        print(f"end-to-end metrics not read: {lost}", file=sys.stderr)
        return 5
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
