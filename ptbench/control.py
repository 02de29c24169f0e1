#!/usr/bin/env python3
"""Readings for a cell's correctness limits, in one process.

    python3 ptbench/control.py --workload <cell> --seeds 101,102,... --seconds S [--fault F]

Builds the cell once, then for each seed serves one window at the cell's
own load and judges the same sample three ways through the harness's own
comparison (``harness.check``) at the configuration's limits: the
program's served tokens (the lower readings), the control's first choices
(the reference computed in float8; the upper readings: it has to come
out not correct) and the witness's (the reference in bfloat16, the served
precision; a reading, never judged). Then a few wrong tokens planted in
the judged record (one, eight and 24, in the longest request), judged again.
With ``--fault``, the program's step is broken the whole process long
(``ptb.faults``), so each seed reads that fault at the cell's size. One
JSON line a seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]

import argparse  # noqa: E402

from ptb import isolation  # noqa: E402

PLANTED = (1, 8, 24)        # wrong tokens planted in the judged record


def main(argv=None) -> int:
    isolation.install()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None, help="a fault of ptb.faults.FAULTS")
    args = ap.parse_args(argv)
    import torch
    from ptb import faults, harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cr = harness.CellRun(cell)
    t0 = time.perf_counter()
    cr.build()
    if args.fault:
        faults.plant(cr, args.fault)
    print(json.dumps({"built_s": time.perf_counter() - t0, "fault": args.fault}), flush=True)
    V = int(cell.config["vocab_size"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        win = cr.serve(seed, args.seconds)
        metrics = harness.read_metrics(win, [m for m in cell.end_to_end if m["name"] != "setup_s"])
        t1 = time.perf_counter()
        v = harness.check(cr.params, cell.config, win, seed,
                          sides=("served", "control", "witness"))
        line = {"seed": seed, "correct": v["correct"],
                "control_correct": v["by_side"]["control"]["correct"],
                "control_checks": {k: c["value"] for k, c in
                                   v["by_side"]["control"]["checks"].items()},
                **v["numbers"], "sampled": v["sampled"]}
        if v["sampled"] and not args.fault:
            for n in PLANTED:
                p = harness.check(cr.params, cell.config,
                                  faults.altered_record(win, v["sampled"][0], n, V), seed)
                line[f"planted_{n}_correct"] = p["correct"]
                line.update({f"planted_{n}_{k}": x for k, x in p["numbers"].items()
                             if k.startswith("served_") and k != "served_tokens"})
        line.update(metrics={k: m["value"] for k, m in metrics.items()},
                    serve_s=t1 - t0, judge_s=time.perf_counter() - t1)
        print(json.dumps(line), flush=True)
        cr.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
