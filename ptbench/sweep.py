#!/usr/bin/env python3
"""Find an open-loop cell's knee: the highest arrival rate that the server
sustains without a growing queue.

    python3 ptbench/sweep.py --workload <config>.chat --rates 0.6,0.8,1.0 --seconds S

Builds the cell once and serves its mix at each rate in turn (the same
table, its arrival gaps scaled by 1 / rate). One JSON line a rate: the
end-to-end metrics, the queue wait of the requests due in the window's
first and second halves, and the requests still queued at its close. A
queue that grows shows as a second-half wait well above the first's. The
cell's rate (``cells/<cell>.json``) is set once from this, at about four fifths
of the knee; the benchmark's own runs never run this.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent / "src")]

import argparse  # noqa: E402

from ptb import isolation  # noqa: E402


def queue_stats(win) -> dict:
    mid = (win.w0 + win.w1) / 2
    halves = {"first": [], "second": []}
    queued = 0
    for r in win.requests:
        if r["due"] is None or not (win.w0 <= r["due"] <= win.w1):
            continue
        if r["admitted_at"] is None:
            queued += 1
            continue
        halves["first" if r["due"] < mid else "second"].append(r["admitted_at"] - r["due"])
    mean = {k: (sum(v) / len(v) if v else None) for k, v in halves.items()}
    return {"wait_first_s": mean["first"], "wait_second_s": mean["second"],
            "queued_at_close": queued,
            "due_in_window": sum(len(v) for v in halves.values()) + queued}


def main(argv=None) -> int:
    isolation.install()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    from ptb import harness, spec, traffic

    cell = spec.cell(args.workload)
    cr = harness.CellRun(cell)
    cr.build()
    for r in [float(x) for x in args.rates.split(",")]:
        cr.rate = r
        cr.table = traffic.table(cr.mix, r)
        win = cr.serve(args.seed, args.seconds, trace=True, profile=False)
        out = {"rate_per_s": r, **queue_stats(win)}
        for m in [m for m in cell.end_to_end if m["name"] != "setup_s"] + [x for x in cell.per_layer
                                         if x["source"] != "device_trace"]:
            v = harness.load_reader(m["name"])(win)
            out[m["name"]] = v
        print(json.dumps(out), flush=True)
        cr.reset()
    return 0


if __name__ == "__main__":
    sys.exit(main())
