"""Tables of the dry run's rows: the port's counterpart of the reference's
``src/repro/analysis/report.py::render``.

  PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch] [--mesh 16x16]

A row (``launch/dryrun.py``) holds one (arch x shape x mesh)'s per-device
bytes of params, cache and activations (a train row also its gradients and
AdamW moments) and its roofline terms. "Fits" holds them against one
card's memory (``HBM_GIB``, an H100's 80 GB): the port's analytic sizes,
with no compiler's temporaries.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

HBM_GIB = 80e9 / 2 ** 30      # one H100: 80 GB


def load(dirname: str):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def device_gib(row: dict) -> float:
    """A row's per-device params + gradients + moments (train rows) +
    cache + activations, GiB."""
    return (row["params_bytes"] + row.get("grad_bytes", 0.0) + row.get("moment_bytes", 0.0)
            + row["cache_bytes"] + row["act_bytes"]) / 2 ** 30


def render(rows, mesh: Optional[str] = None, hbm_gib: float = HBM_GIB) -> str:
    """A Markdown table of the rows that ran (on ``mesh``, e.g. ``"16x16"``,
    where given)."""
    out = [
        "| arch | shape | mesh | bottleneck | t_comp (ms) | t_mem (ms) | t_coll (ms) "
        "| FLOPs/dev | params GiB/dev | cache GiB/dev | act GiB/dev | coll GB/dev | fits? |",
        "|---|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|---|",
    ]
    for r in rows:
        if r.get("status") != "ok" or (mesh is not None and r["mesh"] != mesh):
            continue
        rf = r["roofline"]
        need = device_gib(r)
        fits = "yes" if need <= hbm_gib else f"NO ({need:.0f}GiB)"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | **{rf['bottleneck']}** "
            f"| {rf['t_compute'] * 1e3:.2f} | {rf['t_memory'] * 1e3:.2f} "
            f"| {rf['t_collective'] * 1e3:.2f} | {rf['flops']:.2e} "
            f"| {r['params_bytes'] / 2**30:.2f} | {r['cache_bytes'] / 2**30:.2f} "
            f"| {r['act_bytes'] / 2**30:.2f} | {sum(rf['coll_bytes'].values()) / 1e9:.3f} "
            f"| {fits} |"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.report")
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(render(rows, args.mesh))
    skips = [r for r in rows if r.get("status") == "skipped"]
    if skips:
        print("\nSkipped:")
        for r in skips:
            print(f"- {r['arch']} x {r['shape']}: {r['reason']}")


if __name__ == "__main__":
    main()
