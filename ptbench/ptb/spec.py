"""Find a cell by name: its entry in ``BENCHMARK.json``, its configuration
file, its traffic mix, what belongs to the pair alone (``cells/<cell>.json``:
an open mix's arrival rate), and the metrics it reports. Everything that
belongs to one configuration, one mix, one cell or one metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent          # ptbench/
ROOT = BENCH_DIR.parent                                      # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's object
    traffic: dict           # the mix file's object
    chips: int
    end_to_end: List[dict]  # the cell's end-to-end metric entries
    per_layer: List[dict]   # the cell's per-layer metric entries
    rate_per_s: Optional[float] = None   # an open mix's arrival rate in this cell


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return load_json(path)


def config_file(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def cell_file(name: str) -> Path:
    return BENCH_DIR / "cells" / f"{name}.json"


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, else the reader of the name without its last
    part (``round_ms.chat`` -> ``metrics/round_ms.py``): one reader serves
    the metric in every mix."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    if own.exists() or "." not in name:
        return own
    return BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(BENCH_DIR.parent / cfg_entry["file"])
    traffic = load_json(traffic_file(w["traffic"]))
    rate = None
    if traffic["kind"] == "open":
        rate = float(load_json(cell_file(name))["rate_per_s"])
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                rate_per_s=rate)
