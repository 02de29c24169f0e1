"""Per-device dry run: the port's counterpart of the reference's
``src/repro/launch/dryrun.py``.

The reference lowers and compiles every (arch x shape) on its production
mesh and reads XLA's memory and cost analysis. The port has no compiler to
ask: it sizes each rank's shard from the same spec trees
(``launch.sharding``) over the leaves ``init_params(device="meta")`` and
``init_cache(device="meta")`` allocate, with the reference's per-device
formula (``_local_bytes``: a leaf's bytes over the product of its sharded
axes) and its traffic model (``analysis.costs.analytic_traffic``), and no
lowering. FLOPs per device are the reference's MODEL_FLOPS over the chips;
the collective term is the counted all-reduce traffic of one decode step
(``analysis.costs.decode_collectives``) or of one train step
(``analysis.costs.train_collectives``: FSDP gathers, TP sums, the
gradients' sums over the data axes), and a train row also holds the
per-device bytes of the gradients (the params' own) and the float32 AdamW
moments. Each row is one JSON object.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vicuna-7b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vicuna-7b --shape decode_32k --mesh model=2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.analysis import costs
from repro_torch.analysis.roofline import RooflineReport
from repro_torch.config import INPUT_SHAPES, get_config, get_shape, list_configs
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, make_production_mesh, parse_mesh_spec
from repro_torch.models import model as M

DRAFT_T = 8          # tree bucket of the serve step (the paper's verify)


def _local_bytes(shape_tree, spec_tree, mesh, itemsize: Optional[int] = None) -> float:
    """Per-device bytes of a sharded tree (leaf bytes / sharded mesh axes),
    the reference's formula; ``shape_tree`` holds tensors (meta ones), at
    ``itemsize`` bytes an element where given, else their own."""
    total = 0.0

    def add(spec, t):
        nonlocal total
        n = float(t.numel()) * (itemsize or t.element_size())
        div = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax,) if isinstance(ax, str) else ax:
                div *= mesh.shape[a]
        total += n / div

    SH.map_specs(add, spec_tree, shape_tree)
    return total


def params_shapes(cfg):
    return SH.full_shapes(cfg)


def supports_long_context(cfg) -> bool:
    """The reference config's ``supports_long_context``: decode at 500k
    needs no full-attention KV a layer."""
    if cfg.attention_pattern in ("none", "sliding"):
        return True
    if cfg.attention_pattern.startswith("local_global:"):
        return True
    return cfg.attn_layer_period > 1


def applicable(cfg, shape) -> bool:
    if shape.seq_len > 100_000:
        return supports_long_context(cfg)
    return True


def _inference_fsdp(cfg) -> bool:
    """TP-only weight shard too big for one of the reference's chips ->
    2D-shard the weights (its rule, kept so the trees are its trees)."""
    return costs.param_count(cfg) * 2 / 16 > 10e9


def _dp_total(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        if a != "model":
            n *= mesh.shape[a]
    return n


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def plan(cfg, shape, mesh) -> dict:
    """Per-device bytes of params, cache and activations of one (arch x
    shape) on ``mesh``, the traffic of one step and its roofline terms."""
    kind = shape.kind
    pshape = params_shapes(cfg)
    pspec = SH.param_specs(cfg, mesh)
    if kind == "train" or _inference_fsdp(cfg):
        pspec = SH.fsdp_upgrade(pspec, pshape, mesh)
    params_local = _local_bytes(pshape, pspec, mesh)
    B, S = shape.global_batch, shape.seq_len
    L, d = cfg.num_layers, cfg.d_model
    chips = mesh.size
    cache_local = act_local = grad_local = moment_local = 0.0
    coll = {}
    if kind == "train":
        act_local = L * B * S * d * 2 * 6 / _dp_total(mesh)
        grad_local = params_local
        moment_local = _local_bytes(pshape, pspec, mesh, itemsize=8)   # float32 mu and nu
        coll = costs.train_collectives(cfg, B, S, data=mesh.shape.get("data", 1),
                                       model=mesh.shape.get("model", 1),
                                       pod=mesh.shape.get("pod", 1))
    elif kind == "prefill":
        cshape = M.init_cache(cfg, B, S, device="meta")
        cache_local = _local_bytes(cshape, SH.cache_specs(cfg, mesh), mesh)
        act_local = L * B * S * d * 2 * 4 / _dp_total(mesh)
    else:
        long_ctx = S > 100_000
        shard_seq = long_ctx and B == 1
        cshape = M.init_cache(cfg, B, S, ring_window=long_ctx, device="meta")
        cspec = SH.cache_specs(cfg, mesh, shard_seq=shard_seq, ring_window=long_ctx)
        cache_local = _local_bytes(cshape, cspec, mesh)
        b_local = B // SH.dp_size(mesh) if SH.batch_axis(mesh, B) is not None else B
        coll = costs.decode_collectives(cfg, b_local, DRAFT_T, S,
                                        model=mesh.shape.get("model", 1))
    traffic = costs.analytic_traffic(kind, params_local, cache_local, act_local)
    flops = costs.model_flops_per_step(cfg, kind, S, B, DRAFT_T) / chips
    rep = RooflineReport(f"{cfg.name}/{shape.name}/{_mesh_name(mesh)}", flops, traffic, coll,
                         bytes_analytic=traffic, dtype=cfg.dtype)
    return {"params_bytes": params_local, "grad_bytes": grad_local,
            "moment_bytes": moment_local, "cache_bytes": cache_local, "act_bytes": act_local,
            "traffic_bytes": traffic, "roofline": rep.to_dict()}


def run_one(arch: str, shape_name: str, *, mesh=None, multi_pod: bool = False,
            out_dir: Optional[str] = None, verbose: bool = True) -> dict:
    """One row: ``mesh`` (default the production mesh) and ``shape_name``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch at 500k"}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    row = {"arch": arch, "shape": shape_name, "status": "ok", "mesh": _mesh_name(mesh),
           "chips": mesh.size, "kind": shape.kind, **plan(cfg, shape, mesh)}
    if verbose:
        rf = row["roofline"]
        print(f"== {arch}/{shape_name}/{row['mesh']} kind={shape.kind}")
        print(f"   bytes/device: params={row['params_bytes'] / 2**30:.2f}GiB "
              f"grads={row['grad_bytes'] / 2**30:.2f}GiB moments={row['moment_bytes'] / 2**30:.2f}GiB "
              f"cache={row['cache_bytes'] / 2**30:.2f}GiB act={row['act_bytes'] / 2**30:.2f}GiB")
        print(f"   flops/device={rf['flops']:.3e} traffic/device={rf['bytes_hbm']:.3e} "
              f"coll={sum(rf['coll_bytes'].values()):.3e}")
        print(f"   t_comp={rf['t_compute'] * 1e3:.3f}ms t_mem={rf['t_memory'] * 1e3:.3f}ms "
              f"t_coll={rf['t_collective'] * 1e3:.3f}ms -> {rf['bottleneck']}-bound")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{row['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(row, f, indent=1)
    return row


def shape_mesh(spec: str) -> Mesh:
    """A shape-only mesh of ``"model=K,data=D"`` (a missing ``data`` axis
    of size 1: the spec trees name it)."""
    sizes = parse_mesh_spec(spec)
    sizes = parse_mesh_spec(",".join(f"{a}={n}" for a, n in {"data": 1, **sizes}.items()))
    return Mesh(tuple(sizes.values()), tuple(sizes), shape_only=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list_configs())
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, help="'model=K,data=D' (default: the production mesh)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    pairs = ([(a, s) for a in list_configs() for s in INPUT_SHAPES] if args.all
             else [(args.arch, args.shape)])
    if any(a is None or s is None for a, s in pairs):
        raise SystemExit("error: pass --arch and --shape, or --all")
    mesh = shape_mesh(args.mesh) if args.mesh else None
    for arch, shp in pairs:
        r = run_one(arch, shp, mesh=mesh, multi_pod=args.multi_pod, out_dir=args.out)
        if r["status"] == "skipped":
            print(f"== {arch}/{shp}: SKIP ({r['reason']})")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
