"""Training entry point of the port: the reference's ``launch/train.py``,
with its flags and its printed lines, on the card.

  python -m repro_torch.launch.train --steps 60 --batch 8 --seq 96 --ckpt ckpt/
  python -m repro_torch.launch.train --device cpu --reduced --steps 3
  python -m repro_torch.launch.train --arch stablelm-1.6b --device cpu --reduced

``--arch`` is any config the port registers (``list_configs()``): the MoE
layers train through the grouped-capacity dispatch and add their auxiliary
losses, the Mamba-2 blocks through the chunked scan. The CLI's corpus is
text, (B, S) tokens, so the codebook stack (musicgen-medium) exits with a
message: it trains on (B, S, nc) batches through
``repro_torch.training.make_train_step``. llava-next-mistral-7b trains on
the text alone.

It runs on the card (``--device cuda``, the default; it raises when there
is none); ``--device cpu`` runs on the CPU. ``--reduced`` trains the
config's reduced width (``ModelConfig.reduced()``), without
rematerialisation, as the reference does. ``--ckpt`` writes a checkpoint
in the reference's format, which ``repro_torch.bridge.params_from_checkpoint``
(or the reference's ``load_checkpoint``) reads. AdamW keeps float32
moments: with float32 params and gradients that is 16 bytes a parameter,
with the config's bfloat16 ones 12, so the full 32-layer vicuna-7b (6.7 B
parameters: 108 GB, or 81 GB) does not fit one 80 GB card; cut the depth
(``dataclasses.replace(cfg, num_layers=8, dtype="float32")``, 30 GB) to
train its full width on one card, or shard it.

``--mesh data=D,model=K`` trains on a ``launch.mesh.Mesh`` of D x K
devices, one process a device: ``torchrun --nproc-per-node D*K -m
repro_torch.launch.train --mesh ...`` (nccl, a card a rank), or
``--spawn`` (the command starts the ranks; ``--device cpu`` over gloo).
Each rank draws its shards of the params one device draws
(``launch.sharding.train_specs``: tensor-parallel over ``model``, each
layer-stack weight's first free dim of at least 512 over ``data``, the
moments alike) and trains on its D-th of every batch's rows; rank 0
prints the lines and writes the checkpoint, gathered whole. A one-device
mesh outside torchrun and ``--spawn`` trains in this process with no
process group.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.config import get_config, list_configs
from repro_torch.data import lm_batches, synthetic_corpus
from repro_torch.launch.mesh import (
    Mesh,
    choose_backend,
    init_distributed,
    parse_mesh_spec,
    rank_device,
    spawn,
)
from repro_torch.models import init_params
from repro_torch.models import shard_utils as SU
from repro_torch.training import adamw_init, make_train_step, save_checkpoint


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="vicuna-7b", choices=list_configs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="'data=D,model=K': train on D x K devices (torchrun, or --spawn)")
    ap.add_argument("--spawn", action="store_true",
                    help="with --mesh: start the ranks from this command")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.num_codebooks:
        raise SystemExit(
            f"error: --arch {args.arch}: this CLI trains on a text corpus of (B, S) tokens; a "
            f"codebook stack ({cfg.num_codebooks} codebooks) trains on (B, S, "
            f"{cfg.num_codebooks}) batches through repro_torch.training.make_train_step")
    if args.reduced:
        cfg = cfg.reduced()
    if args.mesh is None:
        train(cfg, args, device, None)
        return
    try:
        sizes = parse_mesh_spec(args.mesh)
    except ValueError as e:
        raise SystemExit(f"error: bad --mesh {args.mesh!r}: {e}") from None
    world = 1
    for n in sizes.values():
        world *= n
    if args.batch % sizes.get("data", 1):
        raise SystemExit(f"error: --batch {args.batch} does not split over --mesh {args.mesh}'s "
                         "data axis")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(f"error: --mesh {args.mesh} needs {world} processes, torchrun "
                             f"started {os.environ['WORLD_SIZE']}")
        init_distributed(choose_backend(args.device, world),
                         device=rank_device(args.device, int(os.environ.get("LOCAL_RANK", rank))))
        _mesh_rank(rank, world, cfg, args)
    elif args.spawn:
        spawn(_mesh_rank, world, (cfg, args), device=args.device)
    elif world > 1:
        raise SystemExit(f"error: --mesh {args.mesh} runs {world} processes: launch them "
                         "with torchrun or pass --spawn")
    else:
        train(cfg, args, device, None)


def _mesh_rank(rank: int, world: int, cfg, args) -> None:
    """One rank of a ``--mesh`` run: its mesh, its shards, the loop."""
    sizes = parse_mesh_spec(args.mesh)
    device = rank_device(args.device, rank)
    train(cfg, args, device, Mesh(tuple(sizes.values()), tuple(sizes), device=device))


def train(cfg, args, device, mesh) -> None:
    """The training loop on ``device``, on this rank of ``mesh`` (None: one
    device); rank 0 prints and writes the checkpoint."""
    from repro_torch.launch import sharding as SH

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    specs = None if mesh is None else SH.train_specs(cfg, mesh)
    params = init_params(cfg, 0, device=device, mesh=mesh, specs=specs)
    opt = adamw_init(params)
    step = make_train_step(cfg, peak_lr=args.lr, warmup=10, total_steps=args.steps,
                           remat=not args.reduced)
    corpus = synthetic_corpus(cfg.vocab_size, 100_000)
    it = lm_batches(corpus, args.batch, args.seq)
    rows = slice(None)
    if mesh is not None:                    # this rank's rows of every batch
        n = args.batch // SH.dp_size(mesh)
        rows = slice(mesh.index(SU.DATA_AXES) * n, (mesh.index(SU.DATA_AXES) + 1) * n)
    t0 = time.perf_counter()
    with SU.use_mesh(mesh):
        for i in range(args.steps):
            b = {k: torch.as_tensor(v[rows], device=device) for k, v in next(it).items()}
            params, opt, m = step(params, opt, b)
            if i % max(args.steps // 10, 1) == 0:
                say(f"step {i:4d} ce={float(m['ce']):.4f} "
                    f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f}")
    if device.type == "cuda":
        torch.cuda.synchronize()   # steps run asynchronously; settle before timing
    say(f"{args.steps} steps in {time.perf_counter()-t0:.1f}s")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt, step=args.steps, mesh=mesh, cfg=cfg)
        say("saved", args.ckpt)


if __name__ == "__main__":
    main()
