"""The device mesh over ``torch.distributed``: the port of the reference's
``src/repro/launch/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` and lets GSPMD place every
array. The port runs SPMD by hand: one process per device, each holding its
local shard, and a ``Mesh`` names the axes ``("pod", "data", "model")`` (in
that order, the reference's), this process's coordinate on each, and one
process group for every set of axes (the ranks that differ only along
those axes), made with ``torch.distributed.new_group`` by every rank in the
same order. Ranks are laid out row-major over the axes, the last axis
fastest, as ``jax.make_mesh`` orders devices. ``host_group`` spans every
rank over ``gloo``, for host numbers the ranks must agree on
(``shard_utils.host_max``).

Backends are chosen explicitly (``choose_backend``), never by falling back
after a failure: ``nccl`` when every rank owns a card of its own, ``gloo``
on the CPU or when the caller asks ranks to share one card
(``share_card=True``). Under ``gloo`` a CUDA tensor's collective stages
through the host and cannot be captured in a CUDA graph.

Processes come from ``torchrun`` (``init_distributed()`` reads its
environment) or from ``spawn`` (``torch.multiprocessing``, a ``FileStore``
under a temporary directory: no network).

A ``Mesh`` built with ``shape_only=True`` (``make_production_mesh``) holds
shape and names alone, for the spec trees and the dry run; it has no
groups.
"""
from __future__ import annotations

import datetime
import itertools
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = ("pod", "data", "model")


class Mesh:
    """Named mesh axes, this rank's coordinates and the process groups.
    ``shape`` maps each axis name to its size (as a jax mesh's ``shape``);
    ``device`` is the device this rank's shards live on."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, shape_only: bool = False):
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh: shape {tuple(shape)} does not name axes {axis_names}")
        if any(a not in AXES for a in axis_names):
            raise ValueError(f"mesh: axes must come from {AXES}, got {axis_names}")
        order = [a for a in AXES if a in axis_names]
        if list(axis_names) != order:
            raise ValueError(f"mesh: axes must be in the order {AXES}, got {axis_names}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = {a: int(n) for a, n in zip(axis_names, shape)}
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.device = torch.device(device) if device is not None else None
        self.coords: Dict[str, int] = {}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.backend: Optional[str] = None
        self.host_group = None
        if shape_only:
            return
        if not dist.is_initialized():
            raise RuntimeError("mesh: torch.distributed is not initialized "
                               "(init_distributed, spawn or torchrun first)")
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh: {self.shape} needs {self.size} processes, the group has "
                             f"{dist.get_world_size()}")
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, _unravel(self.rank, shape)))
        # every rank creates every group, in one order (new_group's contract)
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, k):
                mine = None
                others = [a for a in axis_names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    ranks = [_ravel({**at, **dict(zip(axes, c))}, axis_names, self.shape)
                             for c in itertools.product(*(range(self.shape[a]) for a in axes))]
                    g = dist.new_group(sorted(ranks))
                    if self.rank in ranks:
                        mine = g
                self._groups[axes] = mine
        # every rank, over gloo: host numbers the ranks must agree on
        self.host_group = dist.new_group(list(range(self.size)), backend="gloo")

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank along ``axes`` (a name or a
        tuple of names; names the mesh lacks are dropped)."""
        key = self._axes(axes)
        if not key:
            raise ValueError(f"mesh {self.shape}: no axis among {axes!r}")
        return self._groups[key]

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (1 for names it lacks)."""
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's linear index along ``axes``, the first axis major."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend}, device={self.device})"


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(tuple(shape)):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(coords: Dict[str, int], names: Sequence[str], shape: Dict[str, int]) -> int:
    r = 0
    for a in names:
        r = r * shape[a] + coords[a]
    return r


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"model=K,data=D"`` -> {axis: size} in the repo's axis order, with
    the reference's validation (``mesh_from_spec``, l.46-70)."""
    sizes = {}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXES or not val.strip().isdigit():
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'model=K,data=D' with "
                "axes from pod/data/model and integer sizes"
            )
        sizes[name] = int(val)
    axes = tuple(a for a in AXES if a in sizes)
    if not axes:
        raise ValueError(f"bad mesh spec {spec!r}: no axes given")
    return {a: sizes[a] for a in axes}


def choose_backend(device, world: int, *, share_card: bool = False) -> str:
    """``gloo`` on the CPU or where ranks share one card (``share_card``);
    ``nccl`` where every rank owns a card, which needs ``world`` cards."""
    dev = torch.device(device)
    if dev.type == "cpu" or share_card:
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"mesh: no backend for device {dev}")
    have = torch.cuda.device_count()
    if world > have:
        raise ValueError(f"mesh: {world} ranks on {have} card(s) need share_card=True "
                         "(gloo) or one card a rank (nccl)")
    return "nccl"


def rank_device(device, rank: int, *, share_card: bool = False) -> torch.device:
    """The device of ``rank``: the CPU, the shared card, or card ``rank``
    (a rank per card, as torchrun's ``LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", dev.index or 0) if share_card else torch.device("cuda", rank)


def init_distributed(backend: str, *, rank: Optional[int] = None, world: Optional[int] = None,
                     init_method: Optional[str] = None, device=None,
                     timeout_s: Optional[float] = None) -> None:
    """``init_process_group`` with an explicit backend. Without
    ``init_method`` the environment torchrun sets (``env://``) is read.
    An NCCL group binds this rank's card (``device``); ``timeout_s`` bounds
    every collective's wait (torch's default otherwise)."""
    if dist.is_initialized():
        return
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(torch.device(device))
        kw["device_id"] = torch.device(device)
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, **kw)


def mesh_from_spec(spec: str, *, device="cuda") -> Mesh:
    """A ``Mesh`` of ``"model=K,data=D"`` over the initialized process
    group (``init_distributed`` first; the group's size must be the mesh's)
    on this rank's device."""
    sizes = parse_mesh_spec(spec)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(tuple(sizes.values()), tuple(sizes), device=rank_device(device, rank))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, shape only: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, shape_only=True)


def make_host_mesh(model: int = 1, data: int = 1, *, device="cpu") -> Mesh:
    """A ("data", "model") mesh over the initialized process group."""
    return mesh_from_spec(f"data={data},model={model}", device=device)


def data_axes(mesh) -> tuple:
    """The (possibly compound) batch-parallel axes of a mesh."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def _spawned(rank: int, world: int, store: str, backend: str, device, share_card: bool,
             timeout_s: Optional[float], fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = rank_device(device, rank, share_card=share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(backend, rank=rank, world=world, init_method=f"file://{store}", device=dev,
                     timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *, device="cuda",
          share_card: bool = False, timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes with the
    default group initialized over a ``FileStore`` in a temporary directory
    (no network), its backend by ``choose_backend``; each process runs one
    CPU thread (a card's rank sets its card current). The ranks run on the
    card unless ``device="cpu"``: the device is resolved before any process
    starts, so a machine without a card raises at once. ``timeout_s``
    bounds each collective's wait. Raises if any process fails."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    backend = choose_backend(device, world, share_card=share_card)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned, args=(world, os.path.join(tmp, "store"), backend, str(device),
                                 share_card, timeout_s, fn, args), nprocs=world, join=True)
