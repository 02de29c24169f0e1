"""Mesh-aware helpers that degrade to no-ops off-mesh: the port of the
reference's ``src/repro/models/shard_utils.py``.

The reference constrains placements and lets GSPMD insert collectives. The
port holds each rank's shard explicitly (``launch.sharding.local_shard``),
so its counterparts of ``constrain`` are the collectives themselves, run
over the groups of the mesh that ``use_mesh`` makes active:

  - ``all_sum``: a SUM over a group (the row-parallel sum after ``wo``,
    ``w_down``, ``out_proj``; the vocab-sharded embedding);
  - ``all_max``: a MAX over a group (plan predicates, int8 scales);
  - ``gather``: a gather along one dimension as a SUM into a zeroed
    buffer, exact because x + 0 = x;
  - ``lse_combine``: the cross-rank log-sum-exp combine of softmax
    partials (acc, m, l).

They use ``all_reduce`` alone, which ``gloo`` runs on CUDA tensors and
``nccl`` captures in a CUDA graph; ``COUNTER`` adds up the bytes each
rank sends through it (a ring's share of every payload, on the host).
Without an active mesh every helper returns its input, so ``mesh=None``
runs exactly the single-device code. With a mesh they always run, on an
axis of size 1 too.

In a training graph (an input that requires grad) the collectives carry
gradients, Megatron's conjugate pairs: ``all_sum``'s backward is the
identity where every rank computes the same consumer of the sum (a
row-parallel output), or the SUM again with ``grad_sum`` (the consumers
are this rank's shards); ``enter_shards`` is the identity on a tensor
replicated over an axis where it feeds this rank's shards, its backward
the SUM of the ranks' gradients; ``gather``'s backward is this rank's
slice of the gradient, of the ranks' gradients summed with ``grad_sum``
(FSDP's weights: a reduce-scatter as an all-reduce). Outside one they
launch exactly what they launch without autograd.

``use_mesh(mesh, batch_sharded=...)`` also records whether the per-slot
tensors of the caller are sharded over the data axes: ``host`` then
gathers a per-slot tensor's rows before it reads them, ``local_rows``
cuts a host array to this rank's rows, and ``any_over_data`` reduces a
plan predicate so that every rank takes the same branch.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axis = Union[None, str, Tuple[str, ...]]

# the batch/token-parallel axes in priority order
DATA_AXES = ("pod", "data")

_MESH = None
_BATCH = False


@contextlib.contextmanager
def use_mesh(mesh, *, batch_sharded: bool = False):
    """Make ``mesh`` (or None) the active mesh inside the block;
    ``batch_sharded``: per-slot tensors hold this rank's rows of the data
    axes."""
    global _MESH, _BATCH
    old = (_MESH, _BATCH)
    _MESH, _BATCH = mesh, bool(batch_sharded and mesh is not None)
    try:
        yield mesh
    finally:
        _MESH, _BATCH = old


def active_mesh():
    return _MESH


def _mesh_axes() -> dict:
    return dict(_MESH.shape) if _MESH is not None else {}


def data_axis() -> Axis:
    names = _mesh_axes()
    kept = tuple(a for a in DATA_AXES if a in names)
    return kept if kept else None


def model_axis_size() -> int:
    return _mesh_axes().get("model", 1)


def model_index() -> int:
    """This rank's coordinate on ``model`` (0 off-mesh)."""
    return _MESH.index("model") if _MESH is not None and "model" in _MESH.shape else 0


def tensor_parallel() -> bool:
    """Whether a mesh with a ``model`` axis is active (of any size)."""
    return _MESH is not None and "model" in _MESH.shape


def attention_head_policy(num_heads: int, num_kv_heads: int) -> str:
    """Mirror of ``launch.sharding.attention_policy`` (same ladder) on the
    active mesh."""
    n = model_axis_size()
    if num_kv_heads and num_kv_heads % n == 0:
        return "kv"
    if num_heads and num_heads % n == 0:
        return "q"
    return "none"


def mamba_sharded(num_heads: int) -> bool:
    """Mirror of ``launch.sharding.mamba_policy``: whether a Mamba-2
    block's d_inner (its heads) is sharded over ``model``."""
    return tensor_parallel() and num_heads % model_axis_size() == 0


def seq_shard(seq_axes) -> Tuple[int, int]:
    """(slices, this rank's slice) of a cache sequence-sharded on
    ``seq_axes``: (0, 0) off-mesh or where the mesh lacks one of the axes
    (the reference's ``n_seq = 0``: no context parallelism)."""
    if not seq_axes or _MESH is None or not all(a in _MESH.shape for a in seq_axes):
        return 0, 0
    return _MESH.axis_size(seq_axes), _MESH.index(seq_axes)


# ---------------------------------------------------------------- collectives
# bytes one rank sends through ``all_reduce`` (a ring's 2 (n - 1) / n of each
# payload on a group of n) and the calls, counted on the host
COUNTER = {"bytes": 0.0, "calls": 0}


def reset_counter() -> None:
    COUNTER.update(bytes=0.0, calls=0)


def _all_reduce(y: torch.Tensor, op, axes) -> None:
    """``dist.all_reduce`` of the contiguous ``y`` in place over the group of
    ``axes``, its bytes added to ``COUNTER`` (host arithmetic, no launch)."""
    n = _MESH.axis_size(axes)
    COUNTER["calls"] += 1
    COUNTER["bytes"] += 2.0 * (n - 1) / n * y.numel() * y.element_size()
    dist.all_reduce(y, op=op, group=_MESH.group(axes))


def _reduce(x: torch.Tensor, op, axes) -> torch.Tensor:
    if _MESH is None:
        return x
    if x.dtype == torch.bool:
        y = x.to(torch.uint8).contiguous()
        _all_reduce(y, op, axes)
        return y.bool()
    y = x.contiguous()
    _all_reduce(y, op, axes)
    return y


def _grad(x: torch.Tensor) -> bool:
    """Whether ``x`` is part of a graph autograd will differentiate (a
    training step); serving tensors never are."""
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """SUM over ``axes`` forward. Backward: the identity where every rank
    computes the same consumer of the sum (Megatron's row-parallel
    output), or the SUM again where each rank's consumer is its own shard
    (``grad_sum``: the rank's gradient is a part)."""

    @staticmethod
    def forward(ctx, x, axes, grad_sum):
        ctx.axes, ctx.grad_sum = axes, grad_sum
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, dist.ReduceOp.SUM, axes)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone(memory_format=torch.contiguous_format)
            _all_reduce(g, dist.ReduceOp.SUM, ctx.axes)
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity forward on a tensor replicated over ``axes`` that feeds
    this rank's shards; backward sums the ranks' gradients, each a part."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, dist.ReduceOp.SUM, ctx.axes)
        return g, None


class _Gather(torch.autograd.Function):
    """``gather``'s concatenation forward. Backward: this rank's slice of
    the gradient where every rank computes the same consumers of the
    gathered tensor but only its own rows' gradient is whole on it; with
    ``grad_sum`` (each rank's consumers are its own: FSDP's weights over
    its rows of the batch) the ranks' gradients summed first, then cut
    (a reduce-scatter, as an all-reduce)."""

    @staticmethod
    def forward(ctx, x, dim, axes, grad_sum):
        ctx.dim, ctx.w, ctx.axes, ctx.grad_sum = dim, x.shape[dim], axes, grad_sum
        ctx.lo = _MESH.index(axes) * ctx.w
        return _gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone(memory_format=torch.contiguous_format)
            _all_reduce(g, dist.ReduceOp.SUM, ctx.axes)
        return g.narrow(ctx.dim, ctx.lo, ctx.w), None, None, None


def all_sum(x: torch.Tensor, axes: Axis = "model", *, grad_sum: bool = False) -> torch.Tensor:
    """SUM of ``x`` over the group of ``axes``; ``x`` off-mesh. Outside a
    training graph it returns a tensor that may be ``x`` itself, summed in
    place. In one (``x`` requires grad) the sum is a fresh tensor and its
    backward is the identity, or the SUM of the ranks' gradients with
    ``grad_sum`` (a sum whose consumers are this rank's shards)."""
    if _MESH is not None and _grad(x):
        return _Sum.apply(x, axes, grad_sum)
    return _reduce(x, dist.ReduceOp.SUM, axes)


def all_max(x: torch.Tensor, axes: Axis = "model") -> torch.Tensor:
    """MAX of ``x`` over the group of ``axes``; ``x`` off-mesh."""
    return _reduce(x, dist.ReduceOp.MAX, axes)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The row-parallel sum over ``model`` where a mesh has that axis."""
    return all_sum(x, "model") if tensor_parallel() else x


def enter_shards(x: torch.Tensor, axes: Axis = "model") -> torch.Tensor:
    """``x``, replicated over ``axes``, where it feeds this rank's shards
    (a column-parallel product, a slice of heads): the identity, whose
    backward in a training graph sums the ranks' gradients over ``axes``
    (Megatron's pair of the row-parallel sum). ``x`` itself outside a
    training graph, off-mesh and on a mesh without those axes."""
    if _MESH is None or not _grad(x) or not any(a in _MESH.shape for a in _axes_of(axes)):
        return x
    return _Enter.apply(x, axes)


def _axes_of(axes: Axis) -> Tuple[str, ...]:
    return () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)


def _gather(x: torch.Tensor, dim: int, axes: Axis) -> torch.Tensor:
    n, i = _MESH.axis_size(axes), _MESH.index(axes)
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = w * n
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros(shape, dtype=dtype, device=x.device)
    buf.narrow(dim, i * w, w).copy_(x)
    _all_reduce(buf, dist.ReduceOp.SUM, axes)
    return buf.bool() if x.dtype == torch.bool else buf


def gather(x: torch.Tensor, dim: int, axes: Axis = "model", *,
           grad_sum: bool = False) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` over the group of ``axes``,
    concatenated in the group's order: a SUM into a zeroed buffer, where
    each rank wrote its own slice (x + 0 = x, so it is exact). In a
    training graph its backward is this rank's slice of the gradient, of
    the ranks' gradients summed with ``grad_sum``."""
    if _MESH is None:
        return x
    dim = dim % x.ndim
    if _grad(x):
        return _Gather.apply(x, dim, axes, grad_sum)
    return _gather(x, dim, axes)


def lse_combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, axes: Axis):
    """Softmax partials (acc (..., hd), m (...), l (...)) of disjoint key
    sets, one set a rank, combined across the group of ``axes`` by
    logsumexp (the reference's ``decode_attention`` l.340-350): the max,
    then the rescaled sums. Returns the combined (acc, m, l)."""
    if _MESH is None:
        return acc, m, l
    m_c = all_max(m.clone(), axes)
    w = torch.exp(m - m_c)
    l_c = all_sum(l * w, axes)
    acc_c = all_sum(acc * w[..., None], axes)
    return acc_c, m_c, l_c


def host_max(v: float) -> float:
    """A host number every rank must agree on (a wall-clock cost the
    server plans from): the MAX over all ranks, through the mesh's ``gloo``
    host group on a CPU tensor (no device sync); ``v`` off-mesh."""
    if _MESH is None:
        return v
    t = torch.tensor([v], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_MESH.host_group)
    return float(t[0])


# ------------------------------------------------------------ per-slot data
def data_size() -> int:
    return _MESH.axis_size(DATA_AXES) if _MESH is not None else 1


def data_index() -> int:
    return _MESH.index(DATA_AXES) if _MESH is not None else 0


def any_over_data(pred: torch.Tensor) -> torch.Tensor:
    """A plan predicate, reduced with MAX over the data axes where per-slot
    tensors are sharded there, so that every rank launches the same graph
    and takes the same host branch."""
    if not _BATCH:
        return pred
    return all_max(pred, DATA_AXES)


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A per-slot tensor's rows of every data rank (a no-op where the rows
    are not sharded)."""
    if not _BATCH:
        return x
    return gather(x, dim, DATA_AXES)


def host(x: torch.Tensor, dim: int = 0) -> np.ndarray:
    """Read a per-slot tensor on the host, its rows gathered over the data
    axes first where they are sharded."""
    return gather_rows(x, dim).cpu().numpy()


def local_rows(a, dim: int = 0):
    """This rank's rows of a per-slot host array (the array itself where
    the rows are not sharded)."""
    if not _BATCH:
        return a
    a = np.asarray(a)
    n = a.shape[dim] // data_size()
    return np.take(a, np.arange(data_index() * n, (data_index() + 1) * n), axis=dim)


def owns_row(b: int, rows: int) -> Optional[int]:
    """The local index of global row ``b`` of ``rows`` where this rank holds
    it, else None (every rank holds every row where rows are not
    sharded)."""
    if not _BATCH:
        return b
    n = rows // data_size()
    lo = data_index() * n
    return b - lo if lo <= b < lo + n else None
