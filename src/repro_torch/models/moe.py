"""Mixture-of-Experts layer: the port of the reference's
``src/repro/models/moe.py``, with its two dispatch paths.

Dropless (``mode="infer"``, the reference's ``_dropless_ragged``, serving):
exact top-k with no capacity drops, so a token's output never depends on
the tokens batched with it, which lossless speculative verification needs.

Grouped capacity (``mode="train"`` with ``capacity_factor``, and
``"infer_grouped"`` with ``infer_capacity_factor``; the reference's
``_grouped_capacity``): the N tokens split into G groups (``exec_groups``,
halved until it divides N), each expert takes at most
C = max(1, int(cf * N/G * K / E + 0.999)) rows a group, first come first
served in token-major, k-minor order; the rows past C are dropped. The
dispatch and the combine are gathers through a slot table, and the expert
products are batched matmuls (``_expert_ffn``, ``torch.einsum``), as the
reference computes them outside any Pallas kernel. Its auxiliary losses
(load balance and router z) come from the router.

The dropless dispatch reads nothing on the host, so a captured CUDA round
holds it: a stable sort of the flat expert ids, the experts' row offsets by
``searchsorted``, two launches of the grouped expert GEMM
(``kernels/moe_grouped.py``: the gated up projection, then the down
projection) and a gathered combine that adds each token's K weighted
expert rows in top-k order (no float atomics, whose order changes between
runs and with the batch).

Shared experts (Qwen2-MoE) are an always-on MLP scaled by a float32
sigmoid gate. The router weights stay float32 whatever the model's type,
and routing runs in float32, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import MoEConfig
from repro_torch.kernels.moe_grouped import moe_grouped
from repro_torch.models import shard_utils as SU
from repro_torch.models.layers import Init, _gelu_tanh, mlp_apply, mlp_init
from repro_torch.models.ssm import FLOAT32_LEAVES as SSM_FLOAT32_LEAVES

# leaves the reference keeps in float32 whatever the model's type
FLOAT32_LEAVES = ("w_router",)

MODES = ("train", "infer", "infer_grouped")


def moe_init(d_model: int, moe: MoEConfig, gated: bool, dtype: torch.dtype) -> dict:
    """The leaves of one MoE layer, as the reference's ``moe_init`` (l.32)
    makes them: names, shapes and scales (``Init``); ``w_router`` is
    float32 whatever ``dtype``."""
    E, F = moe.num_experts, moe.d_ff_expert
    scale_in, scale_out = d_model ** -0.5, F ** -0.5
    p = {
        "w_router": Init((d_model, E), scale_in, torch.float32),
        "w_up": Init((E, d_model, F), scale_in, dtype),
        "w_down": Init((E, F, d_model), scale_out, dtype),
    }
    if gated:
        p["w_gate"] = Init((E, d_model, F), scale_in, dtype)
    if moe.num_shared_experts:
        f_sh = moe.d_ff_shared or moe.d_ff_expert * moe.num_shared_experts
        p["shared"] = mlp_init(d_model, f_sh, gated, dtype)
        p["w_shared_gate"] = Init((d_model, 1), scale_in, dtype)
    return p


def keeps_float32(key: str) -> bool:
    """Whether the leaf at checkpoint key ``key`` (``['a']/['b']`` form)
    stays float32 whatever type the model's other leaves take: the MoE
    router and a Mamba-2 block's ``A_log``, ``D`` and ``dt_bias``."""
    return any(key.endswith(f"['{name}']") for name in FLOAT32_LEAVES + SSM_FLOAT32_LEAVES)


def _router(params: dict, xf: torch.Tensor, moe: MoEConfig, with_aux: bool,
            over_data: bool = False):
    """float32 routing: softmax over the router logits, top-k, the weights
    renormalised (floor 1e-9). Returns (top_w (N, K) float32, top_ids (N, K)
    int64, aux or None). ``over_data``: the rows are this rank's share of a
    batch split over the data axes, and the aux losses' means are the
    global batch's (each rank's means weighted by its share and summed over
    the data axes in one all-reduce, whose backward is the identity: the
    data sum of the ranks' gradients is then the global loss's)."""
    logits = xf.float() @ params["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, moe.top_k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    if not with_aux:
        return top_w, top_ids, None
    E = moe.num_experts
    # the top-k ids of a row are distinct: the one-hot sum over k is a 0/1 scatter
    hit = torch.zeros_like(probs).scatter_(1, top_ids, 1.0)
    density, mean_prob = hit.mean(dim=0), probs.mean(dim=0)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    if over_data:
        share = 1.0 / SU.data_size()          # every rank holds as many rows
        means = SU.all_sum(torch.cat([density, mean_prob, z[None]]) * share, SU.DATA_AXES)
        density, mean_prob, z = means[:E], means[E:2 * E], means[2 * E]
    aux = {
        "load_balance": E * torch.sum(density / moe.top_k * mean_prob) * moe.load_balance_loss,
        "router_z": z * moe.router_z_loss,
    }
    return top_w, top_ids, aux


def _dropless(params: dict, xf: torch.Tensor, top_w, top_ids, moe: MoEConfig, act: str,
              gated: bool) -> torch.Tensor:
    """The reference's ``_dropless_ragged`` (l.143) without a host read:
    rows sorted by expert (stable), offsets by ``searchsorted``, the grouped
    expert GEMM, then each token's K rows gathered back and added in top-k
    order."""
    N, d = xf.shape
    E, K = moe.num_experts, moe.top_k
    flat_e = top_ids.reshape(N * K)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(E + 1, device=xf.device, dtype=sorted_e.dtype)
    offs = torch.searchsorted(sorted_e, experts, out_int32=True)
    xs = xf.index_select(0, torch.div(order, K, rounding_mode="floor"))
    kind = "silu" if act == "silu" else "gelu"
    if gated:
        h = moe_grouped(xs, params["w_gate"], offs, act=kind, w_mul=params["w_up"])
    else:
        h = moe_grouped(xs, params["w_up"], offs, act=kind)
    eo_sorted = moe_grouped(h, params["w_down"], offs)
    # the inverse permutation: a scatter of distinct indices, exact on every device
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(N * K, device=xf.device))
    eo = eo_sorted.index_select(0, inv).view(N, K, d)
    w = top_w.to(xf.dtype)
    y = eo[:, 0] * w[:, :1]
    for k in range(1, K):
        y = y + eo[:, k] * w[:, k:k + 1]
    return y


def _expert_ffn(params: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Every expert's MLP over its rows: x (E, C, d) or (G, E, C, d), one
    batched product a matrix (the reference's l.67-90)."""
    fn = F.silu if act == "silu" else _gelu_tanh
    if x.ndim == 3:
        eq_up, eq_dn = "ecd,edf->ecf", "ecf,efd->ecd"
    else:
        eq_up, eq_dn = "gecd,edf->gecf", "gecf,efd->gecd"
    if gated:
        h = fn(torch.einsum(eq_up, x, params["w_gate"])) * torch.einsum(eq_up, x, params["w_up"])
    else:
        h = fn(torch.einsum(eq_up, x, params["w_up"]))
    return torch.einsum(eq_dn, h, params["w_down"])


def capacity_slots(top_ids: torch.Tensor, moe: MoEConfig, cf: float, *,
                   over_data: bool = False):
    """Where each (token, k) pair of ``top_ids`` (N, K) lands in the grouped
    dispatch, as the reference computes it (l.93-112): the groups G
    (``exec_groups`` halved until it divides N), each expert's capacity C a
    group, and per group in token-major, k-minor order the pair's slot
    ``expert * C + rank`` (its rank among the group's earlier pairs of that
    expert: a cumsum over the one-hot ids), or ``E * C`` where the rank
    reaches C (dropped). Returns (slot (G, N/G * K), keep (G, N/G * K)
    bool, C).

    ``over_data``: the N rows are this rank's share, in order, of a batch
    of N x data rows split over the data axes, and the slots are that
    batch's: G and C come from the global N. Where the data size divides G,
    the rank holds G / data whole groups; where G divides the data size,
    each group spans data / G ranks, and a pair's rank counts the group's
    pairs on the lower ranks too (one all-reduce of the (data, E) table of
    each rank's pairs an expert). Returns this rank's rows of the table."""
    N, K = top_ids.shape
    E = moe.num_experts
    D = SU.data_size() if over_data else 1
    G = moe.exec_groups
    while (N * D) % G:
        G //= 2
    G = max(G, 1)
    C = max(1, int(cf * (N * D // G) * K / E + 0.999))
    if G % D and D % G:
        raise ValueError(f"capacity_slots: {G} expert groups neither divide nor are divided "
                         f"by the {D} data ranks")
    G_l = max(G // D, 1)
    ids_g = top_ids.reshape(G_l, N // G_l * K)
    onehot = F.one_hot(ids_g, E)                                # (G, Ng*K, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    if G < D:
        # the group's pairs an expert on the lower ranks that share it
        span, i = D // G, SU.data_index()
        table = torch.zeros((D, E), dtype=torch.int32, device=top_ids.device)
        table[i] = onehot[0].sum(dim=0)
        table = SU.all_sum(table, SU.DATA_AXES)
        pos_in_e = pos_in_e + table[i - i % span:i].sum(dim=0)
    pos = pos_in_e.gather(2, ids_g[..., None])[..., 0]
    keep = pos < C
    return torch.where(keep, ids_g * C + pos, torch.full_like(pos, E * C)), keep, C


def _grouped_capacity(params: dict, xf: torch.Tensor, top_w, top_ids, moe: MoEConfig, act: str,
                      gated: bool, cf: float, over_data: bool = False) -> torch.Tensor:
    """The reference's ``_grouped_capacity`` (l.93-140): the slots of
    ``capacity_slots``; a slot table (slot -> token; an empty slot reads a
    zero row) gathers the (G, E, C, d) dispatch buffer, and each token
    gathers its K expert rows back (a dropped pair reads the zero row,
    weight 0) and adds them, weighted. On a ``model`` axis the expert
    products are this rank's part of d_ff; in a training graph the
    replicated dispatch rows and combine weights that feed them sum their
    gradients over ``model`` (``shard_utils.enter_shards``)."""
    N, d = xf.shape
    E, K = moe.num_experts, moe.top_k
    slot, keep, C = capacity_slots(top_ids, moe, cf, over_data=over_data)
    G, Ng = slot.shape[0], N // slot.shape[0]
    w_g = top_w.reshape(G, Ng * K)
    tok_g = torch.arange(Ng, device=xf.device).repeat_interleave(K)[None].expand(G, Ng * K)
    # the slot table: kept slots are distinct; the dropped ones all land on
    # column E*C, which is cut off
    idx_tab = torch.full((G, E * C + 1), Ng, dtype=torch.long, device=xf.device)
    idx_tab.scatter_(1, slot, tok_g)
    xg_pad = torch.cat([xf.reshape(G, Ng, d), xf.new_zeros((G, 1, d))], dim=1)
    eb = xg_pad.gather(1, idx_tab[:, :E * C, None].expand(G, E * C, d)).reshape(G, E, C, d)
    eo = _expert_ffn(params, SU.enter_shards(eb), act, gated).reshape(G, E * C, d)
    eo = torch.cat([eo, eo.new_zeros((G, 1, d))], dim=1)
    gathered = eo.gather(1, slot[..., None].expand(G, Ng * K, d)).reshape(G, Ng, K, d)
    w_nk = SU.enter_shards((w_g * keep).to(xf.dtype).reshape(G, Ng, K))
    return (gathered * w_nk[..., None]).sum(dim=2).reshape(N, d)


def moe_apply(
    params: dict,
    x: torch.Tensor,                    # (B, S, d)
    moe: MoEConfig,
    act: str,
    gated: bool,
    *,
    mode: str = "infer",
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (output (B, S, d), aux losses, or None without ``with_aux``).
    ``mode``: ``"infer"`` the dropless dispatch; ``"train"`` and
    ``"infer_grouped"`` the grouped capacity at ``capacity_factor`` and
    ``infer_capacity_factor``. ``"train"`` on a mesh with data axes takes
    ``x`` as this rank's rows of the global batch: its capacity slots and
    aux losses are the global batch's (``capacity_slots(over_data=True)``),
    as the reference's GSPMD computes the unsharded function."""
    if mode not in MODES:
        raise ValueError(f"moe_apply: unknown mode {mode!r}; pick one of {MODES}")
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    over_data = mode == "train" and SU.data_axis() is not None
    top_w, top_ids, aux = _router(params, xf, moe, with_aux, over_data)
    if mode == "infer":
        y = _dropless(params, xf, top_w, top_ids, moe, act, gated)
    else:
        cf = moe.capacity_factor if mode == "train" else moe.infer_capacity_factor
        y = _grouped_capacity(params, xf, top_w, top_ids, moe, act, gated, cf, over_data)
    if "shared" in params:
        gate = torch.sigmoid(xf.float() @ params["w_shared_gate"].float()).to(x.dtype)
        y = y + mlp_apply(params["shared"], SU.enter_shards(xf), act, gated) * SU.enter_shards(gate)
    return y.reshape(B, S, d), aux
