"""Counted costs of the port's GEMMs, kernels, layers and model calls.

The counterpart of three reference pieces: ``analysis/hlo_costs.py`` (FLOPs
from the compiled HLO, trip-count corrected), ``analysis/report.py::
model_flops_per_step`` and ``launch/dryrun.py::_analytic_traffic``. The
port has no compiled artifact to parse, so it counts from the config and
the shapes by one rule: each input byte read once, each output byte written
once, and data-dependent work (visible attention pairs, experts hit) at
what the inputs need. A count (a ``roofline.RooflineReport``) reads the
same work whatever implements it (the hand kernel, its plain twin or a
library call), so its bound is theirs too.

FLOPs count 2 a multiply-add of the matrix products (weights and
attention); elementwise work, norms, RoPE and the SSM scan are left out, as
the reference's ``hlo_costs`` counts dots only. ``count_flops`` runs a call
under ``torch.utils.flop_counter.FlopCounterMode``: its ``mm`` count is a
model call's weight GEMMs and unembedding on the CPU, the cross-check that
``hlo_costs.total_costs`` is in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.roofline import RooflineReport, dtype_name
from repro_torch.config.base import AttentionKind, BlockKind, ModelConfig, SSMConfig

_ITEM = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def itemsize(dtype) -> int:
    return _ITEM[str(dtype).replace("torch.", "")]


def total(costs, name: str) -> RooflineReport:
    """The sum of ``costs`` under ``name``."""
    out = None
    for c in costs:
        out = c if out is None else out + c
    return out.named(name)


# ------------------------------------------------------------- the kernels
def flash_decode(B: int, KV: int, R: int, hd: int, S: int, dtype, *, live: Optional[int] = None,
                 visible: Optional[int] = None, merge: bool = False, pages: int = 0,
                 bound: bool = False) -> RooflineReport:
    """Kernels #1 and #4 (``kernels/flash_decode.py``): R = rep * T query
    rows per (batch, kv head) over a cache of S slots a batch row.

    Reads q, the K and V rows of the ``live`` slots the rows see (default
    every slot, B * S), kv_pos (B, S) and q_pos (B, R) int32, the page
    table (B, ``pages``) int32 when paged and the (B,) bound when given;
    writes the partials (acc, m, l) float32, or with ``merge`` reads the
    staged tree's partials and writes the normalised (B, KV, R, hd) float32.
    ``visible`` is the count of (batch, row, slot) pairs a row sees (one kv
    head's; default every row sees every live slot); each costs 4 * hd
    operations (Q.K and P.V) a kv head."""
    elt = itemsize(dtype)
    live = B * S if live is None else live
    visible = R * live if visible is None else visible
    rows = B * KV * R
    nbytes = rows * hd * elt + 2 * live * KV * hd * elt + 4 * (B * S + B * R)
    nbytes += 4 * B * pages + (4 * B if bound else 0)
    nbytes += rows * (2 * hd + 2) * 4 if merge else rows * (hd + 2) * 4
    return RooflineReport.of("flash_decode_paged" if pages else "flash_decode", 4 * hd * KV * visible,
                   nbytes, dtype)


def tree_attention(B: int, KV: int, R: int, T: int, hd: int, dtype, *, pairs: Optional[int] = None,
                   carried: int = 0, carried_pairs: Optional[int] = None) -> RooflineReport:
    """Kernel #2 (``kernels/tree_attention.py``): the R = rep * T rows'
    partials over the T staged rows under the (B, T, T) bool ancestor mask,
    and over ``carried`` rows a batch under a (B, T, carried) bool mask.
    ``pairs`` / ``carried_pairs`` are the masks' true entries (default
    every entry); each pair costs 4 * hd operations for each of the rep
    rows of a kv head."""
    elt = itemsize(dtype)
    rep = R // T
    pairs = B * T * T if pairs is None else pairs
    carried_pairs = B * T * carried if carried_pairs is None else carried_pairs
    rows = B * KV * R
    nbytes = (rows * hd * elt + 2 * B * KV * (T + carried) * hd * elt + B * T * (T + carried)
              + rows * (hd + 2) * 4)
    return RooflineReport.of("tree_attention", 4 * hd * KV * rep * (pairs + carried_pairs), nbytes, dtype)


def int8_matmul(M: int, K: int, N: int) -> RooflineReport:
    """Kernel #3: int8 (M, K) x (K, N) with float32 row (M, 1) and column
    (1, N) scales into (M, N) float32."""
    return RooflineReport.of("int8_matmul", 2 * M * N * K, M * K + K * N + 4 * M + 4 * N + 4 * M * N, "int8")


def moe_grouped(N: int, K: int, d: int, F: int, E: int, hit: int, dtype,
                gated: bool = True) -> RooflineReport:
    """One MoE layer's expert products (``kernels/moe_grouped.py``, two
    launches): the N * K routed rows (N*K, d) in, the experts ``hit`` (the
    ones with a row) read once, the (E + 1,) int32 offsets, (N*K, d) out."""
    item = itemsize(dtype)
    nmat = 3 if gated else 2
    return RooflineReport.of("moe_grouped", 2 * nmat * N * K * d * F,
                   2 * N * K * d * item + nmat * hit * d * F * item + (E + 1) * 4, dtype)


def set_cond() -> RooflineReport:
    """The IF node's predicate kernel: one byte read."""
    return RooflineReport.of("set_cond", 0, 1, "float32")


# --------------------------------------------------------------- the GEMMs
def gemm(name: str, M: int, K: int, N: int, dtype, *, quantize: Optional[str] = None,
         prequantized: bool = False) -> RooflineReport:
    """(M, K) @ (K, N) as ``models/layers.py::_mm`` runs it: x and the
    weight read once, (M, N) written, all in ``dtype``. ``quantize="int8"``
    is its W8A8 route: the operations at the int8 peak, the weight read as
    stored (``prequantized``, a draft bank's int8 level: int8 with its (1,
    N) float32 scale)."""
    elt = itemsize(dtype)
    if quantize is None:
        return RooflineReport.of(name, 2 * M * K * N, (M * K + K * N + M * N) * elt, dtype)
    if quantize != "int8":
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    w_bytes = K * N + 4 * N if prequantized else K * N * elt
    return RooflineReport.of(name, 2 * M * K * N, M * K * elt + w_bytes + M * N * elt, "int8")


def _ssm(cfg: ModelConfig) -> SSMConfig:
    return cfg.ssm or SSMConfig()


def layer_gemms(cfg: ModelConfig, layer: int, M: int, *, dtype=None, quantize: Optional[str] = None,
                prequantized: bool = False, experts_hit: Optional[int] = None) -> List[RooflineReport]:
    """Every weight GEMM of layer ``layer`` over M token rows, in the
    order the layer runs them: q, k, v, o (attention) or the Mamba-2 in
    projections z, x, B, C, dt and ``out_proj``; then gate, up, down (or up,
    down), through the W8A8 route with ``quantize``; or, on an MoE layer,
    the float32 router, the expert products (``moe_grouped``: the experts
    ``experts_hit``, default min(E, M * top_k)) and the shared experts with
    their gate."""
    dt = dtype_name(dtype or cfg.dtype)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    out: List[RooflineReport] = []
    if cfg.block_kind(layer) is BlockKind.ATTENTION:
        out += [gemm("q", M, d, H * hd, dt), gemm("k", M, d, KV * hd, dt),
                gemm("v", M, d, KV * hd, dt), gemm("o", M, H * hd, d, dt)]
    else:
        s = _ssm(cfg)
        din, nh, gds = s.d_inner(d), s.num_heads(d), s.ngroups * s.d_state
        out += [gemm("z", M, d, din, dt), gemm("x", M, d, din, dt), gemm("B", M, d, gds, dt),
                gemm("C", M, d, gds, dt), gemm("dt", M, d, nh, dt),
                gemm("out_proj", M, din, d, dt)]
    if not cfg.has_mlp(layer):
        return out
    names = ("gate", "up", "down") if cfg.mlp_gated else ("up", "down")
    if cfg.is_moe_layer(layer):
        m = cfg.moe
        hit = min(m.num_experts, M * m.top_k) if experts_hit is None else experts_hit
        out.append(gemm("router", M, d, m.num_experts, "float32"))
        out.append(moe_grouped(M, m.top_k, d, m.d_ff_expert, m.num_experts, hit, dt,
                               cfg.mlp_gated).named("experts"))
        if m.num_shared_experts:
            f_sh = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
            for n in names:
                K, N = (f_sh, d) if n == "down" else (d, f_sh)
                out.append(gemm(f"shared_{n}", M, K, N, dt))
            out.append(gemm("shared_gate", M, d, 1, dt))
        return out
    ff = cfg.d_ff
    for n in names:
        K, N = (ff, d) if n == "down" else (d, ff)
        out.append(gemm(n, M, K, N, dt, quantize=quantize, prequantized=prequantized))
    return out


def unembed(cfg: ModelConfig, M: int, *, dtype=None) -> RooflineReport:
    """The head over M rows: x (M, d) and the head (d, V) read once in the
    model's type, the float32 logits (M, V) written once, the products at
    that type's peak (V the padded vocabulary; a codebook stack has
    ``num_codebooks`` heads). ``models/layers.py::unembed`` upcasts both
    operands to float32 on every call; that traffic is the implementation's,
    not the function's, and is left out (``chip_smoke.py`` phase 16 times
    the upcast apart)."""
    dt = dtype_name(dtype or cfg.dtype)
    elt = itemsize(dt)
    d, V = cfg.d_model, cfg.padded_vocab
    heads = max(cfg.num_codebooks, 1)
    w = heads * d * V
    return RooflineReport.of("unembed", 2 * M * w, (M * d + w) * elt + M * heads * V * 4, dt)


# ---------------------------------------------------------- parameter counts
def param_count(cfg: ModelConfig) -> int:
    """The reference's analytic parameter count (``config/base.py::
    param_count``: the unpadded vocabulary), the N of its MODEL_FLOPS."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()
    total_ = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        total_ += cfg.vocab_size * d
    if cfg.num_codebooks:
        total_ += 2 * (cfg.num_codebooks - 1) * cfg.vocab_size * d
    total_ += d
    for i in range(cfg.num_layers):
        total_ += d
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            total_ += 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
        else:
            s = _ssm(cfg)
            din, nh = s.d_inner(d), s.num_heads(d)
            total_ += d * (2 * din + 2 * s.ngroups * s.d_state + nh)
            total_ += s.d_conv * (din + 2 * s.ngroups * s.d_state)
            total_ += 3 * nh + din + din * d
        if cfg.has_mlp(i):
            total_ += d
            nmat = 3 if cfg.mlp_gated else 2
            if cfg.is_moe_layer(i):
                m = cfg.moe
                total_ += d * m.num_experts + m.num_experts * nmat * d * m.d_ff_expert
                if m.num_shared_experts:
                    total_ += nmat * d * (m.d_ff_shared or m.d_ff_expert * m.num_shared_experts) + d
            else:
                total_ += nmat * d * cfg.d_ff
    return total_


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token touches (MoE: its top-k and the shared experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    nmat = 3 if cfg.mlp_gated else 2
    return param_count(cfg) - n_moe * (m.num_experts - m.top_k) * nmat * cfg.d_model * m.d_ff_expert


def layer_param_bytes(cfg: ModelConfig, layer: int, *, dtype=None,
                      experts: Optional[int] = None) -> int:
    """Bytes of layer ``layer``'s leaves as ``models/model.py::init_params``
    allocates them (the MoE router and a Mamba-2 block's ``A_log``, ``D``
    and ``dt_bias`` float32 whatever the type); ``experts`` counts only
    that many experts' products (the ones a call reads)."""
    elt = itemsize(dtype or cfg.dtype)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    n = d * elt                                             # norm1
    if cfg.block_kind(layer) is BlockKind.ATTENTION:
        n += (2 * d * H * hd + 2 * d * KV * hd) * elt
    else:
        s = _ssm(cfg)
        din, nh, gds = s.d_inner(d), s.num_heads(d), s.ngroups * s.d_state
        n += (d * (2 * din + 2 * gds + nh) + s.d_conv * (din + 2 * gds) + din + din * d) * elt
        n += 3 * nh * 4
    if not cfg.has_mlp(layer):
        return n
    n += d * elt                                            # norm2
    nmat = 3 if cfg.mlp_gated else 2
    if cfg.is_moe_layer(layer):
        m = cfg.moe
        E = m.num_experts if experts is None else experts
        n += d * m.num_experts * 4 + E * nmat * d * m.d_ff_expert * elt
        if m.num_shared_experts:
            f_sh = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
            n += (nmat * d * f_sh + d) * elt
        return n
    return n + nmat * d * cfg.d_ff * elt


def param_bytes(cfg: ModelConfig, *, dtype=None) -> int:
    """Bytes of every leaf ``init_params(cfg)`` allocates (the padded
    vocabulary; a codebook stack's ``num_codebooks`` tables and heads)."""
    elt = itemsize(dtype or cfg.dtype)
    tables = max(cfg.num_codebooks, 1) * cfg.padded_vocab * cfg.d_model
    n = (tables * (1 if cfg.tie_embeddings else 2) + cfg.d_model) * elt
    return n + sum(layer_param_bytes(cfg, i, dtype=dtype) for i in range(cfg.num_layers))


def model_flops_per_step(cfg, kind: str, seq: int, batch: int, draft_t: int = 8) -> float:
    """The reference's MODEL_FLOPS (``analysis/report.py``): 6 N D for a
    train step (N the active parameters), 2 N tokens for a prefill, 2 N B
    T for a decode of ``draft_t`` staged tokens. ``cfg`` is a config or
    an arch id."""
    if isinstance(cfg, str):
        from repro_torch.config import get_config

        cfg = get_config(cfg)
    n_active = active_param_count(cfg)
    tokens = batch * seq
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * batch * draft_t


def analytic_traffic(kind: str, params_local: float, cache_local: float, act_local: float) -> float:
    """Least HBM traffic of one step (the reference's ``launch/dryrun.py::
    _analytic_traffic``): decode and prefill read the weights once and the
    cache once (read, or written by the prefill) plus the activation
    stream; a train step reads the weights twice (forward and the remat
    recompute), writes the gradients once and reads and writes float32
    moments (8x a 2-byte parameter), the activations three times."""
    if kind in ("decode", "prefill"):
        return params_local + cache_local + act_local
    return params_local * (2 + 1 + 8) + act_local * 3


# ---------------------------------------------------------- the model calls
def _window(cfg: ModelConfig, layer: int, S: int) -> int:
    """Cached slots a row of layer ``layer`` can see of S."""
    if cfg.attention_kind(layer) is AttentionKind.SLIDING:
        return min(S, cfg.sliding_window)
    return S


def _routed(cfg: ModelConfig, M: int, experts_hit: Optional[int]) -> int:
    return min(cfg.moe.num_experts, M * cfg.moe.top_k) if experts_hit is None else experts_hit


def decode_step(cfg: ModelConfig, B: int, T: int, S: int, *, dtype=None,
                layers: Optional[List[int]] = None, quantize: Optional[str] = None,
                staged_pairs: Optional[int] = None, experts_hit: Optional[int] = None,
                model: int = 1) -> RooflineReport:
    """One ``models/model.py::decode_step``: T staged rows for each of B
    slots over S committed slots each, through ``layers`` (default every
    layer; a slice-exec draft runs a subset). Reads each layer's weights
    once (an MoE layer's router and the experts hit; ``quantize="int8"``
    quantizes the float weights per call, so they are read as stored), the
    K/V of the slots a row sees (a sliding layer's window), a Mamba-2
    layer's state; writes
    the staged K/V (or per-step states) and the float32 logits. Each row
    sees every cached slot and ``staged_pairs`` (B, T, T) mask entries
    (default a chain's T (T + 1) / 2 a slot). ``model > 1``: the whole
    call's work (not one rank's), and the collective bytes one rank of a
    ``model`` axis of that size sends (``decode_collectives``), the
    roofline's collective term."""
    dt = dtype_name(dtype or cfg.dtype)
    elt = itemsize(dt)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    M = B * T
    staged_pairs = B * T * (T + 1) // 2 if staged_pairs is None else staged_pairs
    heads = max(cfg.num_codebooks, 1)
    parts = [RooflineReport.of("embed", 0, M * heads * (4 + d * elt), dt)]
    run = range(cfg.num_layers) if layers is None else layers
    for i in run:
        gem = layer_gemms(cfg, i, M, dtype=dt, quantize=quantize, experts_hit=experts_hit)
        hit = _routed(cfg, M, experts_hit) if cfg.is_moe_layer(i) else None
        # the GEMMs' operations at their types; the weights' bytes counted once
        layer = RooflineReport(f"layer {i}", sum(g.flops for g in gem), 0.0, dtype=dt,
                               t_ops=sum(g.t_compute for g in gem))
        nbytes = layer_param_bytes(cfg, i, dtype=dt, experts=hit)
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            S_l = _window(cfg, i, S)
            att = 4 * hd * H * (T * B * S_l + staged_pairs)
            layer = layer + RooflineReport.of("attention", att, 0, dt)
            nbytes += 2 * B * S_l * KV * hd * elt + 2 * M * KV * hd * elt
        else:
            s = _ssm(cfg)
            din, nh, gds = s.d_inner(d), s.num_heads(d), s.ngroups * s.d_state
            state = nh * s.head_dim * s.d_state * 4 + (s.d_conv - 1) * (din + 2 * gds) * elt
            nbytes += B * state + M * state
        parts.append(dataclasses.replace(layer, bytes_hbm=nbytes + 2 * M * d * elt))
    parts.append(unembed(cfg, M, dtype=dt))
    out = total(parts, f"decode_step B={B} T={T} S={S}")
    if model > 1:
        out = dataclasses.replace(out, coll_bytes=decode_collectives(
            cfg, B, T, S, model=model, dtype=dt, layers=layers))
    return out


def ring_bytes(payload: float, n: int) -> float:
    """Bytes one rank sends in a ring all-reduce of ``payload`` bytes over
    ``n`` ranks: 2 (n - 1) / n of the payload (0 on one rank)."""
    return 2.0 * (n - 1) / n * payload


def decode_collectives(cfg: ModelConfig, B: int, T: int, S: int, *, model: int = 1,
                       dtype=None, paged: bool = False,
                       layers: Optional[List[int]] = None) -> Dict[str, float]:
    """Counted collective bytes one rank sends in one ``decode_step`` of B
    local slots and T rows a slot on a ``model`` axis of ``model`` ranks,
    as the port's tensor-parallel model runs it (``models/shard_utils``:
    every collective an all-reduce, each counted as its payload times the
    ring factor ``ring_bytes``):

      embed     the vocab-sharded lookup's sum, (M, d) in the model's type;
      attention ``kv``/``q``: the ``wo`` sum, (M, d); ``q`` also gathers the
                queries (M, H, hd) as a sum into zeros; ``q``/``none`` over
                a dense cache combine the sequence slices' partials: m and
                l (B, KV, rep T) and acc (B, KV, rep T, hd), float32;
      mlp       the ``w_down`` (or experts') sum, (M, d);
      mamba     where d_inner is sharded: the norm's (M, 1) float32 sum and
                the ``out_proj`` sum, (M, d);
      logits    the vocab columns' gather, (M, heads, V) float32.

    Returns {"all-reduce": bytes} (0 on one rank)."""
    from repro_torch.launch.sharding import attention_policy   # it imports the model code

    dt = dtype_name(dtype or cfg.dtype)
    elt = itemsize(dt)
    n = model
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    M = B * T
    heads = max(cfg.num_codebooks, 1)
    pol = attention_policy(cfg, n)
    payloads = [M * d * elt, M * heads * cfg.padded_vocab * 4]
    for i in (range(cfg.num_layers) if layers is None else layers):
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            if pol in ("kv", "q"):
                payloads.append(M * d * elt)
            if pol == "q":
                payloads.append(M * H * hd * elt)
            if pol != "kv" and not paged:
                R = (H // KV) * T
                payloads += [B * KV * R * 4, B * KV * R * 4, B * KV * R * hd * 4]
        else:
            s = _ssm(cfg)
            if s.num_heads(d) % n == 0:
                payloads += [M * 4, M * d * elt]
        if cfg.has_mlp(i):
            payloads.append(M * d * elt)
    return {"all-reduce": sum(ring_bytes(p, n) for p in payloads)}


def train_collective_terms(cfg: ModelConfig, B: int, S: int, *, data: int = 1, model: int = 1,
                           pod: int = 1, min_dim: int = 512, remat: bool = True,
                           loss_mask: bool = False) -> Dict[str, float]:
    """Counted bytes one rank sends in one ``training.make_train_step`` of
    a global batch of B rows of S tokens on a (pod, data, model) mesh, as
    the port's sharded step runs it (``models/shard_utils``: every
    collective an all-reduce, each counted as ``ring_bytes`` of its
    payload over its group), by term:

      fsdp      each layer-stack leaf cut over ``data`` (``sharding.
                train_specs`` at ``min_dim``) gathered whole at its layer's
                entry, again in the backward's recompute (``remat``), and
                its gradient summed before the cut (a reduce-scatter);
      tp        over ``model``: forward the embedding's and each row-parallel
                sum, the ``q`` policy's query gather, a sharded Mamba-2
                norm's sum of squares and the logits' gather (again in the
                recompute, the logits and embedding aside); backward the
                sum of each replicated input's gradient (``enter_shards``)
                and the norm's;
      grad      each leaf's gradient summed over the data axes it is
                replicated on;
      step      the MoE capacity table and aux means (again in the
                recompute), the loss's target count (``loss_mask``) and
                global ce;
      norm      the gradient norm's sums, one a set of axes the leaves are
                sharded on.

    Activations and gradients in the model's type; the logits, the norm's
    sums and the MoE means float32. Returns {term: bytes}."""
    import math

    from repro_torch.launch import sharding as SH   # it imports the model code
    from repro_torch.launch.mesh import Mesh

    axes = tuple(a for a, n in (("pod", pod), ("data", data), ("model", model)) if a != "pod" or n > 1)
    sizes = {"pod": pod, "data": data, "model": model}
    mesh = Mesh(tuple(sizes[a] for a in axes), axes, shape_only=True)
    dp = pod * data
    elt = itemsize(cfg.dtype)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    Bl = B // dp
    M = Bl * S
    rec = 2 if remat else 1
    tp = lambda p: ring_bytes(p, model)            # noqa: E731
    over = lambda p, n: ring_bytes(p, n)           # noqa: E731
    out = {"fsdp": 0.0, "tp": 0.0, "grad": 0.0, "step": 0.0, "norm": 0.0}

    # the embedding's sum and the head (outside the recompute)
    heads = max(cfg.num_codebooks, 1)
    out["tp"] += tp(M * d * elt) + tp(M * heads * cfg.padded_vocab * 4) + tp(M * d * elt)
    pol = SH.attention_policy(cfg, model)
    for i in range(cfg.num_layers):
        fwd = bwd = 0.0
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            if pol in ("kv", "q"):
                fwd += M * d * elt                  # wo's sum
                bwd += M * d * elt                  # x's gradient
            if pol == "q":
                fwd += M * H * hd * elt             # the query gather
                bwd += 2 * M * KV * hd * elt        # K's and V's gradients
        else:
            s = _ssm(cfg)
            nh = s.num_heads(d)
            if nh % model == 0:
                gds = s.ngroups * s.d_state
                fwd += M * 4 + M * d * elt          # the norm's sum of squares, out_proj's
                bwd += (M * 4 + M * d * elt + M * nh * elt + 3 * nh * 4 + 2 * M * gds * elt)
        if cfg.has_mlp(i):
            fwd += M * d * elt
            if cfg.is_moe_layer(i):
                moe = cfg.moe
                E, K = moe.num_experts, moe.top_k
                G = moe.exec_groups
                while (B * S) % G:
                    G //= 2
                G = max(G, 1)
                C = max(1, int(moe.capacity_factor * (B * S // G) * K / E + 0.999))
                G_l = max(G // dp, 1)
                out["step"] += rec * over((2 * E + 1) * 4, dp)
                if G < dp:
                    out["step"] += rec * over(dp * E * 4, dp)
                bwd += G_l * E * C * d * elt + M * K * elt     # dispatch rows, combine weights
                if moe.num_shared_experts:
                    bwd += M * d * elt + M * elt                # shared input, its gate
            else:
                bwd += M * d * elt
        out["tp"] += rec * tp(fwd) + tp(bwd)

    # the leaves: FSDP gathers and reduce-scatters, gradient sums, the norm
    specs = SH.train_specs(cfg, mesh, min_dim=min_dim)
    full = SH.full_shapes(cfg)
    groups: Dict[Tuple[str, ...], int] = {}
    leaves = 0

    def leaf(spec, t):
        nonlocal leaves
        leaves += 1
        local = math.prod(SH.local_shape(t.shape, spec, mesh)) * t.element_size()
        # a cut over a data axis of one is no cut (``sharding.placed_specs``)
        ax = tuple(a for a in SH.spec_axes(spec) if a != "data" or data > 1)
        if "data" in ax:
            out["fsdp"] += (rec + 1) * over(local * data, data)
        rest = [a for a in ("pod", "data") if a in axes and a not in ax]
        out["grad"] += over(local, math.prod(sizes[a] for a in rest))
        if ax:
            groups[ax] = math.prod(sizes[a] for a in ax)

    SH.map_specs(leaf, specs, full)
    out["norm"] = sum(over(leaves * 4, n) for n in groups.values())
    out["step"] += over(4, dp) * (2 if loss_mask else 1)
    return out


def train_collectives(cfg: ModelConfig, B: int, S: int, **kw) -> Dict[str, float]:
    """``train_collective_terms`` summed: {"all-reduce": bytes} (0 on one
    device)."""
    return {"all-reduce": sum(train_collective_terms(cfg, B, S, **kw).values())}


def prefill(cfg: ModelConfig, B: int, S: int, *, dtype=None) -> RooflineReport:
    """One ``models/model.py::prefill`` of S tokens for each of B rows:
    every weight read once, the causal attention's S (S + 1) / 2 pairs a
    row (a sliding layer's window), the cache written once, the logits of
    the last position."""
    dt = dtype_name(dtype or cfg.dtype)
    elt = itemsize(dt)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    M = B * S
    heads = max(cfg.num_codebooks, 1)
    parts = [RooflineReport.of("embed", 0, M * heads * (4 + d * elt), dt)]
    for i in range(cfg.num_layers):
        gem = layer_gemms(cfg, i, M, dtype=dt)
        hit = _routed(cfg, M, None) if cfg.is_moe_layer(i) else None
        layer = RooflineReport(f"layer {i}", sum(g.flops for g in gem), 0.0, dtype=dt,
                               t_ops=sum(g.t_compute for g in gem))
        nbytes = layer_param_bytes(cfg, i, dtype=dt, experts=hit)
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            w = _window(cfg, i, S)
            pairs = sum(min(t + 1, w) for t in range(S))
            layer = layer + RooflineReport.of("attention", 4 * hd * H * B * pairs, 0, dt)
            nbytes += 2 * M * KV * hd * elt
        else:
            s = _ssm(cfg)
            din, gds = s.d_inner(d), s.ngroups * s.d_state
            nbytes += B * (s.num_heads(d) * s.head_dim * s.d_state * 4
                           + (s.d_conv - 1) * (din + 2 * gds) * elt)
        parts.append(dataclasses.replace(layer, bytes_hbm=nbytes + 2 * M * d * elt))
    parts.append(unembed(cfg, B, dtype=dt))
    return total(parts, f"prefill B={B} S={S}")


def forward_train(cfg: ModelConfig, B: int, S: int, *, dtype=None) -> RooflineReport:
    """One ``models/model.py::forward_train`` (the forward alone) of B x S
    tokens: every weight read once (MoE: all experts, the grouped capacity
    runs each), causal attention, the float32 logits of every position
    written. A train step's backward is about twice its operations
    (``model_flops_per_step``: 6 N D against the forward's 2 N D)."""
    dt = dtype_name(dtype or cfg.dtype)
    elt = itemsize(dt)
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim()
    M = B * S
    heads = max(cfg.num_codebooks, 1)
    parts = [RooflineReport.of("embed", 0, M * heads * (4 + d * elt), dt)]
    for i in range(cfg.num_layers):
        gem = layer_gemms(cfg, i, M, dtype=dt)
        layer = RooflineReport(f"layer {i}", sum(g.flops for g in gem), 0.0, dtype=dt,
                               t_ops=sum(g.t_compute for g in gem))
        if cfg.block_kind(i) is BlockKind.ATTENTION:
            w = _window(cfg, i, S)
            pairs = sum(min(t + 1, w) for t in range(S))
            layer = layer + RooflineReport.of("attention", 4 * hd * H * B * pairs, 0, dt)
        nbytes = layer_param_bytes(cfg, i, dtype=dt)
        parts.append(dataclasses.replace(layer, bytes_hbm=nbytes + 2 * M * d * elt))
    parts.append(unembed(cfg, M, dtype=dt))
    return total(parts, f"forward_train B={B} S={S}")


# ---------------------------------------------------------------- counting
def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    import torch

    n = 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
    return n


def count_flops(fn, *args, **kwargs) -> Tuple[object, Dict[str, int]]:
    """Run ``fn(*args, **kwargs)`` under ``FlopCounterMode``: returns its
    result and the FLOPs it counted, by aten op (``"mm"``, ``"bmm"``, ...)
    and in all (``"total"``). Ops it does not know (a hand kernel launched
    through ctypes among them) count nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    with mode:
        out = fn(*args, **kwargs)
    by_op = {str(op).split(".")[-1]: int(n) for op, n in mode.get_flop_counts()["Global"].items()}
    by_op["total"] = int(mode.get_total_flops())
    return out, by_op
