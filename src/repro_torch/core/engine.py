"""CAS-Spec engines: the single-sequence ``SpecEngine`` (DSIA draft
execution + tree verification) and the batched server's round functions
(``chain_draft_scan``, ``tree_draft_scan``, the cascade's
``cascade_rescore`` and ``cascade_rescore_verify``, ``verify_accept_commit``,
``tree_verify_accept_commit`` and its host-walk twin for the split rounds,
their ``*_sampled`` twins, and the single-dispatch rounds ``chain_round`` /
``tree_round``).

Execution modes for layer-gated drafts:
  - "slice": run only the kept layers (fewer FLOPs — the honest speed of a
    layer-sparse draft; requires a homogeneous layer stack).
  - "mask": run every layer with the gate vector (gated-off layers add
    nothing to the residual stream).

Cache discipline: drafts are STAGE-ONLY (never committed); only the full
target model's verification staged KV is committed, so the cache is always
exact — the losslessness invariant (see models.model).

The batched functions are the reference's ``core/engine.py`` functions of
the same names. The reference's ``lax.scan`` over steps is a Python loop
here (PyTorch runs eagerly), and its drop-mode scatters are one-hot
``torch.where`` updates (an index of N matches no column), masked
scatters that write a dropped row's anchor entry back (``_set_at``; the
carried KV buffers: ``models.model._scatter_rows``). A layer-sparse draft
runs either through the gate vector (``gates``, mask exec) or, on a
homogeneous stack, through ``layer_ids`` (slice exec): the kept layers
only, the same numbers. ``draft_kv`` picks how draft steps see each other:
``"recompute"`` re-decodes the whole padded block every step; ``"carry"``
decodes the block once, carries its staged KV and decodes only the
appended tokens against [cache ++ carried rows] (the two are
token-identical; the last step's decode, whose output no later step reads,
is skipped).

``chain_round`` and ``tree_round`` are the reference's single-dispatch
rounds: PLD over a carried context buffer, the Eq. 5 budgets from
the carried Eq. 4 state, the draft, the verify, the accepted-path walk,
the cache and context commit and the EMA update, with fixed shapes and no
host read. Each is the composition of three segments, ``*_prologue``,
``*_draft`` and ``*_tail``: the reference skips the draft at run time
(``lax.cond``) where no budget needs it, and the server captures the three
as segment graphs with the draft behind a conditional node
(``kernels/graph_cond.py``). The draft writes its results in place into
the prologue's tensors, so the tail reads the same tensors whether or not
it ran. Run eagerly here, the draft runs masked by the budgets: where none
needs it, it writes nothing. ``prefill_chunk_stage`` is the reference's
chunked prefill, which the server runs ahead of the prologue behind a
conditional node of its own.

Sampled serving (the reference's ``sampling=``): the verifies accept by
speculative sampling against the warped target distribution
(``core/verify.py``) on uniforms split from per-slot threefry keys
(``core/prng.py``) with tensor ops, so the keys are carried device state
and a sampled round adds no dispatch and no host read; ``temp <= 0``
slots reduce to the greedy rule token for token.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core import verify as verify_lib
from repro_torch.core.acceptance import AcceptanceTracker, ema_update
from repro_torch.core.dsia import DraftSpec
from repro_torch.core.latency import (
    CostTracker,
    best_chain_length_batched,
    best_tree_expansions_batched,
)
from repro_torch.core.pld import PromptLookup, propose_device
from repro_torch.core.tree import DraftTree, bucket_for, tree_seed_device
from repro_torch.models import model as M
from repro_torch.models import shard_utils as SU


def fake_quant_int8(params: dict, cfg: Optional[ModelConfig] = None) -> dict:
    """Per-output-channel symmetric int8 weight fake-quantization (QSpec sim),
    with the reference's numerics (scale over every axis but the last). On
    a mesh (``cfg`` given) a leaf sharded on an axis the scale reduces over
    takes the MAX over those ranks, so every shard holds the unsharded
    leaf's values."""

    def q(w, spec=()):
        if not isinstance(w, torch.Tensor) or w.dtype not in (torch.float32, torch.bfloat16):
            return w
        if w.ndim < 2:
            return w
        w32 = w.float()
        amax = w32.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
        axes = tuple(a for e in tuple(spec)[: w.ndim - 1] if e is not None
                     for a in ((e,) if isinstance(e, str) else e))
        if axes:
            amax = SU.all_max(amax, axes)
        scale = torch.clamp_min(amax / 127.0, 1e-8)
        return (torch.round(w32 / scale).clamp(-127, 127) * scale).to(w.dtype)

    mesh = SU.active_mesh()
    if mesh is None or cfg is None:
        return M.tree_map(q, params)
    from repro_torch.launch import sharding as SH
    return SH.map_specs(lambda spec, w: q(w, spec), SH.param_specs(cfg, mesh), params)


def check_text_stack(cfg: ModelConfig, who: str) -> None:
    """Refuse a codebook stack (musicgen) on a speculative serving path:
    its tokens are (nc,) codes a position, not scalars, so there is nothing
    for prompt lookup, the acceptance walk or the committed stream to
    compare. The reference's paths fail on it by accident (a ``TypeError``
    in its engine, a broadcast error in its server); the port serves such a
    stack at the model level only (``models.model.prefill``,
    ``decode_step``, ``commit_cache``)."""
    if cfg.num_codebooks:
        raise ValueError(
            f"{who}: codebook tokens are not scalar ({cfg.name} has {cfg.num_codebooks} "
            "codebooks); this path serves text stacks — decode a codebook stack with "
            "models.model.decode_step and commit_cache")


class SpecEngine:
    """Single-sequence (B=1) speculative engine over a text stack (a
    codebook stack raises ``ValueError``: ``check_text_stack``). On a stack
    with Mamba-2 blocks it verifies chains only: a branching tree raises
    ``ValueError`` (``check_tree_stack``), where the reference's engine
    would commit a state built from the node's siblings."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        max_len: int = 2048,
        draft_exec: str = "auto",          # auto | slice | mask
        *,
        device="cuda",
    ):
        check_text_stack(cfg, "SpecEngine")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        segs = M.layout(cfg)
        homogeneous = len(segs) == 1 and len(segs[0].unit) == 1
        if draft_exec == "auto":
            draft_exec = "slice" if homogeneous else "mask"
        if draft_exec == "slice" and not homogeneous:
            raise ValueError("slice exec requires a homogeneous layer stack")
        self.draft_exec = draft_exec
        self._recurrent = M.has_mamba(cfg)
        self.pld = PromptLookup()
        self.acceptance = AcceptanceTracker()
        self.costs = CostTracker()
        # name -> (params, gates for mask exec, kept layer ids for slice exec)
        self._variants: Dict[str, Tuple[dict, Optional[np.ndarray], Optional[List[int]]]] = {
            "full": (params, None, None)
        }
        self._spec_by_name: Dict[str, DraftSpec] = {}
        self.cache: Optional[dict] = None
        self.tokens: List[int] = []
        self.pending: Optional[int] = None
        self.last_logits: Optional[torch.Tensor] = None   # last verify's (1, T, V) logits
        self.stats = {"target_calls": 0, "draft_calls": 0, "rounds": 0,
                      "accepted_tokens": 0, "draft_time": 0.0, "verify_time": 0.0,
                      "modeled_draft_cost": 0.0}

    # ------------------------------------------------------------- variants
    def register_draft(self, spec: DraftSpec) -> None:
        if spec.kind == "retrieval" or spec.name in self._variants:
            self.acceptance.set_prior(spec.name, spec.prior_alpha)
            self.costs.set_prior(spec.name, spec.prior_c)
            return
        params = self.params
        gates = spec.gates_array(self.cfg.num_layers)
        if spec.quantize == "int8":
            params = fake_quant_int8(params)
        if self.draft_exec == "slice" and spec.gates is not None:
            # The reference slices the stacked weights once per level and the
            # cache on every draft call with ``a[kept]``. In torch that
            # indexing copies: gigabytes of weights per level and about 1 GB
            # of cache per draft call at vicuna-7b width. The port runs the
            # kept layers over views of the target's own params and cache
            # instead (decode_step(layer_ids=...)): same numbers, shared storage.
            self._variants[spec.name] = (params, None, [int(i) for i in np.flatnonzero(gates > 0)])
        else:
            self._variants[spec.name] = (params, gates, None)
        self.acceptance.set_prior(spec.name, spec.prior_alpha)
        self.costs.set_prior(spec.name, spec.prior_c)
        self._spec_by_name[spec.name] = spec

    # ---------------------------------------------------------------- runtime
    def start(self, prompt: np.ndarray) -> None:
        prompt = np.asarray(prompt, np.int32)
        self.cache = M.init_cache(self.cfg, 1, self.max_len, device=self.device)
        t0 = time.perf_counter()
        last, self.cache = M.prefill(
            self.cfg, self.params, {"tokens": torch.as_tensor(prompt[None], device=self.device)},
            self.cache,
        )
        self.pending = int(last[0].argmax())
        self.costs.observe_target(time.perf_counter() - t0, tokens=max(len(prompt), 1))
        self.tokens = [int(t) for t in prompt]

    @property
    def context(self) -> np.ndarray:
        return np.asarray(self.tokens + [self.pending], np.int32)

    def _run_nodes(self, variant: str, tokens: np.ndarray, rel_pos: np.ndarray, mask: np.ndarray):
        n = len(tokens)
        # the reference pads every call to a tree bucket (one compiled shape
        # per bucket). A Mamba-2 block steps through the staged tokens one at
        # a time, and padding nodes come after the real ones and change none
        # of their logits or states, so a stack with mamba layers runs the
        # real nodes alone
        T = n if self._recurrent else bucket_for(n)
        toks = np.zeros(T, np.int32)
        toks[:n] = tokens
        rel = np.zeros(T, np.int32)
        rel[:n] = rel_pos
        rel[n:] = (rel_pos.max() if n else 0) + 1 + np.arange(T - n)
        m = np.eye(T, dtype=bool)
        m[:n, :n] = mask
        params_v, gates, layer_ids = self._variants[variant]
        spec = self._spec_by_name.get(variant)
        override = None
        if spec is not None and spec.attn_override is not None:
            kind, window, sink = spec.attn_override
            override = {"kind": kind, "window": window, "sink": sink}
        dev = self.device
        qpos = self.cache["pos"] + torch.as_tensor(rel, device=dev)
        logits, staged = M.decode_step(
            self.cfg, params_v, self.cache, torch.as_tensor(toks[None], device=dev),
            gates=gates, tree_mask=torch.as_tensor(m, device=dev), q_pos=qpos,
            attn_override=override, layer_ids=layer_ids,
        )
        return logits, staged, T

    # draft call: logits for a node set under a draft config (stage-only)
    def draft_logits(self, spec_name: str, tokens, rel_pos, mask) -> np.ndarray:
        t0 = time.perf_counter()
        logits, _, _ = self._run_nodes(spec_name, tokens, rel_pos, mask)
        logits = logits[0, : len(tokens)].cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["draft_calls"] += 1
        self.stats["draft_time"] += dt
        spec = self._spec_by_name.get(spec_name)
        self.stats["modeled_draft_cost"] += spec.prior_c if spec else 0.5
        self.costs.observe(spec_name, dt, tokens=len(tokens))
        return logits

    # verification: full model over the tree, then commit the accepted path
    def verify_and_commit(self, tree: DraftTree) -> List[int]:
        n = len(tree)
        if any(tree.parents[i] != i - 1 for i in range(1, n)):
            check_tree_stack(self.cfg, "verifying a branching tree")
        tokens, rel, mask, _ = tree.flatten()
        t0 = time.perf_counter()
        logits, staged, T = self._run_nodes("full", tokens[:n], rel[:n], mask[:n, :n])
        next_argmax = logits[0, :n].argmax(dim=-1).cpu().numpy()
        self.last_logits = logits
        self.stats["verify_time"] += time.perf_counter() - t0
        self.stats["target_calls"] += 1
        self.costs.observe_target(time.perf_counter() - t0, tokens=1)
        path, bonus = verify_lib.greedy_accept_tree(tree, next_argmax)

        # commit: accepted nodes' staged KV, in path order
        path_idx = np.zeros(T, np.int32)
        path_idx[: len(path)] = path
        self.cache = M.commit_cache(self.cfg, self.cache, staged, path_idx, len(path))
        accepted = [tree.tokens[i] for i in path]
        self.tokens.extend(accepted)
        self.pending = int(bonus)
        self.stats["rounds"] += 1
        self.stats["accepted_tokens"] += len(accepted)
        return accepted

    # ------------------------------------------------------------ baselines
    def ar_step(self) -> int:
        """Plain autoregressive: verify a root-only tree (1 token/step)."""
        self.verify_and_commit(DraftTree(self.pending))
        return self.tokens[-1]

    def generate_ar(self, n_tokens: int) -> List[int]:
        out = []
        while len(out) < n_tokens:
            self.ar_step()
            out.append(self.tokens[-1])
        return out[:n_tokens]


# ============================================================ batched rounds
DRAFT_KV_MODES = ("recompute", "carry")


def _check_draft_kv(cfg: ModelConfig, draft_kv: str, who: str) -> None:
    """``draft_kv`` is one of ``DRAFT_KV_MODES``, and ``"carry"`` needs an
    attention-only text stack (MoE layers are attention blocks with an MoE
    MLP): a Mamba-2 block's per-step states are cumulative, so they cannot
    be carried row by row, and codebook tokens are not scalar (the
    reference's ``core/engine.py:87-103``)."""
    if draft_kv not in DRAFT_KV_MODES:
        raise ValueError(f"{who}: unknown draft_kv {draft_kv!r}; pick one of {DRAFT_KV_MODES}")
    if draft_kv == "carry" and (cfg.num_codebooks or M.has_mamba(cfg)):
        raise ValueError(
            f"{who}: draft_kv='carry' requires an attention-only text stack — SSM per-step "
            "states are cumulative (not row-scatterable) and codebook tokens are not scalar; "
            "use draft_kv='recompute'")


def check_tree_stack(cfg: ModelConfig, who: str) -> None:
    """Refuse token trees on a stack that is not an attention-only text
    stack: a Mamba-2 block's decode is one recurrence over the staged tokens
    in order, so a branching tree would give each node a state built from
    its siblings; codebook tokens are not scalar. The reference's batched
    server refuses both in these words (``serving/server.py:402-409``); its
    single-stream engine does not, and then leaves AR."""
    if cfg.num_codebooks or M.has_mamba(cfg):
        raise ValueError(f"{who} requires an attention-only text stack: staged SSM states are "
                         "chain-ordered and cannot follow tree paths")


def chain_draft_scan(
    cfg: ModelConfig,
    steps: int,                       # draft steps to run (<= k)
    params: dict,
    cache: dict,                      # batched committed cache (read-only here)
    pending: torch.Tensor,            # (B,) int32 last verified token per slot
    chains: torch.Tensor,             # (B, k) int32, PLD-prefilled prefix
    have: torch.Tensor,               # (B,) int32 tokens already proposed (PLD)
    limit: torch.Tensor,              # (B,) int32 per-slot adaptive draft cap
    gates=None,                       # (num_layers,) DSIA layer gates (mask exec)
    *,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    quantize: Optional[str] = None,   # "int8": W8A8 MLP matmuls
    attn_override: Optional[dict] = None,    # efficient-attention DSIA
    draft_kv: str = "recompute",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-step neural chain drafting. Step ``j`` writes the draft's argmax
    at position ``j`` into chain position ``j`` only where ``have <= j <
    limit``: PLD tokens are never overwritten and slots past their budget
    stop. ``"recompute"`` re-decodes the (B, k+1) block ``[pending, chain]``
    under a causal mask at every step; ``"carry"`` decodes it once, then
    only the appended token of each step against [cache ++ the carried
    rows 0..j]. Returns (chains, have) with ``have = max(have, min(limit,
    steps))``. ``quantize`` and ``attn_override`` reach every draft decode
    (a cascade level's DSIA execution)."""
    _check_draft_kv(cfg, draft_kv, "chain_draft_scan")
    dsia = dict(gates=gates, layer_ids=layer_ids, quantize=quantize, attn_override=attn_override)
    B, K = chains.shape
    toks = torch.cat([pending[:, None], chains], dim=1).to(torch.int32)
    mask = torch.tril(torch.ones((K + 1, K + 1), dtype=torch.bool, device=toks.device))
    if draft_kv == "recompute":
        for j in range(steps):
            logits, _ = M.decode_step(cfg, params, cache, toks, tree_mask=mask, **dsia)
            nxt = logits[:, j].argmax(dim=-1).to(torch.int32)
            fill = (have <= j) & (j < limit)
            toks[:, j + 1] = torch.where(fill, nxt, toks[:, j + 1])
    else:
        # one block decode fills the carried buffers and each column's argmax
        base = cache["pos"]
        col_ids = torch.arange(K + 1, dtype=torch.int32, device=toks.device)
        logits, staged = M.decode_step(cfg, params, cache, toks, tree_mask=mask, **dsia)
        nxt = logits.argmax(dim=-1).to(torch.int32)                 # (B, k+1)
        staged_pos = base[:, None] + col_ids[None]
        for j in range(steps):
            fill = (have <= j) & (j < limit)
            toks[:, j + 1] = torch.where(fill, nxt[:, j], toks[:, j + 1])
            if j + 1 == steps:
                break
            # decode only the appended token: rows 0..j are final for every
            # slot (PLD rows from the block decode, drafted rows re-staged by
            # their own step), so causal visibility is exact
            smask = (col_ids <= j)[None, None, :].expand(B, 1, K + 1)
            logits1, st1 = M.decode_step(
                cfg, params, cache, toks[:, j + 1: j + 2], q_pos=(base + j + 1)[:, None],
                staged_kv=staged, staged_pos=staged_pos, staged_mask=smask, **dsia)
            nxt[:, j + 1] = logits1[:, 0].argmax(dim=-1).to(torch.int32)
            for seg, seg1 in zip(staged, st1):
                for unit, unit1 in zip(seg, seg1):
                    for n in ("k", "v"):
                        unit[n][:, :, j + 1] = unit1[n][:, :, 0]
    have = torch.maximum(have, torch.clamp(limit, max=steps)).to(torch.int32)
    return toks[:, 1:], have


def tree_draft_scan(
    cfg: ModelConfig,
    expansions: int,                  # expansion steps (max per-slot budget)
    top_k: int,                       # sibling candidates per expansion
    params: dict,
    cache: dict,                      # batched committed cache (read-only here)
    tokens: torch.Tensor,             # (B, N) int32 seeded node tokens (node 0 = pending)
    parents: torch.Tensor,            # (B, N) int32, -1 at root/unused
    depth: torch.Tensor,              # (B, N) int32
    p_acc: torch.Tensor,              # (B, N) float32 accumulated acceptance
    mask: torch.Tensor,               # (B, N, N) bool ancestor closure
    count: torch.Tensor,              # (B,) int32 nodes used (root + PLD seed)
    limit: torch.Tensor,              # (B,) int32 per-slot expansion budget (Eq. 5)
    alpha: torch.Tensor,              # (B,) float32 per-slot neural acceptance
    c: torch.Tensor,                  # () float32 draft cost coefficient
    t_min,                            # () float32 tensor or float: min-speedup threshold
    gates=None,                       # (num_layers,) DSIA layer gates (mask exec)
    *,
    top_p: float = 0.3,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    quantize: Optional[str] = None,   # "int8": W8A8 MLP matmuls
    attn_override: Optional[dict] = None,    # efficient-attention DSIA
    draft_kv: str = "recompute",
):
    """DyTC tree growth over every slot at once (§4.2, Alg. 1 batched).

    Each step per slot picks the active node with the highest P_acc (the
    root is exempt from the stop rule P_acc * alpha / c < t_min), consumes
    it, and appends the draft's TOP-P-filtered ``top_k`` next tokens as
    children with P_acc ``leaf_p * min(1, alpha * sqrt(p_i / p_top))``. A
    candidate equal to an existing child of the leaf is not re-added; the
    existing node's P_acc is raised to the neural score, and when it is the
    top-1 it becomes ``first_neural``, the Eq. 4 observation point.

    The candidates come from the draft's logits at the leaf: ``"recompute"``
    decodes the whole padded node block every step; ``"carry"`` decodes it
    once, keeping its staged KV and a per-node top-k candidate table, and
    then decodes only each step's <= ``top_k`` appended nodes against
    [cache ++ carried rows] (ancestors through the leaf's closure row, each
    node itself through the new block, siblings mutually invisible). A
    node's logits depend only on its ancestors, which never change, so the
    two give the same trees. ``quantize`` and ``attn_override`` reach every
    draft decode. Returns (tokens, parents, depth, p_acc, mask, count,
    first_neural (B,) int32, -1 if none).
    """
    _check_draft_kv(cfg, draft_kv, "tree_draft_scan")
    dsia = dict(gates=gates, layer_ids=layer_ids, quantize=quantize, attn_override=attn_override)
    B, N = tokens.shape
    dev = tokens.device
    b_idx = torch.arange(B, device=dev)
    slot_j = torch.arange(N, device=dev)[None]
    tokens, parents, depth, mask, count = (t.clone() for t in (tokens, parents, depth, mask, count))
    p_acc = p_acc.float().clone()
    active = slot_j < count[:, None]
    first_neural = torch.full((B,), -1, dtype=torch.int32, device=dev)
    alpha = alpha.float()
    rate = alpha / torch.clamp_min(c.float(), 1e-6)
    base = cache["pos"][:, None]            # drafting never moves pos
    carry = draft_kv == "carry"
    if carry:
        # seed decode: the carried buffers and every node's candidates
        logits, staged = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                       q_pos=base + depth, **dsia)
        cand_v, cand_i = torch.topk(torch.softmax(logits.float(), dim=-1), top_k, dim=-1)
        eye = torch.eye(top_k, dtype=torch.bool, device=dev)
    for e in range(expansions):
        if not carry:
            logits, _ = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                      q_pos=base + depth, **dsia)
        # select (Alg. 1 line 5) + stop rule; the node is consumed either way
        leaf = torch.where(active, p_acc, float("-inf")).argmax(dim=1)
        valid = active.any(dim=1) & (e < limit)
        leaf_p = p_acc[b_idx, leaf]
        grow = valid & ((leaf == 0) | (leaf_p * rate >= t_min))
        active = active & ~(valid[:, None] & (slot_j == leaf[:, None]))
        if carry:
            top_vals, top_idx = cand_v[b_idx, leaf], cand_i[b_idx, leaf]
        else:
            probs = torch.softmax(logits[b_idx, leaf].float(), dim=-1)
            top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
        # append the kept candidates contiguously at count
        parent_row = mask[b_idx, leaf]                       # (B, N)
        parent_depth = depth[b_idx, leaf]
        idxs = []
        for r in range(top_k):
            tok_r = top_idx[:, r].to(torch.int32)
            dup_cand = (parents == leaf[:, None]) & (tokens == tok_r[:, None]) & (slot_j < count[:, None])
            dup = dup_cand.any(dim=1)
            dup_idx = dup_cand.to(torch.uint8).argmax(dim=1)
            keep = grow & ~dup & (count < N)
            if r > 0:   # TOP-P sibling filter (Alg. 1 line 19)
                keep &= top_vals[:, r] >= top_p * top_vals[:, 0]
            idx = torch.where(keep, count.long(), N)
            score = leaf_p * torch.clamp(
                alpha * torch.sqrt(top_vals[:, r] / torch.clamp_min(top_vals[:, 0], 1e-9)),
                max=1.0)
            refresh = slot_j == torch.where(grow & dup, dup_idx, N)[:, None]
            p_acc = torch.where(refresh, torch.maximum(p_acc, score[:, None]), p_acc)
            new = slot_j == idx[:, None]                        # (B, N), none if dropped
            tokens = torch.where(new, tok_r[:, None], tokens)
            parents = torch.where(new, leaf[:, None].to(torch.int32), parents)
            depth = torch.where(new, (parent_depth + 1)[:, None], depth)
            p_acc = torch.where(new, score[:, None], p_acc)
            mask = torch.where(new[:, :, None], (parent_row | new)[:, None, :], mask)
            active = active | new
            if r == 0:
                outcome = torch.where(grow & dup, dup_idx, idx)
                first_neural = torch.where((first_neural < 0) & (outcome < N),
                                           outcome.to(torch.int32), first_neural)
            count = count + keep.to(torch.int32)
            idxs.append(idx)
        if carry and e + 1 < expansions:
            # decode only the appended candidates (dropped ones too, at fixed
            # shape; their writes are dropped) and file their KV and
            # candidates at their node index
            q_new = (base[:, 0] + parent_depth + 1)[:, None].expand(B, top_k)
            logits_n, st_n = M.decode_step(
                cfg, params, cache, top_idx.to(torch.int32), tree_mask=eye, q_pos=q_new,
                staged_kv=staged, staged_pos=base + depth,
                staged_mask=parent_row[:, None, :].expand(B, top_k, N), **dsia)
            cv_n, ci_n = torch.topk(torch.softmax(logits_n.float(), dim=-1), top_k, dim=-1)
            idx_all = torch.stack(idxs, dim=1)                      # (B, top_k), N = dropped
            # the reference's drop-mode scatter into the (R, B, N, KV, hd)
            # buffers, at fixed shape: flat rows b * N + index where kept
            rows = (b_idx[:, None] * N + idx_all.clamp(max=N - 1)).reshape(-1)
            ok = (idx_all < N).reshape(-1)
            for seg, seg_n in zip(staged, st_n):
                for unit, unit_n in zip(seg, seg_n):
                    for n in ("k", "v"):
                        M._scatter_rows(unit[n], rows, ok, unit_n[n].flatten(1, 2))
            for r in range(top_k):
                at = (slot_j == idx_all[:, r: r + 1])[:, :, None]     # (B, N, 1)
                cand_v = torch.where(at, cv_n[:, r][:, None, :], cand_v)
                cand_i = torch.where(at, ci_n[:, r][:, None, :], cand_i)
    return tokens, parents, depth, p_acc, mask, count, first_neural


def _set_at(buf: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
            keep: torch.Tensor) -> torch.Tensor:
    """``buf[b, idx[b]] = value[b]`` where ``keep[b]``: the reference's
    drop-mode scatter at fixed shape, one write per row. A dropped row
    writes its anchor entry (the index clamped into the buffer) back with
    the value it holds, so nothing lands out of bounds. Returns a new
    tensor; ``buf`` is (B, N, ...)."""
    B, N = buf.shape[:2]
    b_idx = torch.arange(B, device=buf.device)
    at = idx.clamp(0, N - 1).long()
    old = buf[b_idx, at]
    new = torch.where(keep.reshape(B, *([1] * (old.ndim - 1))), value.to(buf.dtype), old)
    return buf.index_put((b_idx, at), new)


def cascade_rescore(
    cfg: ModelConfig,
    params: dict,
    cache: dict,                      # batched committed cache (read-only here)
    tokens: torch.Tensor,             # (B, N) int32 node tokens from the level below
    parents: torch.Tensor,            # (B, N) int32 (-1 root)
    depth: torch.Tensor,              # (B, N) int32
    p_acc: torch.Tensor,              # (B, N) float32
    mask: torch.Tensor,               # (B, N, N) bool ancestor closure
    count: torch.Tensor,              # (B,) int32 node slots consumed
    probe: torch.Tensor,              # (B,) int32 node whose verdict to report (-1 none)
    apply: torch.Tensor,              # (B,) bool: slots routed through this level
    alpha: torch.Tensor,              # (B,) float32 this level's acceptance estimate
    gates=None,                       # (num_layers,) this level's DSIA gates (mask exec)
    *,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    quantize: Optional[str] = None,   # "int8": W8A8 MLP matmuls
    attn_override: Optional[dict] = None,    # efficient-attention DSIA
    sampling: Optional[tuple] = None, # (temp (B,), top_k (B,), top_p (B,), u (B, N+2))
):
    """One intermediate-verify dispatch of a stronger cascade level (Alg. 1's
    level-to-level acceptance, batched). The level decodes the padded node
    block under the ancestor masks (the cache stays read-only) and then, per
    slot where ``apply``:

      1. **endorse** — a node whose token equals this level's argmax at its
         parent, with every proper ancestor endorsed, gets its P_acc raised
         to ``parent P_acc * alpha``;
      2. **hedge** — at the shallowest first-mismatch node, this level's
         own continuation is added as a sibling (kept nodes stay: the
         rescored tree is a superset of the drafted one);
      3. **extend** — the deepest endorsed node gets one child with this
         level's continuation.

    An append is dropped when a sibling already carries the token or the
    bucket is full. Slots with ``apply`` false pass through. Returns
    (tokens, parents, depth, p_acc, mask, count, level_node, probe_ok,
    probe_valid): ``level_node`` is the depth-1 node carrying this level's
    continuation of the root (-1 if none), the next level's Eq. 4
    observation point; ``probe_ok`` / ``probe_valid`` are this level's
    verdict on the input node ``probe``, valid only when its ancestors were
    all endorsed.

    ``sampling`` switches on the stochastic rule: a node is endorsed iff
    its uniform ``u[:, j] < q_level[parent](token)`` (``q_level`` the
    level's warped distribution, ``verify.sampling_probs``), and the hedge
    and extension tokens are inverse-CDF draws from ``q_level`` at
    uniforms ``u[:, N]`` and ``u[:, N + 1]`` instead of argmaxes. This
    shapes the proposal only: the target's stochastic walk keeps the round
    lossless in law whatever the tree."""
    B, N = tokens.shape
    dev = tokens.device
    b_idx = torch.arange(B, device=dev)
    slot_j = torch.arange(N, device=dev)[None]
    logits, _ = M.decode_step(cfg, params, cache, tokens, gates=gates, tree_mask=mask,
                              q_pos=cache["pos"][:, None] + depth, layer_ids=layer_ids,
                              quantize=quantize, attn_override=attn_override)
    nxt = logits.argmax(dim=-1).to(torch.int32)                  # (B, N)

    real = slot_j < count[:, None]
    has_parent = real & (parents >= 0)                           # non-root live
    p_clip = parents.clamp(0, N - 1).long()
    parent_nxt = nxt.gather(1, p_clip)
    if sampling is None:
        ok = torch.where(has_parent, tokens == parent_nxt, True)
    else:
        s_temp, s_topk, s_topp, s_u = sampling
        q_lvl = verify_lib.sampling_probs(logits, s_temp, s_topk, s_topp)   # (B, N, V)
        V = q_lvl.shape[-1]
        tok_p = q_lvl.reshape(B, N * V).gather(1, p_clip * V + tokens.long())
        ok = torch.where(has_parent, s_u[:, :N] < tok_p, True)
    bad = has_parent & ~ok
    eye = torch.eye(N, dtype=torch.bool, device=dev)[None]
    anc_bad = (mask & ~eye & bad[:, None, :]).any(dim=-1)        # a bad proper ancestor
    # the probe's verdict before any change (the level below's first prediction)
    probe_c = probe.clamp(0, N - 1).long()[:, None]
    probe_valid = apply & (probe >= 0) & ~anc_bad.gather(1, probe_c)[:, 0]
    probe_ok = ok.gather(1, probe_c)[:, 0] & probe_valid

    alpha = alpha.float()
    parent_p = p_acc.gather(1, p_clip)
    endorsed = real & ~bad & ~anc_bad                            # root included
    p_acc = torch.where(endorsed & has_parent & apply[:, None],
                        torch.maximum(p_acc, parent_p * alpha[:, None]), p_acc)

    def append(tokens, parents, depth, p_acc, mask, count, at, tok, want):
        """One child per slot under node ``at`` carrying ``tok``, at index
        ``count``, where ``want`` and no sibling has the token and the
        bucket has room."""
        sib = (parents == at[:, None]) & (slot_j < count[:, None]) & (tokens == tok[:, None])
        keep = want & ~sib.any(dim=1) & (count < N)
        a = at.long()
        row = mask[b_idx, a] | (slot_j == count[:, None])
        tokens = _set_at(tokens, count, tok, keep)
        parents = _set_at(parents, count, at, keep)
        depth = _set_at(depth, count, depth[b_idx, a] + 1, keep)
        p_acc = _set_at(p_acc, count, p_acc[b_idx, a] * alpha, keep)
        mask = _set_at(mask, count, row, keep)
        return tokens, parents, depth, p_acc, mask, count + keep.to(torch.int32)

    state = (tokens, parents, depth, p_acc, mask, count)
    # hedge: a sibling with this level's continuation at the shallowest
    # first mismatch (the most probable rejection point of the drafted tree)
    cand = bad & ~anc_bad
    has_hedge = cand.any(dim=1)
    hedge_src = torch.where(cand, depth, N + 1).argmin(dim=1)
    hedge_at = p_clip[b_idx, hedge_src].to(torch.int32)
    # extend: one child below the deepest fully endorsed node
    frontier = torch.where(endorsed, depth, -1).argmax(dim=1).to(torch.int32)
    if sampling is None:
        hedge_tok = parent_nxt[b_idx, hedge_src]
        ext_tok = nxt[b_idx, frontier.long()]
    else:
        hedge_tok = verify_lib._inv_cdf(q_lvl[b_idx, hedge_at.long()], s_u[:, N])
        ext_tok = verify_lib._inv_cdf(q_lvl[b_idx, frontier.long()], s_u[:, N + 1])
    state = append(*state, torch.where(has_hedge, hedge_at, 0), hedge_tok, apply & has_hedge)
    state = append(*state, frontier, ext_tok, apply)
    tokens, parents, depth, p_acc, mask, count = state

    # this level's Eq. 4 observation point: the depth-1 node carrying its
    # argmax continuation of the root (the target's own pending token, so
    # the node's parent is always accepted)
    lvl_cand = (parents == 0) & (slot_j < count[:, None]) & (tokens == nxt[:, :1])
    level_node = torch.where(apply & lvl_cand.any(dim=1),
                             lvl_cand.to(torch.uint8).argmax(dim=1).to(torch.int32), -1)
    return tokens, parents, depth, p_acc, mask, count, level_node, probe_ok, probe_valid


def verify_accept_commit(cfg: ModelConfig, params: dict, cache: dict, pending: torch.Tensor,
                         chains: torch.Tensor, have: torch.Tensor, live: torch.Tensor):
    """One target round for chain proposals: verify [pending, chain] jointly,
    accept the longest matching prefix per slot and commit it (dead slots
    accept nothing). Returns (cache, nxt (B, k+1), n_chain (B,),
    new_pending (B,)), int32 tensors."""
    toks = torch.cat([pending[:, None], chains], dim=1).to(torch.int32)
    logits, staged = M.decode_step(cfg, params, cache, toks)
    nxt = logits.argmax(dim=-1).to(torch.int32)                   # (B, k+1)
    B, K = chains.shape
    steps = torch.arange(K + 1, device=toks.device)
    ok = (chains == nxt[:, :K]) & (steps[None, :K] < have[:, None])
    n_chain = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    n_chain = torch.where(live, n_chain, 0)
    n_acc = torch.where(live, n_chain + 1, 0).to(torch.int32)     # + pending
    new_pending = nxt.gather(1, n_chain[:, None].long())[:, 0]
    cache = M.commit_cache(cfg, cache, staged, steps[None].expand(B, K + 1), n_acc)
    return cache, nxt, n_chain, new_pending


def verify_accept_commit_sampled(cfg: ModelConfig, params: dict, cache: dict,
                                 pending: torch.Tensor, chains: torch.Tensor, have: torch.Tensor,
                                 live: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
                                 top_p: torch.Tensor, u: torch.Tensor):
    """``verify_accept_commit`` with speculative-sampling acceptance against
    the warped target distribution (``verify.sample_accept_chain_batched``)
    instead of argmax matching; ``u`` (B, k+1) are the round's uniforms,
    split on the device from the carried keys. Slots with ``temp <= 0`` get
    a one-hot q and accept exactly what the greedy verify accepts. Returns
    (cache, n_chain (B,), new_pending (B,)), int32 tensors."""
    toks = torch.cat([pending[:, None], chains], dim=1).to(torch.int32)
    logits, staged = M.decode_step(cfg, params, cache, toks)
    B, K = chains.shape
    q = verify_lib.sampling_probs(logits, temp, top_k, top_p)          # (B, k+1, V)
    n_chain, new_pending = verify_lib.sample_accept_chain_batched(chains, have, q, u[:, :K],
                                                                   u[:, K])
    n_chain = torch.where(live, n_chain, 0)
    n_acc = torch.where(live, n_chain + 1, 0).to(torch.int32)           # + pending
    steps = torch.arange(K + 1, device=toks.device)
    cache = M.commit_cache(cfg, cache, staged, steps[None].expand(B, K + 1), n_acc)
    return cache, n_chain, new_pending


def tree_verify_accept_commit(cfg: ModelConfig, params: dict, cache: dict,
                              tokens: torch.Tensor, parents: torch.Tensor, depth: torch.Tensor,
                              mask: torch.Tensor, count: torch.Tensor, live: torch.Tensor):
    """One target round for tree proposals: decode the padded node block
    under the per-slot ancestor masks, walk the longest target-greedy path
    per slot on the device (``verify.greedy_accept_tree_device``) and commit
    it (dead slots accept nothing). Returns (cache, path_idx (B, N), n_acc
    (B,), bonus (B,)), int32 tensors; no host read."""
    logits, staged = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                   q_pos=cache["pos"][:, None] + depth)
    nxt = logits.argmax(dim=-1).to(torch.int32)
    path, n_acc, bonus = verify_lib.greedy_accept_tree_device(tokens, parents, count, nxt)
    n_acc = torch.where(live, n_acc, 0)
    cache = M.commit_cache(cfg, cache, staged, path, n_acc)
    return cache, path, n_acc, bonus


def tree_verify_accept_commit_sampled(cfg: ModelConfig, params: dict, cache: dict,
                                      tokens: torch.Tensor, parents: torch.Tensor,
                                      depth: torch.Tensor, mask: torch.Tensor,
                                      count: torch.Tensor, live: torch.Tensor,
                                      temp: torch.Tensor, top_k: torch.Tensor,
                                      top_p: torch.Tensor, u: torch.Tensor):
    """``tree_verify_accept_commit`` with the stochastic tree walk against
    the warped target distribution (``verify.sample_accept_tree_batched``,
    one uniform of ``u`` (B, N) per step); ``temp <= 0`` slots walk the
    greedy path. Returns (cache, path_idx (B, N), n_acc (B,), next token
    (B,)), int32 tensors; no host read."""
    logits, staged = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                   q_pos=cache["pos"][:, None] + depth)
    q = verify_lib.sampling_probs(logits, temp, top_k, top_p)          # (B, N, V)
    path, n_acc, nxt = verify_lib.sample_accept_tree_batched(tokens, parents, count, q, u)
    n_acc = torch.where(live, n_acc, 0)
    cache = M.commit_cache(cfg, cache, staged, path, n_acc)
    return cache, path, n_acc, nxt


def tree_verify_accept_commit_host(cfg: ModelConfig, params: dict, cache: dict,
                                   tokens: torch.Tensor, parents: torch.Tensor,
                                   depth: torch.Tensor, mask: torch.Tensor, count: torch.Tensor,
                                   live: torch.Tensor):
    """``tree_verify_accept_commit`` for the split rounds, which read each
    round's outcome on the host anyway: one read of the target's argmax, the
    walk in numpy (``verify.greedy_accept_tree_batched``: cheaper there than
    the device walk's N-1 steps of small launches), then the commit.
    Returns (cache, path_idx (B, N), n_acc (B,), bonus (B,)); the last three
    are int32 numpy arrays. Where the slots are sharded over the data axes
    (``shard_utils.use_mesh``) the host reads gather every rank's rows, and
    each rank commits its own."""
    logits, staged = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                   q_pos=cache["pos"][:, None] + depth)
    nxt = SU.host(logits.argmax(dim=-1))
    path, n_acc, bonus = verify_lib.greedy_accept_tree_batched(
        SU.host(tokens), SU.host(parents), SU.host(count), nxt)
    n_acc = np.where(SU.host(live), n_acc, 0).astype(np.int32)
    dev = tokens.device
    cache = M.commit_cache(cfg, cache, staged, torch.as_tensor(SU.local_rows(path), device=dev),
                           torch.as_tensor(SU.local_rows(n_acc), device=dev))
    return cache, path, n_acc, bonus


def cascade_rescore_verify(cfg: ModelConfig, level_params: dict, target_params: dict, cache: dict,
                           tokens, parents, depth, p_acc, mask, count, probe, apply, alpha,
                           gates, live: torch.Tensor, *, layer_ids: Optional[List[int]] = None,
                           quantize: Optional[str] = None, attn_override: Optional[dict] = None,
                           sampling: Optional[tuple] = None):
    """The cascade's last rescore with the target verify folded in: the
    strongest level's ``cascade_rescore``, then the target's verify and
    commit over the rescored tree, so an L-level round is 1 draft + (L-2)
    rescores + this. The port runs cascades in split rounds, which read the
    outcome on the host anyway, so the greedy verify is
    ``tree_verify_accept_commit_host`` (the same path and commit as the
    reference's device walk). Returns the rescore's nine outputs followed by
    (cache, path, n_acc, bonus), the last three numpy arrays.

    ``sampling`` = (temp, top_k, top_p, keys (B, 2)): the keys are split
    into 2N + 2 uniforms, N + 2 for the stochastic rescore and N for the
    stochastic walk of the target's verify
    (``tree_verify_accept_commit_sampled``), and the advanced keys are
    returned last."""
    N = tokens.shape[1]
    resc_sampling = None
    if sampling is not None:
        s_temp, s_topk, s_topp, keys = sampling
        new_keys, u = verify_lib.round_uniforms(keys, 2 * N + 2)
        resc_sampling = (s_temp, s_topk, s_topp, u[:, :N + 2])
    out = cascade_rescore(cfg, level_params, cache, tokens, parents, depth, p_acc, mask, count,
                          probe, apply, alpha, gates, layer_ids=layer_ids, quantize=quantize,
                          attn_override=attn_override, sampling=resc_sampling)
    tokens, parents, depth, _, mask, count = out[:6]
    if sampling is None:
        return out + tree_verify_accept_commit_host(cfg, target_params, cache, tokens, parents,
                                                    depth, mask, count, live)
    cache, path, n_acc, nxt = tree_verify_accept_commit_sampled(
        cfg, target_params, cache, tokens, parents, depth, mask, count, live, s_temp, s_topk,
        s_topp, u[:, N + 2:])
    return out + (cache, SU.host(path), SU.host(n_acc), SU.host(nxt), new_keys)


# ===================================================== single-dispatch rounds
def _round_prologue(cache: dict, state: dict, draft_k: int, max_ngram: int, min_ngram: int):
    """Shared head of the rounds: append the pending token to the context
    buffer and propose PLD chains for every slot. Returns (ctx, chains,
    have), dead slots' proposals zeroed."""
    ctx, n = state["ctx"], cache["pos"]
    L = ctx.shape[1]
    # writing pending at position n is the commit of this round's first
    # accepted token (a live slot always accepts it); past the buffer it drops
    d = torch.remainder(n, L).long()[:, None]
    ctx = ctx.scatter(1, d, torch.where(n < L, state["pending"], ctx.gather(1, d)[:, 0])[:, None])
    chains, have = propose_device(ctx, torch.clamp(n + 1, max=L), draft_k,
                                  max_ngram=max_ngram, min_ngram=min_ngram)
    have = torch.where(state["live"], have, 0)
    chains = torch.where(torch.arange(draft_k, device=ctx.device)[None] < have[:, None], chains, 0)
    return ctx, chains, have


def _commit_ctx(ctx: torch.Tensor, n: torch.Tensor, acc_tok: torch.Tensor,
                n_acc: torch.Tensor) -> torch.Tensor:
    """Write this round's accepted tokens into the context buffer at
    positions [n, n + n_acc) (those inside the buffer): the device-side
    upkeep that keeps the next round's PLD exact. Positions taken modulo
    the buffer are distinct per slot, so the entries that write nothing
    write their own old value back."""
    L = ctx.shape[1]
    t_ids = torch.arange(acc_tok.shape[1], device=ctx.device)
    dest = n[:, None] + t_ids[None, :]
    d = torch.remainder(dest, L).long()
    ok = (t_ids[None, :] < n_acc[:, None]) & (dest < L)
    return ctx.scatter(1, d, torch.where(ok, acc_tok.to(ctx.dtype), ctx.gather(1, d)))


def _ema_step(state: dict, outcome: torch.Tensor, obs: torch.Tensor) -> dict:
    alpha, hist, hist_n, hist_ptr = ema_update(state["alpha"], state["hist"], state["hist_n"],
                                               state["hist_ptr"], outcome, obs)
    return {"alpha": alpha, "hist": hist, "hist_n": hist_n, "hist_ptr": hist_ptr}


_TREE = ("tokens", "parents", "depth", "p_acc", "mask", "count", "first_neural")


def chain_prologue(cache: dict, state: dict, c: torch.Tensor, *, draft_k: int, use_draft: bool,
                   adaptive: bool, min_obs: int, t_min: float, max_ngram: int = 4,
                   min_ngram: int = 1) -> dict:
    """The head of ``chain_round``: device PLD and the Eq. 5 budgets.
    Returns the round's intermediate tensors: ``n`` (pos before the
    commit), ``ctx``, ``chains``, ``have``, ``pld_have``, ``limit`` and
    ``ran`` () bool, whether a budget needs the draft (the reference's
    skip predicate, ``any(limit > have)``, over every data rank's slots
    where they are sharded)."""
    live = state["live"]
    n = cache["pos"].clone()                 # the commit advances pos in place
    ctx, chains, have = _round_prologue(cache, state, draft_k, max_ngram, min_ngram)
    limit = torch.zeros_like(have)
    if use_draft:
        if adaptive:
            budget = best_chain_length_batched(state["alpha"], c, draft_k, t_min)
            limit = torch.where(state["hist_n"] >= min_obs, budget, draft_k)
        else:
            limit = torch.full_like(have, draft_k)
        limit = torch.where(live, limit, 0)
    return {"n": n, "ctx": ctx, "chains": chains, "have": have, "pld_have": have.clone(),
            "limit": limit, "ran": SU.any_over_data((limit > have).any())}


def chain_draft(cfg: ModelConfig, params: dict, cache: dict, state: dict, mid: dict, *,
                draft_k: int, gates=None, layer_ids: Optional[List[int]] = None,
                draft_kv: str = "recompute") -> None:
    """The draft of ``chain_round``: the ``draft_k``-step chain scan,
    written in place into ``mid["chains"]`` and ``mid["have"]``. ``gates``
    (mask exec) is read on the host, so a captured round takes it as a
    host array or CPU tensor."""
    chains, have = chain_draft_scan(cfg, draft_k, params, cache, state["pending"], mid["chains"],
                                    mid["have"], mid["limit"], gates, layer_ids=layer_ids,
                                    draft_kv=draft_kv)
    mid["chains"].copy_(chains)
    mid["have"].copy_(have)


def _advance_keys(state: dict, n: int):
    """The live-gated key advance of a sampled round: split every slot's key
    into its next key and ``n`` uniforms, and keep the old key where the
    slot is dead, so a dead slot's stream stays put and a slot still
    prefilling reaches its first decode round with the key admission
    bound. Returns (keys, u)."""
    new_keys, u = verify_lib.round_uniforms(state["key"], n)
    return torch.where(state["live"][:, None], new_keys, state["key"]), u


def chain_tail(cfg: ModelConfig, params: dict, cache: dict, state: dict, mid: dict, *,
               sampled: bool = False):
    """The rest of ``chain_round``: verify, acceptance, cache and context
    commit and the EMA update. Returns (new state, out) as ``chain_round``.
    ``sampled``: speculative-sampling acceptance on the carried keys and
    warp parameters (``verify_accept_commit_sampled``); the new state then
    holds the advanced ``key``."""
    live, pending = state["live"], state["pending"]
    chains, have, pld_have = mid["chains"], mid["have"], mid["pld_have"]
    new = {}
    if sampled:
        new["key"], u = _advance_keys(state, chains.shape[1] + 1)
        cache, n_chain, new_pending = verify_accept_commit_sampled(
            cfg, params, cache, pending, chains, have, live, state["temp"], state["topk"],
            state["topp"], u)
    else:
        cache, _, n_chain, new_pending = verify_accept_commit(cfg, params, cache, pending, chains,
                                                              have, live)
    n_acc = torch.where(live, n_chain + 1, 0)
    acc_tok = torch.cat([pending[:, None], chains], dim=1)
    new.update(ctx=_commit_ctx(mid["ctx"], mid["n"], acc_tok, n_acc),
               pending=torch.where(live, new_pending, pending).to(torch.int32))
    # Eq. 4 EMA over the neural drafter: the first neural position's outcome,
    # only when the PLD prefix was fully accepted (parent-accepted rule)
    obs = live & (have > pld_have) & (n_chain >= pld_have)
    new.update(_ema_step(state, (n_chain > pld_have).float(), obs))
    out = {"acc": acc_tok, "n_acc": n_acc, "drafted": torch.clamp(have - pld_have, min=0),
           "pld_have": pld_have, "budget": mid["limit"], "ran": mid["ran"]}
    return new, out


def chain_round(
    cfg: ModelConfig,
    params: dict,
    cache: dict,                      # committed in place
    state: dict,                      # carried round state (see the server)
    c: torch.Tensor,                  # () float32 draft cost coefficient
    *,
    draft_k: int,
    use_draft: bool,
    adaptive: bool,
    min_obs: int,
    t_min: float,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    draft_kv: str = "recompute",
    max_ngram: int = 4,
    min_ngram: int = 1,
    sampled: bool = False,
):
    """One ``chain_fused`` serving round on carried state: device
    PLD, Eq. 5 per-slot budgets from the carried Eq. 4 state, the
    ``draft_k``-step chain draft (run masked by the budgets: it writes
    nothing where PLD covers every budget), the verify, acceptance, cache
    and context commit and the EMA update, with no host read.

    ``state`` holds ``pending (B,) int32``, ``live (B,) bool``, ``ctx (B,
    max_len) int32`` and the Eq. 4 arrays ``alpha``, ``hist``, ``hist_n``,
    ``hist_ptr`` (``acceptance.ema_init``). Returns (new state, out): new
    tensors for the caller to copy into the carried ones, and the round's
    facts: ``acc (B, k+1)`` (valid prefix ``n_acc``), ``drafted``,
    ``pld_have``, ``budget`` (B,) and ``ran`` () bool, whether a budget
    needed the draft (the reference's skip predicate). The draft runs the
    layers ``layer_ids`` (slice exec; None: every layer); the gate vector
    of mask exec is read on the host, so no round takes one. The
    composition of ``chain_prologue``, ``chain_draft`` and ``chain_tail``.

    ``sampled=True`` (the reference's sampled round): ``state`` also holds
    the per-slot threefry keys ``key`` (B, 2) int64 and warp parameters
    ``temp``, ``topk``, ``topp``; the tail splits the live slots' keys into
    the round's uniforms and accepts by speculative sampling, and the new
    state carries the advanced keys. The prologue and the draft are the
    greedy round's (drafts stay point masses); ``temp <= 0`` slots emit
    the greedy stream."""
    mid = chain_prologue(cache, state, c, draft_k=draft_k, use_draft=use_draft,
                         adaptive=adaptive, min_obs=min_obs, t_min=t_min, max_ngram=max_ngram,
                         min_ngram=min_ngram)
    if use_draft:
        chain_draft(cfg, params, cache, state, mid, draft_k=draft_k, layer_ids=layer_ids,
                    draft_kv=draft_kv)
    return chain_tail(cfg, params, cache, state, mid, sampled=sampled)


def tree_prologue(cache: dict, state: dict, c: torch.Tensor, *, draft_k: int, expansions: int,
                  bucket: int, pld_alpha: float, use_draft: bool, adaptive: bool, min_obs: int,
                  t_min: float, max_ngram: int = 4, min_ngram: int = 1) -> dict:
    """The head of ``tree_round``: device PLD, the tree seed and the
    expansion budgets. Returns ``n``, ``ctx``, ``have`` (the PLD
    lengths), the tree (``tokens``, ``parents``, ``depth``, ``p_acc``,
    ``mask``, ``count``, ``first_neural``), ``limits`` and ``ran``
    (``any(limits > 0)``, the reference's skip predicate, over every data
    rank's slots where they are sharded)."""
    pending, live = state["pending"], state["live"]
    n = cache["pos"].clone()
    B = live.shape[0]
    ctx, chains, have = _round_prologue(cache, state, draft_k, max_ngram, min_ngram)
    tree = tree_seed_device(pending, chains, have, bucket, pld_alpha)
    first_neural = torch.full((B,), -1, dtype=torch.int32, device=live.device)
    limits = torch.zeros_like(have)
    if use_draft and expansions > 0:
        if adaptive:
            budget = best_tree_expansions_batched(state["alpha"], c, expansions, t_min)
            limits = torch.where(state["hist_n"] >= min_obs, budget, expansions)
        else:
            limits = torch.full_like(have, expansions)
        limits = torch.where(live, limits, 0)
    mid = dict(zip(_TREE, (*tree, first_neural)))
    mid.update(n=n, ctx=ctx, have=have, limits=limits, ran=SU.any_over_data((limits > 0).any()))
    return mid


def tree_draft(cfg: ModelConfig, params: dict, cache: dict, state: dict, mid: dict,
               c: torch.Tensor, *, expansions: int, top_k: int, top_p: float, t_min: float,
               gates=None, layer_ids: Optional[List[int]] = None,
               draft_kv: str = "recompute") -> None:
    """The draft of ``tree_round``: the ``expansions``-step tree growth,
    written in place into the prologue's tree tensors; ``gates`` as in
    ``chain_draft``."""
    grown = tree_draft_scan(
        cfg, expansions, top_k, params, cache, *(mid[k] for k in _TREE[:6]), mid["limits"],
        state["alpha"], torch.clamp(c.float(), min=1e-3), t_min, gates, top_p=top_p,
        layer_ids=layer_ids, draft_kv=draft_kv)
    for name, value in zip(_TREE, grown):
        mid[name].copy_(value)


def tree_tail(cfg: ModelConfig, params: dict, cache: dict, state: dict, mid: dict, *,
              sampled: bool = False):
    """The rest of ``tree_round``: verify, the accepted-path walk, cache and
    context commit and the Eq. 4 update. Returns (new state, out).
    ``sampled``: the stochastic walk on the carried keys, one uniform per
    node of the bucket (``tree_verify_accept_commit_sampled``), and the
    advanced ``key`` in the new state."""
    live, pending = state["live"], state["pending"]
    tokens, parents, depth, mask, count = (mid[k] for k in ("tokens", "parents", "depth", "mask",
                                                            "count"))
    first_neural, have = mid["first_neural"], mid["have"]
    B, N = tokens.shape
    new = {}
    if sampled:
        new["key"], u = _advance_keys(state, N)
        cache, path, n_acc, bonus = tree_verify_accept_commit_sampled(
            cfg, params, cache, tokens, parents, depth, mask, count, live, state["temp"],
            state["topk"], state["topp"], u)
    else:
        cache, path, n_acc, bonus = tree_verify_accept_commit(cfg, params, cache, tokens,
                                                              parents, depth, mask, count, live)
    acc_tok = torch.gather(tokens, 1, path.long())
    new.update(ctx=_commit_ctx(mid["ctx"], mid["n"], acc_tok, n_acc),
               pending=torch.where(live, bonus, pending).to(torch.int32))
    # Eq. 4 EMA at the slot's first neural node (parent-accepted rule)
    t_ids = torch.arange(N, device=tokens.device)
    on_path = torch.where(t_ids[None, :] < n_acc[:, None], path, N).long()
    acc_mask = torch.zeros((B, N + 1), dtype=torch.bool, device=tokens.device)
    acc_mask = acc_mask.scatter(1, on_path, True)[:, :N]      # duplicates all write True
    fn_c = torch.clamp(first_neural, 0, N - 1).long()[:, None]
    fn_parent = torch.gather(parents, 1, fn_c)[:, 0]
    parent_ok = torch.gather(acc_mask, 1, torch.clamp(fn_parent, 0, N - 1).long()[:, None])[:, 0]
    obs = live & (first_neural >= 0) & (fn_parent >= 0) & parent_ok
    new.update(_ema_step(state, torch.gather(acc_mask, 1, fn_c)[:, 0].float(), obs))
    out = {"acc": acc_tok, "n_acc": n_acc, "drafted": torch.clamp(count - have - 1, min=0),
           "pld_have": have, "budget": mid["limits"], "ran": mid["ran"]}
    return new, out


def tree_round(
    cfg: ModelConfig,
    params: dict,
    cache: dict,                      # committed in place
    state: dict,                      # carried round state (see chain_round)
    c: torch.Tensor,                  # () float32 draft cost coefficient
    *,
    draft_k: int,
    expansions: int,
    top_k: int,
    top_p: float,
    bucket: int,
    pld_alpha: float,
    use_draft: bool,
    adaptive: bool,
    min_obs: int,
    t_min: float,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    draft_kv: str = "recompute",
    max_ngram: int = 4,
    min_ngram: int = 1,
    sampled: bool = False,
):
    """One ``tree_fused`` (DyTC, §4.2) serving round on carried state:
    device PLD, tree seeding, the ``expansions``-step growth (run
    masked by the budgets: it adds no node where every budget is 0), the
    verify, the accepted-path walk, the cache and context commit and the
    Eq. 4 update, with no host read. Same ``state`` and returns as
    ``chain_round``; ``out["acc"]`` holds the accepted path's tokens (B,
    bucket). The composition of ``tree_prologue``, ``tree_draft`` and
    ``tree_tail``; ``sampled`` as in ``chain_round``, with the stochastic
    tree walk."""
    mid = tree_prologue(cache, state, c, draft_k=draft_k, expansions=expansions, bucket=bucket,
                        pld_alpha=pld_alpha, use_draft=use_draft, adaptive=adaptive,
                        min_obs=min_obs, t_min=t_min, max_ngram=max_ngram, min_ngram=min_ngram)
    if use_draft and expansions > 0:
        tree_draft(cfg, params, cache, state, mid, c, expansions=expansions, top_k=top_k,
                   top_p=top_p, t_min=t_min, layer_ids=layer_ids, draft_kv=draft_kv)
    return tree_tail(cfg, params, cache, state, mid, sampled=sampled)


def prefill_chunk_stage(cfg: ModelConfig, params: dict, cache: dict, state: dict, *,
                        chunk: int, sampled: bool = False) -> None:
    """Chunked prefill inside the serving round, in place: the reference's
    ``prefill_chunk_stage``. Every slot still prefilling
    (``state["pf_done"] < state["pf_len"]``; its prompt sits in the carried
    ``ctx``) consumes up to ``chunk`` prompt tokens through one
    ``decode_step`` and a commit (a prompt needs no verification), which
    advances ``pos`` and ``pf_done`` together. A slot that finishes its
    prompt gets its first token, the argmax of the last prompt position's
    logits, as ``pending`` and joins this round's decode; a slot still
    prefilling gets ``ctx[pos]``, the prompt token already there, so the
    round prologue's pending write leaves the prompt as it is. Slots that
    prefill nothing commit nothing and keep their ``pending``: with no slot
    prefilling the stage changes nothing (the server runs it behind a
    conditional node on ``any(pf_done < pf_len)``).

    ``sampled``: the first token is drawn as the dense admission draws it
    on the host: split the key admission bound, one uniform from the
    second half, warp the last prompt row, inverse CDF; the slot keeps the
    first half of the split only on the round its prompt completes."""
    ctx, pf_done, pf_len = state["ctx"], state["pf_done"], state["pf_len"]
    B, L = ctx.shape
    active = pf_done < pf_len
    n_new = torch.where(active, torch.clamp(pf_len - pf_done, max=chunk), 0).to(torch.int32)
    offs = pf_done[:, None] + torch.arange(chunk, dtype=torch.int32, device=ctx.device)[None]
    toks = ctx.gather(1, offs.clamp(0, L - 1).long())
    logits, staged = M.decode_step(cfg, params, cache, toks, q_pos=offs)
    path = torch.arange(chunk, device=ctx.device)[None].expand(B, chunk)
    M.commit_cache(cfg, cache, staged, path, n_new)
    done_now = active & (pf_done + n_new >= pf_len)
    last_i = torch.clamp(n_new - 1, 0, chunk - 1).long()
    last = logits[torch.arange(B, device=ctx.device), last_i]            # (B, V)
    if sampled:
        keys = prng.split(state["key"], 2)
        q = verify_lib.sampling_probs(last, state["temp"], state["topk"], state["topp"])
        first = verify_lib._inv_cdf(q, prng.uniform(keys[:, 1], 1)[:, 0])
        state["key"].copy_(torch.where(done_now[:, None], keys[:, 0], state["key"]))
    else:
        first = last.argmax(dim=-1).to(torch.int32)
    pend = torch.where(done_now, first, state["pending"])
    new_done = pf_done + n_new
    safe = ctx.gather(1, torch.clamp(cache["pos"], 0, L - 1).long()[:, None])[:, 0]
    state["pending"].copy_(torch.where(new_done < pf_len, safe, pend))
    pf_done.copy_(new_done)
