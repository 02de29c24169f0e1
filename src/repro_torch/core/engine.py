"""CAS-Spec engines: the single-sequence ``SpecEngine`` (DSIA draft
execution + tree verification) and the batched server's round functions
(``chain_draft_scan``, ``tree_draft_scan``, ``verify_accept_commit``,
``tree_verify_accept_commit``).

Execution modes for layer-gated drafts:
  - "slice": run only the kept layers (fewer FLOPs — the honest speed of a
    layer-sparse draft; requires a homogeneous layer stack).
  - "mask": run every layer with the gate vector (gated-off layers add
    nothing to the residual stream).

Cache discipline: drafts are STAGE-ONLY (never committed); only the full
target model's verification staged KV is committed, so the cache is always
exact — the losslessness invariant (see models.model).

The batched functions are the reference's ``core/engine.py`` functions of
the same names with ``draft_kv="recompute"``: every draft step re-decodes
the whole padded (B, N) block against the read-only cache. The reference's
``lax.scan`` over steps is a Python loop here (PyTorch runs eagerly), and
its drop-mode scatters are one-hot ``torch.where`` updates (an index of N
matches no column). A layer-sparse draft runs either through the gate
vector (``gates``, mask exec) or, on a homogeneous stack, through
``layer_ids`` (slice exec): the kept layers only, the same numbers.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.core import verify as verify_lib
from repro_torch.core.acceptance import AcceptanceTracker
from repro_torch.core.dsia import DraftSpec
from repro_torch.core.latency import CostTracker
from repro_torch.core.pld import PromptLookup
from repro_torch.core.tree import DraftTree, bucket_for
from repro_torch.models import model as M


def fake_quant_int8(params: dict) -> dict:
    """Per-output-channel symmetric int8 weight fake-quantization (QSpec sim),
    with the reference's numerics (scale over every axis but the last)."""

    def q(w):
        if not isinstance(w, torch.Tensor) or w.dtype not in (torch.float32, torch.bfloat16):
            return w
        if w.ndim < 2:
            return w
        w32 = w.float()
        scale = w32.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True) / 127.0
        scale = torch.clamp_min(scale, 1e-8)
        return (torch.round(w32 / scale).clamp(-127, 127) * scale).to(w.dtype)

    return M.tree_map(q, params)


class SpecEngine:
    """Single-sequence (B=1) speculative engine."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        max_len: int = 2048,
        draft_exec: str = "auto",          # auto | slice | mask
        *,
        device="cuda",
    ):
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
        T = bucket_for(n)
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
        tokens, rel, mask, _ = tree.flatten()
        n = len(tree)
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


def _check_draft_kv(draft_kv: str, who: str) -> None:
    if draft_kv not in DRAFT_KV_MODES:
        raise ValueError(f"unknown draft_kv {draft_kv!r}; pick one of {DRAFT_KV_MODES}")
    if draft_kv == "carry":
        raise NotImplementedError(
            f"{who}: draft_kv='carry' (carried staged draft KV) is not ported yet "
            "(ROADMAP A.3/A.4); use draft_kv='recompute'")


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
    draft_kv: str = "recompute",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-step neural chain drafting. Step ``j`` re-decodes the (B, k+1) block
    ``[pending, chain]`` under a causal mask and writes the draft's argmax at
    position ``j`` into chain position ``j`` only where ``have <= j <
    limit``: PLD tokens are never overwritten and slots past their budget
    stop. Returns (chains, have) with ``have = max(have, min(limit, steps))``."""
    _check_draft_kv(draft_kv, "chain_draft_scan")
    B, K = chains.shape
    toks = torch.cat([pending[:, None], chains], dim=1).to(torch.int32)
    mask = torch.tril(torch.ones((K + 1, K + 1), dtype=torch.bool, device=toks.device))
    for j in range(steps):
        logits, _ = M.decode_step(cfg, params, cache, toks, gates=gates, tree_mask=mask,
                                  layer_ids=layer_ids)
        nxt = logits[:, j].argmax(dim=-1).to(torch.int32)
        fill = (have <= j) & (j < limit)
        toks[:, j + 1] = torch.where(fill, nxt, toks[:, j + 1])
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
    t_min: torch.Tensor,              # () float32 min-speedup threshold
    gates=None,                       # (num_layers,) DSIA layer gates (mask exec)
    *,
    top_p: float = 0.3,
    layer_ids: Optional[List[int]] = None,   # kept layers (slice exec)
    draft_kv: str = "recompute",
):
    """DyTC tree growth over every slot at once (§4.2, Alg. 1 batched).

    Each step decodes the padded node block, then per slot picks the active
    node with the highest P_acc (the root is exempt from the stop rule
    P_acc * alpha / c < t_min), consumes it, and appends the draft's
    TOP-P-filtered ``top_k`` next tokens as children with P_acc
    ``leaf_p * min(1, alpha * sqrt(p_i / p_top))``. A candidate equal to an
    existing child of the leaf is not re-added; the existing node's P_acc is
    raised to the neural score, and when it is the top-1 it becomes
    ``first_neural``, the Eq. 4 observation point. Returns (tokens, parents,
    depth, p_acc, mask, count, first_neural (B,) int32, -1 if none).
    """
    _check_draft_kv(draft_kv, "tree_draft_scan")
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
    for e in range(expansions):
        logits, _ = M.decode_step(cfg, params, cache, tokens, gates=gates, tree_mask=mask,
                                  q_pos=base + depth, layer_ids=layer_ids)
        # select (Alg. 1 line 5) + stop rule; the node is consumed either way
        leaf = torch.where(active, p_acc, float("-inf")).argmax(dim=1)
        valid = active.any(dim=1) & (e < limit)
        leaf_p = p_acc[b_idx, leaf]
        grow = valid & ((leaf == 0) | (leaf_p * rate >= t_min))
        active = active & ~(valid[:, None] & (slot_j == leaf[:, None]))
        probs = torch.softmax(logits[b_idx, leaf].float(), dim=-1)
        top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
        # append the kept candidates contiguously at count
        parent_row = mask[b_idx, leaf]                       # (B, N)
        parent_depth = depth[b_idx, leaf]
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
    return tokens, parents, depth, p_acc, mask, count, first_neural


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


def tree_verify_accept_commit(cfg: ModelConfig, params: dict, cache: dict,
                              tokens: torch.Tensor, parents: torch.Tensor, depth: torch.Tensor,
                              mask: torch.Tensor, count: torch.Tensor, live: torch.Tensor):
    """One target round for tree proposals: decode the padded node block
    under the per-slot ancestor masks, walk the longest target-greedy path
    per slot (on the host: one read of the argmax) and commit it. Returns
    (cache, path_idx (B, N), n_acc (B,), bonus (B,)); the last three are
    int32 numpy arrays."""
    logits, staged = M.decode_step(cfg, params, cache, tokens, tree_mask=mask,
                                   q_pos=cache["pos"][:, None] + depth)
    nxt = logits.argmax(dim=-1).cpu().numpy()
    path, n_acc, bonus = verify_lib.greedy_accept_tree_batched(
        tokens.cpu().numpy(), parents.cpu().numpy(), count.cpu().numpy(), nxt)
    n_acc = np.where(live.cpu().numpy(), n_acc, 0).astype(np.int32)
    dev = tokens.device
    cache = M.commit_cache(cfg, cache, staged, torch.as_tensor(path, device=dev),
                           torch.as_tensor(n_acc, device=dev))
    return cache, path, n_acc, bonus
