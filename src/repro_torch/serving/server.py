"""Batched speculative serving with continuous batching, split rounds.

The port of the reference's ``serving/server.py::BatchedSpecServer`` in its
``round_mode="split"`` structure, greedy, with ``draft_kv="recompute"``:
each round proposes on the host (prompt lookup, PLD) and on the card (one
neural drafting pass over every slot), then runs one target verify over
every slot that accepts and commits per slot. Two proposal modes:

  - ``chain_fused`` — per-slot PLD chains filled up by a layer-sparse
    neural chain draft (``core.engine.chain_draft_scan``), verified by
    ``core.engine.verify_accept_commit``.
  - ``tree_fused`` — the paper's Dynamic Tree Cascade (§4.2) batched: every
    slot's tree is seeded with its PLD chain (``core.tree.tree_seed_arrays``)
    and grown by ``core.engine.tree_draft_scan`` under per-slot Eq. 5
    budgets, then verified by ``core.engine.tree_verify_accept_commit``.

Greedy output is token-identical to autoregressive decoding: drafts never
write the cache, and only the target's own greedy continuation is
committed. Per-slot budgets come from the host trackers: an Eq. 4 EMA of
the slot's first NEURAL draft token's acceptance (``AcceptanceTracker``,
reset at admission) and the measured draft-to-verify cost ratio
(``CostTracker``, wall clock). Admission prefills a dense B=1 cache at the
prompt's power-of-two bucket and writes it into the slot
(``models.model.write_slot``).

``paged=True`` keeps the KV cache in one shared pool of ``page_size``-token
pages per layer, addressed through a per-slot page table; pages are handed
out at admission (``max_new_tokens`` bounds the reservation) and returned
at ``release``, both host-side. Attention reads the pool through the table
with the paged flash-decode kernel, so paged streams equal dense streams.

Not ported yet (they raise ``NotImplementedError``; ROADMAP queue A):
single-dispatch rounds (``round_mode="single"``), carried draft KV
(``draft_kv="carry"``), sampled serving (``sampling``), the ``legacy`` and
``cascade_fused`` modes, chunked prefill (``prefill_chunk``) and mesh
serving (``mesh``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.core.acceptance import AcceptanceTracker
from repro_torch.core.dsia import PLD_SPEC, DraftSpec
from repro_torch.core.engine import (
    _check_draft_kv,
    chain_draft_scan,
    tree_draft_scan,
    tree_verify_accept_commit,
    verify_accept_commit,
)
from repro_torch.core.latency import CostTracker, best_chain_length, best_tree_expansions
from repro_torch.core.pld import PromptLookup
from repro_torch.core.tree import bucket_for, tree_seed_arrays
from repro_torch.models import model as M

PROPOSAL_MODES = ("chain_fused", "legacy", "tree_fused", "cascade_fused")
ROUND_MODES = ("auto", "single", "split")
_SYNC_EVERY = 1     # split rounds drain every round (the reference's default)


def _prefill_bucket(n: int) -> int:
    """Padded admission-prefill length: next power of two >= n (floor 16)."""
    b = 16
    while b < n:
        b *= 2
    return b


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"BatchedSpecServer: {what} is not ported yet (ROADMAP queue A)")


class BatchedSpecServer:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        max_batch: int = 4,
        max_len: int = 1024,
        draft_k: int = 4,
        draft_spec: Optional[DraftSpec] = None,   # None -> PLD-only drafting
        adaptive: bool = True,         # per-slot adaptive draft budgets
        t_min: float = 1.05,           # min expected speedup to keep drafting
        min_obs: int = 4,              # per-slot observations before adapting
        mode: Optional[str] = None,    # chain_fused (default) | tree_fused
        tree_expansions: int = 5,      # max tree expansion steps per round
        tree_top_k: int = 2,           # sibling candidates per expansion
        tree_top_p: float = 0.3,       # TOP-P sibling filter (P_tree)
        tree_bucket: Optional[int] = None,   # padded tree size (default: fit)
        draft_kv: str = "auto",        # auto | recompute
        round_mode: str = "auto",      # auto | split
        sampling=None,                 # not ported: greedy only
        paged: bool = False,           # block-paged KV cache
        page_size: int = 64,           # tokens per KV page
        num_pages: Optional[int] = None,    # pool size (default: full per-slot)
        prefill_chunk: int = 0,        # not ported
        mesh=None,                     # not ported
        *,
        device="cuda",
    ):
        mode = mode or "chain_fused"
        if mode not in PROPOSAL_MODES:
            raise ValueError(f"unknown proposal mode {mode!r}; pick one of {PROPOSAL_MODES}")
        if mode in ("legacy", "cascade_fused"):
            raise _not_ported(f"mode={mode!r}")
        if round_mode not in ROUND_MODES:
            raise ValueError(f"unknown round_mode {round_mode!r}; pick one of {ROUND_MODES}")
        if round_mode == "single":
            raise _not_ported("round_mode='single' (one dispatch per round)")
        draft_kv = "recompute" if draft_kv == "auto" else draft_kv
        _check_draft_kv(draft_kv, "BatchedSpecServer")
        if sampling is not None:
            raise _not_ported("sampled serving (sampling=...)")
        if prefill_chunk:
            raise _not_ported("chunked prefill (prefill_chunk>0)")
        if mesh is not None:
            raise _not_ported("mesh serving (mesh=...)")
        if draft_spec is not None and draft_spec.unsupported_by_gates_only():
            raise ValueError(
                f"mode {mode!r} drafts gates-only and cannot honor "
                f"{', '.join(draft_spec.unsupported_by_gates_only())} on draft_spec "
                f"{draft_spec.name!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, server on {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.max_len, self.k = max_batch, max_len, draft_k
        self.draft_spec = draft_spec
        self.mode = mode
        self.draft_kv = draft_kv
        self.adaptive, self.t_min, self.min_obs = adaptive, t_min, min_obs
        self.tree_expansions, self.tree_top_k, self.tree_top_p = (
            tree_expansions, tree_top_k, tree_top_p)
        self.tree_bucket = tree_bucket
        if mode == "tree_fused":
            # worst case: root + PLD chain + top_k children per expansion step
            self.tree_bucket = tree_bucket or bucket_for(
                1 + draft_k + tree_top_k * tree_expansions)
        # the draft's layers: the kept ones (slice exec) on a homogeneous
        # stack, else the gate vector (mask exec) — the same numbers
        self._gates = self._layer_ids = None
        if draft_spec is not None:
            gates = draft_spec.gates_array(cfg.num_layers)
            segs = M.layout(cfg)
            if len(segs) == 1 and len(segs[0].unit) == 1:
                self._layer_ids = [int(i) for i in np.flatnonzero(gates > 0)]
            else:
                self._gates = torch.as_tensor(gates, device=self.device)

        self.pld = PromptLookup(max_draft=draft_k)
        self.acceptance = AcceptanceTracker()
        self.costs = CostTracker()
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.cache = M.init_cache(cfg, max_batch, max_len, dtype=getattr(torch, cfg.dtype),
                                  paged=self.paged, page_size=self.page_size,
                                  num_pages=num_pages, device=self.device)
        # host-side page allocator: a free list touched only at admission and
        # release; pop() from the end hands out the lowest page indices first
        self._pages_per_slot = 0
        self._free_pages: List[int] = []
        self._slot_pages: Dict[int, List[int]] = {}
        if self.paged:
            self._pages_per_slot = M.pages_for(max_len, self.page_size)
            pool = int(num_pages) if num_pages is not None else max_batch * self._pages_per_slot
            self._free_pages = list(range(pool))[::-1]
        self.pending = np.zeros(max_batch, np.int64)
        self.contexts: List[List[int]] = [[] for _ in range(max_batch)]
        self.live = np.zeros(max_batch, bool)
        self._pld_have = np.zeros(max_batch, np.int32)   # PLD prefix per round
        self.stats = {"target_calls": 0, "draft_dispatches": 0, "tokens": 0, "steps": 0,
                      "host_syncs": 0}

    # ------------------------------------------------------------ admission
    def add_request(self, slot: int, prompt: np.ndarray,
                    max_new_tokens: Optional[int] = None) -> None:
        """Prefill one prompt into a batch slot. On a paged build,
        ``max_new_tokens`` bounds the slot's pages to prompt + budget + one
        round's overshoot instead of ``max_len``; dense builds ignore it."""
        prompt = np.asarray(prompt, np.int32)
        table_row = None
        if self.paged:
            alloc = (self.max_len if max_new_tokens is None
                     else min(self.max_len, len(prompt) + int(max_new_tokens) + self._alloc_slack()))
            table_row = self._alloc_pages(slot, alloc)
        # prefill at the prompt's power-of-two bucket, not max_len: positions
        # past the prompt stay invisible through kv_pos masking
        bucket = min(_prefill_bucket(len(prompt)), self.max_len)
        c1 = M.init_cache(self.cfg, 1, bucket, dtype=getattr(torch, self.cfg.dtype),
                          device=self.device)
        last, c1 = M.prefill(self.cfg, self.params,
                             {"tokens": torch.as_tensor(prompt[None], device=self.device)}, c1)
        if self.paged:
            self.cache["page_table"][slot] = torch.as_tensor(table_row, device=self.device)
        self.cache = M.write_slot(self.cfg, self.cache, c1, slot)
        self.pending[slot] = int(last[0].argmax())
        self.contexts[slot] = [int(t) for t in prompt]
        self.live[slot] = True
        # the slot's estimator restarts from the draft's cold-start prior:
        # continuous batching reuses slots across unrelated requests
        prior = self.draft_spec.prior_alpha if self.draft_spec else 0.5
        self.acceptance.reset(self._slot_key(slot), alpha0=prior)

    # -------------------------------------------------- page pool (paged)
    def _alloc_slack(self) -> int:
        """Commit overshoot past ``max_new_tokens``: the rounds in flight
        when the finish is observed keep committing."""
        per_round = self.tree_bucket or (self.k + 1)
        return (_SYNC_EVERY + 1) * per_round

    def _alloc_pages(self, slot: int, n_tokens: int) -> np.ndarray:
        """Reserve pool pages covering ``n_tokens`` for a slot; returns the
        slot's full table row (-1 past the allocation)."""
        need = min(-(-int(n_tokens) // self.page_size), self._pages_per_slot)
        self._free_slot_pages(slot)
        if need > len(self._free_pages):
            raise RuntimeError(
                f"KV page pool exhausted: slot {slot} needs {need} pages, "
                f"{len(self._free_pages)} free — raise num_pages or admit "
                "fewer/shorter concurrent requests")
        pages = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = np.full(self._pages_per_slot, -1, np.int32)
        row[:need] = pages
        return row

    def _free_slot_pages(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._free_pages.extend(pages)

    def release(self, slot: int) -> None:
        """Mark a slot free (its request finished or was cancelled). Its
        ``pos`` drops to 0 and, on a paged build, its pages go back to the
        pool and its table row to -1, so that the live prefix every later
        call scans (``max(pos)`` over the batch) forgets the request."""
        self.live[slot] = False
        self.cache["pos"][slot] = 0
        if self.paged:
            self._free_slot_pages(slot)
            self.cache["page_table"][slot] = -1

    def _slot_key(self, slot: int) -> str:
        return f"chain:{slot}"

    # ----------------------------------------------------- adaptive budgets
    def _slot_limit(self, slot: int) -> int:
        """Neural chain draft budget for a slot this round (PLD is never capped)."""
        if self.draft_spec is None:
            return 0
        key = self._slot_key(slot)
        if not self.adaptive or self.acceptance.counts(key) < self.min_obs:
            return self.k
        c = self.costs.c_hat("chain_draft", default=float(self.draft_spec.prior_c))
        return best_chain_length(self.acceptance.alpha(key), max(c, 1e-3), self.k, self.t_min)

    def _slot_tree_budget(self, slot: int) -> int:
        """Tree expansion budget for a slot this round (Eq. 5 objective)."""
        if self.draft_spec is None:
            return 0
        key = self._slot_key(slot)
        if not self.adaptive or self.acceptance.counts(key) < self.min_obs:
            return self.tree_expansions
        c = self.costs.c_hat("tree_draft", default=float(self.draft_spec.prior_c))
        return best_tree_expansions(self.acceptance.alpha(key), max(c, 1e-3),
                                    self.tree_expansions, self.t_min)

    # ------------------------------------------------------------- stepping
    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _pld_chains(self):
        """Per-slot PLD proposals (B, k) and their lengths. Also records
        where PLD ends per slot: the estimator that prices the NEURAL draft
        sees neural-token outcomes only."""
        chains = np.zeros((self.B, self.k), np.int32)
        have = np.zeros(self.B, np.int32)
        for b in range(self.B):
            if not self.live[b]:
                continue
            ctx = np.asarray(self.contexts[b] + [int(self.pending[b])], np.int64)
            toks = self.pld.propose(ctx, self.k)
            chains[b, : len(toks)] = toks
            have[b] = len(toks)
        self._pld_have = have.copy()
        return chains, have

    def _propose(self):
        """Per-slot draft chains (B, k): PLD first, neural fill-in."""
        chains, have = self._pld_chains()
        limit = np.zeros(self.B, np.int32)
        for b in range(self.B):
            if self.live[b]:
                limit[b] = self._slot_limit(b)
        if self.draft_spec is None:
            return chains, have
        return self._propose_fused(chains, have, limit)

    def _propose_fused(self, chains, have, limit):
        # one drafting pass over every slot; steps = the largest per-slot
        # budget still needing neural fill
        steps = int(np.max(np.where(limit > have, limit, 0), initial=0))
        if steps == 0:
            return chains, have
        t0 = time.perf_counter()
        ch_d, hv_d = chain_draft_scan(
            self.cfg, steps, self.params, self.cache, self._dev(self.pending), self._dev(chains),
            self._dev(have), self._dev(limit), self._gates, draft_kv=self.draft_kv,
            layer_ids=self._layer_ids)
        chains, have = ch_d.cpu().numpy(), hv_d.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["draft_dispatches"] += 1
        self.stats["host_syncs"] += 1
        # per-draft-step latency -> c_hat = draft step / verify round
        self.costs.observe("chain_draft", dt, tokens=steps)
        return chains, have

    def step(self) -> Dict[int, List[int]]:
        """One speculative round for the whole batch; returns the accepted
        tokens per live slot."""
        if self.mode == "tree_fused":
            return self._step_tree()
        chains, have = self._propose()
        t0 = time.perf_counter()
        self.cache, _, n_chain, new_pending = verify_accept_commit(
            self.cfg, self.params, self.cache, self._dev(self.pending), self._dev(chains),
            self._dev(have), self._dev(self.live, torch.bool))
        n_chain, new_pending = n_chain.cpu().numpy(), new_pending.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["host_syncs"] += 1
        self.stats["target_calls"] += 1
        self.costs.observe_target(dt, tokens=1)   # per-round target latency

        out: Dict[int, List[int]] = {}
        for b in range(self.B):
            if not self.live[b]:
                continue
            acc = [int(self.pending[b])] + [int(t) for t in chains[b, : n_chain[b]]]
            self.contexts[b].extend(acc)
            out[b] = acc
            self.stats["tokens"] += len(acc)
            # Eq. 4 EMA over the NEURAL drafter: observe the first neural
            # position's outcome, only when its PLD prefix was fully accepted
            # (DyTC's parent-accepted rule); PLD outcomes never enter alpha
            pld_n = int(self._pld_have[b])
            if have[b] > pld_n and n_chain[b] >= pld_n:
                self.acceptance.observe(self._slot_key(b), n_chain[b] > pld_n)
        self.pending = np.where(self.live, new_pending.astype(np.int64), self.pending)
        self.stats["steps"] += 1
        return out

    def _step_tree(self) -> Dict[int, List[int]]:
        """One DyTC round for the whole batch: PLD-seeded tree growth (one
        drafting pass), then verify + path commit (one target call)."""
        chains, have = self._pld_chains()
        limits = np.zeros(self.B, np.int32)
        alphas = np.full(self.B, 0.5, np.float32)
        for b in range(self.B):
            if self.live[b]:
                limits[b] = self._slot_tree_budget(b)
                alphas[b] = self.acceptance.alpha(self._slot_key(b))
        seed = tree_seed_arrays(self.pending.astype(np.int32), chains, have, self.tree_bucket,
                                pld_alpha=PLD_SPEC.prior_alpha)
        d_tokens, d_parents, d_depth, d_p_acc, d_mask, d_count = (
            torch.as_tensor(a, device=self.device) for a in seed)
        tokens, parents, count = seed[0], seed[1], seed[5]
        first_neural = np.full(self.B, -1, np.int32)
        expansions = int(limits.max(initial=0))
        if expansions > 0:
            c = self.costs.c_hat("tree_draft", default=float(self.draft_spec.prior_c))
            t0 = time.perf_counter()
            out = tree_draft_scan(
                self.cfg, expansions, self.tree_top_k, self.params, self.cache,
                d_tokens, d_parents, d_depth, d_p_acc, d_mask, d_count, self._dev(limits),
                self._dev(alphas, torch.float32),
                torch.tensor(max(c, 1e-3), dtype=torch.float32, device=self.device),
                torch.tensor(self.t_min, dtype=torch.float32, device=self.device),
                self._gates, top_p=self.tree_top_p, draft_kv=self.draft_kv,
                layer_ids=self._layer_ids)
            # depth/mask stay on the card (only the verify reads them)
            d_tokens, d_parents, d_depth, _, d_mask, d_count, d_first = out
            tokens, parents, count, first_neural = (
                a.cpu().numpy() for a in (d_tokens, d_parents, d_count, d_first))
            dt = time.perf_counter() - t0
            self.stats["draft_dispatches"] += 1
            self.stats["host_syncs"] += 1
            # per-expansion-step latency -> the c in the Eq. 5 budgets
            self.costs.observe("tree_draft", dt, tokens=expansions)

        t0 = time.perf_counter()
        self.cache, path, n_acc, bonus = tree_verify_accept_commit(
            self.cfg, self.params, self.cache, d_tokens, d_parents, d_depth, d_mask, d_count,
            self._dev(self.live, torch.bool))
        dt = time.perf_counter() - t0
        self.stats["target_calls"] += 1
        self.stats["host_syncs"] += 1
        self.costs.observe_target(dt, tokens=1)

        out_toks: Dict[int, List[int]] = {}
        for b in range(self.B):
            if not self.live[b]:
                continue
            nodes = path[b, : n_acc[b]]
            acc = [int(tokens[b, i]) for i in nodes]
            self.contexts[b].extend(acc)
            out_toks[b] = acc
            self.stats["tokens"] += len(acc)
            # Eq. 4 EMA: observe the slot's first NEURAL top-1 prediction,
            # and only when its parent was accepted (DyTC's parent-accepted
            # rule; the root is always accepted). When the drafter's top-1
            # duplicated an existing PLD child, first_neural aliases that
            # node — the outcome priced is still the neural prediction's.
            fn = int(first_neural[b])
            if fn >= 0:
                node_set = {int(i) for i in nodes}
                if int(parents[b, fn]) in node_set:
                    self.acceptance.observe(self._slot_key(b), fn in node_set)
        self.pending = np.where(self.live, bonus.astype(np.int64), self.pending)
        self.stats["steps"] += 1
        return out_toks

    def flush(self) -> Dict[int, List[int]]:
        """Tokens buffered by in-flight rounds, per slot. Split rounds return
        their tokens from ``step`` and leave nothing in flight, so this is
        empty; it exists for the reference's calling convention."""
        return {}
