"""Batched speculative serving with continuous batching, greedy or sampled:
the port of the reference's ``serving/server.py::BatchedSpecServer``. Four
proposal modes:

  - ``chain_fused`` — per-slot PLD chains filled up by a layer-sparse
    neural chain draft (``core.engine.chain_draft_scan``), verified by
    ``core.engine.verify_accept_commit``.
  - ``legacy`` (``fused=False``) — the same chains drafted one token per
    decode call with a host read after each: the per-step baseline.
  - ``tree_fused`` — the paper's Dynamic Tree Cascade (§4.2) batched: every
    slot's tree is seeded with its PLD chain and grown by
    ``core.engine.tree_draft_scan`` under per-slot Eq. 5 budgets, then
    verified by ``core.engine.tree_verify_accept_commit`` (split rounds:
    ``tree_verify_accept_commit_host``, which walks the tree on the host).
  - ``cascade_fused`` — the paper's multi-level cascade (§4.1 + Alg. 1)
    batched: a ``DraftBank`` makes a DSIA hierarchy (``hierarchy=``, by
    default ``build_hierarchy(cfg, "mixing")``: LS0.4 over LS0.6+Q8 over
    PLD) executable; the cheapest level grows every slot's PLD-seeded tree
    in one drafting scan, each stronger level rescores it in one dispatch
    (``core.engine.cascade_rescore``: endorse, hedge, extend) and the last
    one carries the target verify (``cascade_rescore_verify``). Each slot is
    routed by ``latency.best_cascade_plan``: the cascade, the cheapest level
    alone, or PLD alone. An int8 level runs its MLP products through the
    W8A8 kernel on weights quantized once (``int8_exec``).

Two round structures (``round_mode``; ``"auto"`` is ``"single"`` for
``chain_fused`` and ``tree_fused`` and ``"split"`` for ``legacy`` and
``cascade_fused``, as in the reference, whose cascade keeps one dispatch per
level):

  - ``"single"`` — one round is ``core.engine.chain_round`` /
    ``tree_round`` on carried device state (``dstate``: pending tokens,
    live flags, the (B, max_len) context buffer PLD reads, and the per-slot
    Eq. 4 estimators; the cost coefficient c is the draft's prior). The
    round reads nothing on the host. On the card the server captures it
    once, at build, as segment graphs (prologue, draft, tail; chunked
    prefill ahead of them) and assembles one CUDA graph in which the draft
    sits behind a conditional node on the round's own predicate, as the
    reference's ``lax.cond`` (``kernels/graph_cond.py``); ``step()``
    launches it: one launch per round, and a round whose budgets need no
    draft runs none of the draft's kernels. On the CPU the round runs
    eagerly, the draft masked by the budgets (it writes nothing there).
    Accepted tokens go to a device ring of ``sync_every`` rounds; the host
    reads it (its one sync) every ``sync_every`` rounds, at admission and
    at ``flush()``, so ``step()`` returns the tokens drained so far.
  - ``"split"`` — host PLD, one neural drafting pass and one target verify
    per round, with a host read after each, and budgets from the host
    trackers (``AcceptanceTracker``; ``CostTracker`` on the wall clock).

Greedy output is token-identical to autoregressive decoding: drafts never
write the cache, and only the target's own greedy continuation is
committed. Admission prefills a dense B=1 cache at the prompt's
power-of-two bucket and writes it into the slot (``models.model.write_slot``).
Every carried tensor (cache, ``pos``, page table, ``dstate``) is updated in
place, since a graph reads the tensors it was captured with.

``paged=True`` keeps the KV cache in one shared pool of ``page_size``-token
pages per layer, addressed through a per-slot page table; pages are handed
out at admission (``max_new_tokens`` bounds the reservation) and returned
at ``release``, both host-side. Attention reads the pool through the table
with the paged flash-decode kernel, so paged streams equal dense streams.

``draft_kv="auto"`` resolves as the reference's does: to ``"carry"`` on
attention-only stacks, where the draft scans decode the block once and
then only the appended tokens against carried staged KV, and to
``"recompute"`` on stacks with Mamba-2 blocks, whose per-step states are
cumulative. Those stacks (mamba2-130m, jamba-v0.1-52b) serve through
``chain_fused`` and ``legacy`` only: ``tree_fused``, ``cascade_fused``,
carried draft KV and chunked prefill raise, with the reference's words.
A single round captures their recurrence in its graph like any other
layer. A codebook stack (musicgen-medium) is not served: its tokens are not
scalar, so every mode raises ``ValueError`` at construction
(``chain_fused`` and ``legacy`` through ``engine.check_text_stack``, where
the reference fails at admission with a broadcast error).
``prefill_chunk > 0`` (paged, single rounds) makes admission enqueue-only: each round consumes up to ``prefill_chunk`` prompt tokens per
prefilling slot (``core.engine.prefill_chunk_stage``, behind a conditional
node of its own), and slots still prefilling are dead for the decode half.

Sampled serving: ``sampling=SamplingParams(temperature, top_k, top_p,
seed)`` makes every mode verify by speculative sampling against the warped
target distribution (``core/verify.py``): chain rounds accept each drafted
token with its probability under q and resample the residual, tree and
cascade rounds walk the tree stochastically, and cascade rescores endorse,
hedge and extend stochastically. Each slot carries its warp parameters and
a threefry key in ``dstate`` (``temp``, ``topk``, ``topp``, ``key``, on
sampled builds only); every dispatch splits the keys it needs with tensor
ops (``core/prng.py``, the reference's ``jax.random`` stream bit for bit),
so sampling adds no dispatch and no host sync to any round, and a single
round's graph splits them inside the graph. ``add_request(...,
sampling=...)`` overrides the build's parameters per request (a greedy
build refuses a stochastic request); the request's key comes from its
``seed`` or from ``fold_in(base key, admission count)``, and its first
token is drawn on the host from the warped prefill row. ``temperature=0``
streams equal the greedy build's, and a greedy build (``sampling=None``)
runs exactly the greedy rounds.

Telemetry, as the reference's: ``stats`` is a ``StatsView`` over the
server's ``MetricsRegistry`` (``metrics``, shared when passed in), which
also holds the serving counters and gauges. ``telemetry=True`` (the default)
keeps the round telemetry buffer (``serving/telemetry.py``) on the device: a
single round adds to it in place inside its captured graph, in the tail
segment every round runs. Split, ``legacy`` and cascade rounds tally on
the host, in a numpy twin, from arrays they already read (the port's verify
reads its verdict to the host, so a device tally would only copy those
arrays back). The host reads the buffer only at ``flush`` and
``telemetry_totals``, after the rounds' own outputs, so
telemetry adds no launch and no host sync to a round. The ring's per-round
facts, folded on the host at every drain (``ring_totals``), must equal the
device buffer of a single-round server at every telemetry drain; a
mismatch raises. ``telemetry_totals()`` and ``metrics_summary()`` report
it.

A draft runs the kept layers alone (slice exec) on a homogeneous stack and
every layer under its 0/1 gate on a mixed one (mask exec, gemma3's
sliding/global stack): a gated-off layer still runs and adds ``delta * 0``,
as in the reference. The gates are fixed at build and kept on the host, so
single rounds over a mixed stack capture as any other.

Mesh serving (``mesh=``, a ``launch.mesh.Mesh``; SPMD, one process a
device, every rank building the same server): the target and every
draft-bank level are tensor-parallel over ``model`` (the caller passes this
rank's shards, ``bridge.params_from_jax(mesh=)`` or
``models.model.init_params(mesh=)``; int8 copies take the whole column's
scales), and the per-slot state (cache, ``dstate``, the output ring, the
device telemetry) is sharded over the data axes, or replicated where
``max_batch`` does not divide them (``launch.sharding.batch_axis``). The
host runs the same scheduler on every rank over all ``max_batch`` slots;
each host read the server already makes gathers the slots' rows over the
data axes on the device first, and each plan predicate is reduced with a
MAX over them, so graph launches and host syncs per round equal the
single-device server's and every rank launches the same graph. A slot's
admission prefill runs on the ranks that hold the slot. Single rounds
capture the NCCL collectives in their graph; a ``gloo`` mesh on the card
cannot be captured and refuses ``round_mode="single"``.
"""
from __future__ import annotations

import functools
import inspect
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config.base import ModelConfig
from repro_torch.core import prng
from repro_torch.core.acceptance import AcceptanceTracker, ema_init
from repro_torch.core.dsia import PLD_SPEC, DraftSpec, build_hierarchy
from repro_torch.core.engine import (
    _check_draft_kv,
    check_text_stack,
    check_tree_stack,
    cascade_rescore,
    cascade_rescore_verify,
    chain_draft,
    chain_draft_scan,
    chain_prologue,
    chain_tail,
    prefill_chunk_stage,
    tree_draft,
    tree_draft_scan,
    tree_prologue,
    tree_tail,
    tree_verify_accept_commit_host,
    tree_verify_accept_commit_sampled,
    verify_accept_commit,
    verify_accept_commit_sampled,
)
from repro_torch.core.latency import (
    CostTracker,
    best_cascade_plan,
    best_chain_length,
    best_tree_expansions,
)
from repro_torch.core.pld import PromptLookup
from repro_torch.core.tree import bucket_for, tree_seed_arrays
from repro_torch.core.verify import round_uniforms
from repro_torch.kernels import launch_counts
from repro_torch.kernels.graph_cond import CondGraph
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models import shard_utils as SU
from repro_torch.serving import telemetry as TM
from repro_torch.serving.draft_bank import DraftBank
from repro_torch.serving.sampler import SamplingParams, warp_probs

PROPOSAL_MODES = ("chain_fused", "legacy", "tree_fused", "cascade_fused")
ROUND_MODES = ("auto", "single", "split")
# ring columns after acc: per slot, then the round's two predicates
_RING_FACTS = ("n_acc", "drafted", "pld_have", "budget", "ran", "prefilled")


def _prefill_bucket(n: int) -> int:
    """Padded admission-prefill length: next power of two >= n (floor 16)."""
    b = 16
    while b < n:
        b *= 2
    return b


def _batch_sharded(mesh, max_batch: int) -> bool:
    """Whether a server's per-slot state shards over the mesh's data axes."""
    return mesh is not None and SH.batch_axis(mesh, max_batch) is not None


def _on_mesh(fn):
    """Run a server method with the server's mesh active (no-op off-mesh)."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with SU.use_mesh(self.mesh, batch_sharded=self._bshard):
            return fn(self, *args, **kwargs)
    return run


def _init_on_mesh(fn):
    """The constructor with its ``mesh`` active: a mesh is a ``Mesh``."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        mesh = bound.arguments["mesh"]
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"BatchedSpecServer: mesh must be a launch.mesh.Mesh or None, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self._bshard = _batch_sharded(mesh, bound.arguments["max_batch"])
        with SU.use_mesh(mesh, batch_sharded=self._bshard):
            fn(self, *args, **kwargs)
    return run


class BatchedSpecServer:
    @_init_on_mesh
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
        mode: Optional[str] = None,    # chain_fused | legacy | tree_fused | cascade_fused
        tree_expansions: int = 5,      # max tree expansion steps per round
        tree_top_k: int = 2,           # sibling candidates per expansion
        tree_top_p: float = 0.3,       # TOP-P sibling filter (P_tree)
        tree_bucket: Optional[int] = None,   # padded tree size (default: fit)
        draft_kv: str = "auto",        # auto (carry; SSM stacks recompute) | carry | recompute
        round_mode: str = "auto",      # auto (= single) | single | split
        sync_every: Optional[int] = None,   # single: drain every N rounds (default 1)
        sampling: Optional[SamplingParams] = None,   # None: greedy build
        paged: bool = False,           # block-paged KV cache
        page_size: int = 64,           # tokens per KV page
        num_pages: Optional[int] = None,    # pool size (default: full per-slot)
        prefill_chunk: int = 0,        # >0: in-round chunked prefill (paged, single)
        mesh=None,                     # launch.mesh.Mesh: TP params + DP slots
        *,
        fused: bool = True,            # False (with mode unset): legacy per-step drafting
        hierarchy: Optional[List[DraftSpec]] = None,   # cascade_fused levels
        int8_exec: str = "auto",       # the bank's int8 path: auto | kernel | sim
        telemetry: bool = True,        # the device round telemetry buffer
        metrics: Optional[TM.MetricsRegistry] = None,   # shared host registry
        device="cuda",
    ):
        if mode is None:
            mode = "chain_fused" if fused else "legacy"
        if mode not in PROPOSAL_MODES:
            raise ValueError(f"unknown proposal mode {mode!r}; pick one of {PROPOSAL_MODES}")
        if round_mode not in ROUND_MODES:
            raise ValueError(f"unknown round_mode {round_mode!r}; pick one of {ROUND_MODES}")
        if round_mode == "auto":
            round_mode = "single" if mode in ("chain_fused", "tree_fused") else "split"
        if round_mode == "single" and mode not in ("chain_fused", "tree_fused"):
            raise ValueError(
                "round_mode='single' applies to chain_fused/tree_fused; legacy IS the per-step "
                "split baseline, and cascade_fused keeps one dispatch per level (the target "
                "verify rides the last rescore dispatch instead)")
        self.round_mode = round_mode
        self.sync_every = max(int(sync_every or 1), 1)
        # MoE layers count as attention blocks (src/repro/serving/server.py:343-352)
        attention_only = not cfg.num_codebooks and not M.has_mamba(cfg)
        if draft_kv == "auto":
            # carry: O(top_k) new-token decodes per expansion step instead of
            # the padded-block recompute, everywhere but on SSM and codebook stacks
            draft_kv = "carry" if attention_only else "recompute"
        _check_draft_kv(cfg, draft_kv, "BatchedSpecServer")
        if mode in ("chain_fused", "legacy"):
            # tree_fused and cascade_fused refuse a codebook stack in the
            # reference's words, with the Mamba-2 stacks (check_tree_stack)
            check_text_stack(cfg, f"BatchedSpecServer(mode={mode!r})")
        if sampling is not None and not isinstance(sampling, SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams or None, not "
                            f"{type(sampling).__name__}")
        # the build's default warp parameters; requests may override them
        # at admission. The base key seeds requests that bring no seed
        self.sampling = sampling
        self._admit_seq = 0            # admissions so far (the key derivation)
        self._base_key = None
        if sampling is not None:
            self._base_key = prng.prng_key(sampling.seed if sampling.seed is not None else 0)
        self.prefill_chunk = int(prefill_chunk or 0)
        if self.prefill_chunk and not paged:
            raise ValueError("prefill_chunk requires paged=True: chunked prompts commit "
                             "through the page table")
        if self.prefill_chunk and self.round_mode != "single":
            raise ValueError("prefill_chunk rides the single round: build with "
                             "round_mode='single'")
        if self.prefill_chunk and not attention_only:
            raise ValueError("prefill_chunk requires an attention-only text stack: chunked "
                             "prompt commits address KV through the page table, and SSM "
                             "per-step states are cumulative")
        if draft_spec is not None:
            if mode == "cascade_fused":
                raise ValueError(
                    "cascade_fused drafts from a hierarchy, not a single draft_spec — pass "
                    "hierarchy=[...] (or leave both unset for the default mixing hierarchy)")
            if draft_spec.unsupported_by_gates_only():
                raise ValueError(
                    f"mode {mode!r} drafts gates-only and cannot honor "
                    f"{', '.join(draft_spec.unsupported_by_gates_only())} on draft_spec "
                    f"{draft_spec.name!r}; mode='cascade_fused' executes quantize/attn_override "
                    "levels through the draft bank")
        if hierarchy is not None and mode != "cascade_fused":
            raise ValueError("hierarchy=... requires mode='cascade_fused'")
        self.device = resolve_device(device)
        if (mesh is not None and mesh.backend == "gloo" and self.device.type == "cuda"
                and self.round_mode == "single"):
            raise ValueError(
                "round_mode='single' captures the round's collectives in a CUDA graph, and a "
                "gloo mesh stages CUDA tensors through the host, which a capture cannot hold: "
                "use round_mode='split' on a gloo mesh, or an nccl mesh")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, server on {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.max_len, self.k = max_batch, max_len, draft_k
        # this rank's slots of the per-slot device state (all of them off-mesh)
        self._bl = max_batch // SU.data_size() if self._bshard else max_batch
        self.draft_spec = draft_spec
        self.mode = mode
        self.draft_kv = draft_kv
        self.adaptive, self.t_min, self.min_obs = adaptive, t_min, min_obs
        self.tree_expansions, self.tree_top_k, self.tree_top_p = (
            tree_expansions, tree_top_k, tree_top_p)
        self.tree_bucket = tree_bucket
        self.bank: Optional[DraftBank] = None
        if mode in ("tree_fused", "cascade_fused"):
            check_tree_stack(cfg, mode)
            # worst case: root + PLD chain + top_k children per expansion step,
            # and for a cascade one hedge sibling and one extension per rescorer
            extra = 0
            if mode == "cascade_fused":
                self.bank = DraftBank(cfg, params, hierarchy if hierarchy is not None
                                      else build_hierarchy(cfg, "mixing"), int8_exec=int8_exec)
                extra = 2 * len(self.bank.rescorers)
            self.tree_bucket = tree_bucket or bucket_for(
                1 + draft_k + tree_top_k * tree_expansions + extra)
        # the draft's layers: the kept ones (slice exec) on a homogeneous
        # stack, else the gate vector (mask exec) — the same numbers. The
        # gates are fixed at build and read on the host per layer, so they
        # stay a host tensor, which a captured round reads without a sync
        self._gates = self._layer_ids = None
        if draft_spec is not None:
            gates = draft_spec.gates_array(cfg.num_layers)
            segs = M.layout(cfg)
            if len(segs) == 1 and len(segs[0].unit) == 1:
                self._layer_ids = [int(i) for i in np.flatnonzero(gates > 0)]
            else:
                self._gates = torch.as_tensor(gates)

        self.pld = PromptLookup(max_draft=draft_k)
        self.acceptance = AcceptanceTracker()
        self.costs = CostTracker()
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.cache = M.init_cache(cfg, max_batch, max_len, dtype=getattr(torch, cfg.dtype),
                                  paged=self.paged, page_size=self.page_size,
                                  num_pages=num_pages, device=self.device, mesh=mesh)
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
        self._last_limit = np.zeros(max_batch, np.int32)  # split-round budgets
        # the host registry is always on: it backs ``stats``. ``telemetry``
        # gates only the device buffer, which single rounds add to; host-read
        # rounds (split, legacy, cascade) tally into the numpy twin
        self.telemetry = bool(telemetry)
        self.metrics = metrics if metrics is not None else TM.MetricsRegistry()
        self.stats = TM.StatsView(self.metrics)
        budget_max = draft_k if mode in ("chain_fused", "legacy") else tree_expansions
        self._telem_schema = TM.telemetry_schema(
            max_batch, budget_max, levels=len(self.bank) if self.bank is not None else 0)
        self._telem_host = TM.init_host_telemetry(self._telem_schema)
        self._telem_seen = TM.init_host_telemetry(self._telem_schema)
        self._telem_dev = (TM.init_device_telemetry(
            TM.telemetry_schema(self._bl, budget_max,
                                levels=len(self.bank) if self.bank is not None else 0),
            self.device) if self.telemetry else None)
        # the drained ring rows folded into the same schema (single rounds)
        self.ring_totals = TM.init_host_telemetry(self._telem_schema)

        # carried device state of the single round: pending/live, the PLD
        # context buffer and the per-slot Eq. 4 estimator, at the draft's
        # cold-start prior; c is the draft's prior cost (no wall clock)
        dev = self.device
        prior0 = float(draft_spec.prior_alpha) if draft_spec else 0.5
        Bl = self._bl
        alpha, hist, hist_n, hist_ptr = ema_init(Bl, prior=prior0, device=dev)
        self.dstate = {"pending": torch.zeros((Bl,), dtype=torch.int32, device=dev),
                       "live": torch.zeros((Bl,), dtype=torch.bool, device=dev),
                       "ctx": torch.zeros((Bl, max_len), dtype=torch.int32, device=dev),
                       "alpha": alpha, "hist": hist, "hist_n": hist_n, "hist_ptr": hist_ptr}
        if sampling is not None:
            # per-slot warp parameters and threefry keys, carried into the rounds
            self.dstate.update(temp=torch.zeros((Bl,), dtype=torch.float32, device=dev),
                               topk=torch.zeros((Bl,), dtype=torch.int32, device=dev),
                               topp=torch.ones((Bl,), dtype=torch.float32, device=dev),
                               key=torch.zeros((Bl, 2), dtype=torch.int64, device=dev))
        if self.prefill_chunk:
            # prompt tokens committed so far and prompt length, per slot; a
            # slot with pf_done < pf_len is still prefilling
            self.dstate.update(pf_done=torch.zeros((Bl,), dtype=torch.int32, device=dev),
                               pf_len=torch.zeros((Bl,), dtype=torch.int32, device=dev))
        self._prior_alpha = prior0
        c0 = float(draft_spec.prior_c) if draft_spec else 0.5
        self._c_dev = torch.tensor(max(c0, 1e-3), dtype=torch.float32, device=dev)
        # undrained rounds' facts, one row per round: accepted tokens, then
        # the _RING_FACTS columns; _ring_at is the next row, on the device
        width = (self.tree_bucket or draft_k + 1) + len(_RING_FACTS)
        self._ring = torch.zeros((self.sync_every, Bl, width), dtype=torch.int32,
                                 device=dev)
        self._ring_at = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._inflight = 0
        self._out_buf: Dict[int, List[int]] = {}
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        self._graph: Optional[CondGraph] = None
        self._graph_mid: dict = {}
        # kernel launches of each captured segment, of the segments every
        # launch runs, and all that the graph's launches ran (the gated
        # segments' counted at the drain, for the rounds whose predicate held)
        self.segment_launches: Dict[str, Dict[str, int]] = {}
        self.replay_launches: Dict[str, int] = {}
        self.graph_launches: Dict[str, int] = {}
        self.capture_s = 0.0
        # the capture's memory: the pool it reserved, in all and by segment
        # (the caching allocator's splits can reserve more than the peak),
        # and what it left allocated (held against a second cache copy; the
        # first capture of a process also leaves cuBLAS's workspace for the
        # capture stream)
        self.graph_pool_bytes = self.graph_live_bytes = 0
        self.segment_pool_bytes: Dict[str, int] = {}
        self.capture_ptrs: Dict[str, Tuple[int, int]] = {}
        self._prologue_fn = self._draft_fn = self._tail_fn = None
        sampled = sampling is not None
        if self.round_mode == "single":
            use_draft = draft_spec is not None
            kw = dict(use_draft=use_draft, adaptive=adaptive, min_obs=min_obs, t_min=float(t_min),
                      max_ngram=self.pld.max_ngram, min_ngram=self.pld.min_ngram)
            draft_kw = dict(gates=self._gates, layer_ids=self._layer_ids, draft_kv=draft_kv)
            if mode == "chain_fused":
                self._prologue_fn = functools.partial(chain_prologue, draft_k=draft_k, **kw)
                if use_draft:
                    self._draft_fn = functools.partial(chain_draft, cfg, draft_k=draft_k,
                                                       **draft_kw)
                self._tail_fn = functools.partial(chain_tail, cfg, sampled=sampled)
            else:
                self._prologue_fn = functools.partial(
                    tree_prologue, draft_k=draft_k, expansions=tree_expansions,
                    bucket=self.tree_bucket, pld_alpha=float(PLD_SPEC.prior_alpha), **kw)
                if use_draft and tree_expansions > 0:
                    self._draft_fn = functools.partial(
                        tree_draft, cfg, c=self._c_dev, expansions=tree_expansions,
                        top_k=tree_top_k, top_p=tree_top_p, t_min=float(t_min), **draft_kw)
                self._tail_fn = functools.partial(tree_tail, cfg, sampled=sampled)
            if dev.type == "cuda":
                self._capture()

    # ------------------------------------------------------------ admission
    @_on_mesh
    def add_request(self, slot: int, prompt: np.ndarray,
                    sampling: Optional[SamplingParams] = None,
                    max_new_tokens: Optional[int] = None) -> None:
        """Prefill one prompt into a batch slot. On a paged build,
        ``max_new_tokens`` bounds the slot's pages to prompt + budget + the
        overshoot of the rounds in flight instead of ``max_len``; dense
        builds ignore it. On a ``prefill_chunk`` build admission only
        enqueues the prompt: the next rounds prefill it in chunks. Single
        rounds in flight are drained first, and tokens the slot's previous
        request left undrawn are dropped and counted
        (``serve_discarded_tokens_total``): call ``flush()`` before
        re-binding a slot to collect them (``ServeLoop`` does).

        ``sampling`` overrides the build's ``SamplingParams`` for this
        request. A greedy build refuses a stochastic request and accepts a
        ``temperature=0`` one. On a sampled build the request's key is
        ``prng_key(seed)``, or ``fold_in(base key, admission count)`` when
        it brings no seed, and its first token is drawn here, on the host,
        from the warped prefill row with a uniform of the key's split, as
        the reference draws it (a chunked build binds the key unsplit: the
        round that completes the prompt draws it)."""
        if sampling is not None and not sampling.greedy and self.sampling is None:
            raise ValueError(
                "stochastic per-request sampling requires a sampled server build — construct "
                "BatchedSpecServer(..., sampling=SamplingParams(...)); this greedy build runs "
                "only the greedy rounds")
        self._drain()
        dropped = self._out_buf.pop(slot, None)
        if dropped:
            # tokens of the slot's previous binding that nobody collected:
            # counted, so that the telemetry reconciles with routed streams
            self.metrics.counter("serve_discarded_tokens_total").inc(len(dropped))
        prompt = np.asarray(prompt, np.int32)
        table_row = None
        if self.paged:
            alloc = (self.max_len if max_new_tokens is None
                     else min(self.max_len, len(prompt) + int(max_new_tokens) + self._alloc_slack()))
            table_row = self._alloc_pages(slot, alloc)
            if self._local(slot) is not None:
                self.cache["page_table"][self._local(slot)] = torch.as_tensor(table_row,
                                                                              device=self.device)
        eff = sampling if sampling is not None else self.sampling
        key = None
        if self.sampling is not None:
            key = (prng.prng_key(eff.seed) if eff.seed is not None
                   else prng.fold_in(self._base_key, self._admit_seq))
            self._admit_seq += 1
            if not eff.greedy:
                self.metrics.counter("serve_sampled_requests_total").inc()
        if self.prefill_chunk:
            # enqueue only: pos 0, the prompt parked in ctx, pf_* armed. The
            # prompt's first token is a safe pending: the round prologue
            # writes pending at ctx[pos], which leaves the prompt as it is
            self._bind_slot(slot, prompt, int(prompt[0]), eff, key)
            loc = self._local(slot)
            if loc is not None:
                self.cache["pos"][loc] = 0
                self.dstate["pf_done"][loc] = 0
                self.dstate["pf_len"][loc] = len(prompt)
            self.pending[slot] = int(prompt[-1])     # unknown until the prompt is prefilled
            return
        # prefill at the prompt's power-of-two bucket, not max_len: positions
        # past the prompt stay invisible through kv_pos masking
        bucket = min(_prefill_bucket(len(prompt)), self.max_len)
        loc = self._local(slot)
        if loc is not None:
            # the ranks that hold the slot prefill it (a B=1 cache: nothing
            # per-slot to gather inside)
            with SU.use_mesh(self.mesh):
                c1 = M.init_cache(self.cfg, 1, bucket, dtype=getattr(torch, self.cfg.dtype),
                                  device=self.device, mesh=self.mesh)
                last, c1 = M.prefill(self.cfg, self.params,
                                     {"tokens": torch.as_tensor(prompt[None], device=self.device)},
                                     c1)
                M.write_slot(self.cfg, self.cache, c1, loc)  # in place
            last = last[0]
        else:
            last = torch.zeros((self.cfg.padded_vocab,), dtype=torch.float32, device=self.device)
        if self._bshard:
            # the owner's prefill row on every data rank: a sum into zeros
            last = SU.all_sum(last, SU.DATA_AXES)
        if key is None:
            first = last.argmax()
        else:
            # the key's first split is the round stream, its second half
            # draws the first token by the rounds' inverse-CDF rule
            key, sub = prng.split(key, 2)
            u0 = float(prng.uniform(sub, 1)[0])
            cum = np.cumsum(warp_probs(last.cpu().numpy(), eff.temperature, eff.top_k,
                                       eff.top_p))
            first = int(np.argmax(cum > u0 * cum[-1]))
        self._bind_slot(slot, prompt, first, eff, key)
        self.pending[slot] = int(first)

    def _bind_slot(self, slot: int, prompt: np.ndarray, pending,
                   sampling: Optional[SamplingParams], key: Optional[torch.Tensor]) -> None:
        """The slot's row of the carried state, in place: its pending token,
        its context buffer, a fresh estimator at the draft's prior and, on a
        sampled build, its warp parameters and key (on the ranks that hold
        the slot); and the host mirrors."""
        self.contexts[slot] = [int(t) for t in prompt]
        self.live[slot] = True
        # the slot's estimator restarts from the draft's cold-start prior:
        # continuous batching reuses slots across unrelated requests
        prior = self.draft_spec.prior_alpha if self.draft_spec else 0.5
        self.acceptance.reset(self._slot_key(slot), alpha0=prior)
        if self.bank is not None:
            for i in range(len(self.bank)):
                self.acceptance.reset(self.bank.slot_key(i, slot), alpha0=self.bank.alpha_prior(i))
            self.acceptance.reset(self.bank.direct_key(slot), alpha0=self.bank.direct_prior())
        slot = self._local(slot)
        if slot is None:
            return
        ds = self.dstate
        ds["pending"][slot] = pending
        if key is not None:
            ds["temp"][slot] = max(sampling.temperature, 0.0)
            ds["topk"][slot] = sampling.top_k
            ds["topp"][slot] = sampling.top_p
            ds["key"][slot] = key.to(self.device)
        ds["live"][slot] = True
        row = np.zeros(self.max_len, np.int32)
        row[: len(prompt)] = prompt
        ds["ctx"][slot] = torch.as_tensor(row, device=self.device)
        ds["alpha"][slot] = self._prior_alpha
        for name in ("hist", "hist_n", "hist_ptr"):
            ds[name][slot] = 0

    def _local(self, slot: int) -> Optional[int]:
        """The row of global slot ``slot`` in this rank's per-slot state, or
        None where another data rank holds it."""
        with SU.use_mesh(self.mesh, batch_sharded=self._bshard):
            return SU.owns_row(slot, self.B)

    # -------------------------------------------------- page pool (paged)
    def _alloc_slack(self) -> int:
        """Commit overshoot past ``max_new_tokens``: the rounds in flight
        when the finish is observed keep committing."""
        per_round = self.tree_bucket or (self.k + 1)
        return (self.sync_every + 1) * per_round

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
        self.metrics.gauge("serve_free_pages").set(len(self._free_pages))
        row = np.full(self._pages_per_slot, -1, np.int32)
        row[:need] = pages
        return row

    def _free_slot_pages(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._free_pages.extend(pages)
            self.metrics.gauge("serve_free_pages").set(len(self._free_pages))

    @_on_mesh
    def release(self, slot: int) -> None:
        """Mark a slot free (its request finished or was cancelled). Its
        ``pos`` drops to 0 and, on a paged build, its pages go back to the
        pool and its table row to -1, so that the live prefix every later
        call scans (``max(pos)`` over the batch) forgets the request. All in
        place and in stream order: rounds in flight are not waited for."""
        self.live[slot] = False
        if self.paged:
            self._free_slot_pages(slot)
        slot = self._local(slot)
        if slot is None:
            return
        self.dstate["live"][slot] = False
        self.cache["pos"][slot] = 0
        if self.prefill_chunk:       # a request cancelled mid-prefill stops prefilling
            self.dstate["pf_done"][slot] = 0
            self.dstate["pf_len"][slot] = 0
        if self.paged:
            self.cache["page_table"][slot] = -1

    def _slot_key(self, slot: int) -> str:
        return f"chain:{slot}"

    # ----------------------------------------------------- adaptive budgets
    def _slot_limit(self, slot: int) -> int:
        """Neural chain draft budget for a slot this round (PLD is never
        capped). Single rounds compute it on the device; this is then an
        inspection mirror of that computation over ``dstate``."""
        if self.draft_spec is None:
            return 0
        if self.round_mode == "single":
            hist_n, alpha = self._state_row("hist_n", slot), self._state_row("alpha", slot)
            if not self.adaptive or int(hist_n) < self.min_obs:
                return self.k
            return best_chain_length(float(alpha), float(self._c_dev), self.k, self.t_min)
        key = self._slot_key(slot)
        if not self.adaptive or self.acceptance.counts(key) < self.min_obs:
            return self.k
        c = self.costs.c_hat("chain_draft", default=float(self.draft_spec.prior_c))
        return best_chain_length(self.acceptance.alpha(key), max(c, 1e-3), self.k, self.t_min)

    def _slot_tree_budget(self, slot: int) -> int:
        """Tree expansion budget for a slot this round (Eq. 5 objective);
        in single mode an inspection mirror of the device's, as above."""
        if self.draft_spec is None:
            return 0
        if self.round_mode == "single":
            hist_n, alpha = self._state_row("hist_n", slot), self._state_row("alpha", slot)
            if not self.adaptive or int(hist_n) < self.min_obs:
                return self.tree_expansions
            return best_tree_expansions(float(alpha), float(self._c_dev), self.tree_expansions,
                                        self.t_min)
        key = self._slot_key(slot)
        if not self.adaptive or self.acceptance.counts(key) < self.min_obs:
            return self.tree_expansions
        c = self.costs.c_hat("tree_draft", default=float(self.draft_spec.prior_c))
        return best_tree_expansions(self.acceptance.alpha(key), max(c, 1e-3),
                                    self.tree_expansions, self.t_min)

    @_on_mesh
    def _state_row(self, name: str, slot: int):
        """Global slot ``slot``'s entry of ``dstate[name]`` (its rows gathered
        over the data axes where they are sharded)."""
        return SU.host(self.dstate[name])[slot]

    # ----------------------------------------------------- dispatch counts
    def expected_dispatches_per_round(self) -> int:
        """Model dispatches of a fully drafting steady-state round, the
        claim ``stats`` (``round_dispatches``, ``draft_dispatches``,
        ``rescore_dispatches``, ``target_calls``) is held to:

        single:  1 (the round's graph launch)
        split:   2 (draft scan + verify), 1 with no neural drafter
        legacy:  draft_k decode dispatches + 1 verify
        cascade: L = 1 drafting scan + (L-1) rescores, the target verify in
                 the last rescore; a 1-level bank is drafting scan + verify.
        """
        if self.round_mode == "single":
            return 1
        if self.mode == "legacy":
            return (self.k if self.draft_spec is not None else 0) + 1
        if self.mode == "cascade_fused":
            return max(len(self.bank), 2)
        return 2 if self.draft_spec is not None else 1

    # ------------------------------------------------------------- stepping
    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        """A per-slot host array's rows of this rank on the device."""
        t = torch.as_tensor(SU.local_rows(np.asarray(a)), device=self.device)
        return t if dtype is None else t.to(dtype)

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
        self._last_limit = limit.copy()
        if self.draft_spec is None:
            return chains, have
        if self.mode == "legacy":
            return self._propose_legacy(chains, have, limit)
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
        chains, have = SU.host(ch_d), SU.host(hv_d)
        dt = self._elapsed(t0)
        self._count_draft(dt)
        self.stats["drafted_tokens"] += steps
        # per-draft-step latency -> c_hat = draft step / verify round
        self.costs.observe("chain_draft", dt, tokens=steps)
        return chains, have

    def _elapsed(self, t0: float) -> float:
        """Wall seconds since ``t0``: what the split rounds' cost trackers
        observe. On a mesh the MAX over every rank, so that each rank's host
        plans (budgets, routing) from the same numbers."""
        return SU.host_max(time.perf_counter() - t0)

    def _count_draft(self, dt: float) -> None:
        """One drafting dispatch and its host read."""
        self.stats["draft_dispatches"] += 1
        self.stats["draft_time"] += dt
        self.stats["host_syncs"] += 1
        self.stats["device_wait"] += dt

    def _count_verify(self, dt: float) -> None:
        """One target dispatch and its host read; its wall time prices the
        target round."""
        self.stats["target_calls"] += 1
        self.stats["verify_time"] += dt
        self.stats["host_syncs"] += 1
        self.stats["device_wait"] += dt
        self.costs.observe_target(dt, tokens=1)

    def _propose_legacy(self, chains, have, limit):
        """The per-step baseline: one decode of [pending, chain[:j]] per draft
        position j (causal, the draft's layers), its argmax read on the host
        after each."""
        need = self.live & (limit > have)
        if not need.any():
            return chains, have
        lo, hi = int(have[need].min()), int(limit[need].max())
        for j in range(lo, hi):
            toks = np.concatenate([self.pending[:, None], chains[:, :j]], axis=1)
            t0 = time.perf_counter()
            logits, _ = M.decode_step(self.cfg, self.params, self.cache, self._dev(toks),
                                      gates=self._gates, layer_ids=self._layer_ids)
            nxt = SU.host(logits[:, -1].argmax(dim=-1))
            self._count_draft(self._elapsed(t0))
            fill = (have <= j) & (j < limit)
            chains[fill, j] = nxt[fill]
            have = np.maximum(have, np.where(fill, j + 1, have)).astype(np.int32)
        return chains, have

    @_on_mesh
    def step(self) -> Dict[int, List[int]]:
        """One speculative round for the whole batch; returns the accepted
        tokens per live slot (single rounds: the tokens drained so far,
        possibly from earlier rounds, possibly none between drains)."""
        if self.round_mode == "single":
            return self._step_single()
        if self.mode == "tree_fused":
            return self._step_tree()
        if self.mode == "cascade_fused":
            return self._step_cascade()
        chains, have = self._propose()
        t0 = time.perf_counter()
        args = (self.cfg, self.params, self.cache, self._dev(self.pending), self._dev(chains),
                self._dev(have), self._dev(self.live, torch.bool))
        if self.sampling is not None:
            # the keys split on the device into this verify's k + 1 uniforms
            ds = self.dstate
            keys, u = round_uniforms(ds["key"], self.k + 1)
            _, n_chain, new_pending = verify_accept_commit_sampled(  # commits in place
                *args, ds["temp"], ds["topk"], ds["topp"], u)
            ds["key"].copy_(keys)
        else:
            _, _, n_chain, new_pending = verify_accept_commit(*args)  # commits in place
        n_chain, new_pending = SU.host(n_chain), SU.host(new_pending)
        self._count_verify(self._elapsed(t0))

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
        self._host_round_telemetry(n_chain + 1, np.maximum(have - self._pld_have, 0),
                                   self._pld_have, self._last_limit)
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
            self._dev(a, None) for a in seed)
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
                SU.host(a) for a in (d_tokens, d_parents, d_count, d_first))
            dt = self._elapsed(t0)
            self._count_draft(dt)
            self.stats["drafted_tokens"] += int(np.clip(count - have - 1, 0, None).sum())
            # per-expansion-step latency -> the c in the Eq. 5 budgets
            self.costs.observe("tree_draft", dt, tokens=expansions)

        t0 = time.perf_counter()
        _, path, n_acc, bonus = self._tree_verify(  # commits in place
            d_tokens, d_parents, d_depth, d_mask, d_count, self._dev(self.live, torch.bool))
        self._count_verify(self._elapsed(t0))

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
        self._host_round_telemetry(n_acc, np.clip(count - have - 1, 0, None), have, limits)
        self.pending = np.where(self.live, bonus.astype(np.int64), self.pending)
        self.stats["steps"] += 1
        return out_toks

    # --------------------------------------------------------- cascade round
    def _slot_cascade_plan(self, b: int):
        """Eq. 5 routing and budget of one slot: ``(expansions, use_rescore,
        alpha_eff, rescorer_alphas)``. A slot whose trackers say the cascade
        does not pay drafts single-level (no rescores) or with PLD alone."""
        bank = self.bank
        L = len(bank)
        alphas = [self.acceptance.alpha(bank.slot_key(i, b), default=bank.alpha_prior(i))
                  for i in range(L)]
        cs = [max(self.costs.c_hat(bank.cost_key(i), default=bank.c_prior(i)), 1e-3)
              for i in range(L - 1)]
        cs.append(max(self.costs.c_hat("cascade_draft", default=bank.c_prior(L - 1)), 1e-3))
        alpha_eff = float(np.prod(alphas))
        # warm-up counts the keys this slot's rounds feed: rescored rounds
        # observe slot_key(0), single-level rounds direct_key
        warm = self.acceptance.counts(bank.slot_key(0, b)) + self.acceptance.counts(bank.direct_key(b))
        if not self.adaptive or warm < self.min_obs:
            return self.tree_expansions, L > 1, alpha_eff, alphas[: L - 1]
        a_dir = self.acceptance.alpha(bank.direct_key(b), default=bank.direct_prior())
        exp, use_rescore = best_cascade_plan(alphas, cs, a_dir, self.tree_expansions, self.t_min)
        use_rescore = use_rescore and L > 1
        if not use_rescore:
            # a single-level round's stop rule uses the alpha its plan chose
            alpha_eff = a_dir
        return exp, use_rescore, alpha_eff, alphas[: L - 1]

    def _step_cascade(self) -> Dict[int, List[int]]:
        """One multi-level cascade round for the whole batch (Alg. 1 over the
        §4.1 hierarchy): PLD-seeded trees, one drafting scan by the cheapest
        level, one rescore dispatch per stronger level (none when no slot is
        routed through them), the last one with the target verify and
        commit folded in. Returns the accepted tokens per live slot."""
        bank = self.bank
        L = len(bank)
        chains, have = self._pld_chains()
        exp_b = np.zeros(self.B, np.int32)
        use_rescore = np.zeros(self.B, bool)
        alpha_eff = np.full(self.B, 0.5, np.float32)
        resc_alphas = np.full((max(L - 1, 1), self.B), 0.5, np.float32)
        for b in range(self.B):
            if self.live[b]:
                exp_b[b], use_rescore[b], alpha_eff[b], r_alphas = self._slot_cascade_plan(b)
                resc_alphas[: len(r_alphas), b] = r_alphas
        seed = tree_seed_arrays(self.pending.astype(np.int32), chains, have, self.tree_bucket,
                                pld_alpha=bank.pld.prior_alpha)
        tree = [self._dev(a, None) for a in seed]
        first_neural = np.full(self.B, -1, np.int32)
        expansions = int(exp_b.max(initial=0))
        if expansions > 0:
            drafter = bank.drafter
            c = self.costs.c_hat("cascade_draft", default=bank.c_prior(L - 1))
            t0 = time.perf_counter()
            out = tree_draft_scan(
                self.cfg, expansions, self.tree_top_k, drafter.params, self.cache, *tree,
                self._dev(exp_b), self._dev(alpha_eff, torch.float32),
                torch.tensor(max(c, 1e-3), dtype=torch.float32, device=self.device),
                torch.tensor(self.t_min, dtype=torch.float32, device=self.device),
                self._level_gates(drafter), top_p=self.tree_top_p, draft_kv=self.draft_kv,
                layer_ids=drafter.layer_ids, quantize=drafter.quantize,
                attn_override=drafter.attn_override)
            tree, first_neural = list(out[:6]), SU.host(out[6])
            dt = self._elapsed(t0)
            self._count_draft(dt)
            self.stats["drafted_tokens"] += int(np.clip(SU.host(tree[5]) - have - 1, 0,
                                                        None).sum())
            self.costs.observe("cascade_draft", dt, tokens=expansions)

        # the stronger levels, just above the drafter first: each one
        # dispatch; the probe carries each level's first own prediction to
        # the next level's Eq. 4 verdict; the strongest carries the verify
        live = self._dev(self.live, torch.bool)
        level_node = np.full(self.B, -1, np.int32)
        rescored_round = bool(use_rescore.any())
        # sampled builds thread the slot keys through every rescore: each
        # splits its own uniforms on the device and hands the advanced keys on
        ds = self.dstate
        warp = keys = None
        if self.sampling is not None:
            warp, keys = (ds["temp"], ds["topk"], ds["topp"]), ds["key"]
        if rescored_round:
            apply = self._dev(use_rescore & self.live, torch.bool)
            probe = self._dev(first_neural)
            for lvl in bank.rescorers:
                r = lvl.index
                last = lvl is bank.rescorers[-1]
                args = (*tree, probe, apply, self._dev(resc_alphas[r], torch.float32),
                        self._level_gates(lvl))
                kw = dict(layer_ids=lvl.layer_ids, quantize=lvl.quantize,
                          attn_override=lvl.attn_override)
                t0 = time.perf_counter()
                if last:
                    sampling = None if warp is None else (*warp, keys)
                    out = cascade_rescore_verify(self.cfg, lvl.params, self.params, self.cache,
                                                 *args, live, sampling=sampling, **kw)
                    path, n_acc, bonus = out[10:13]  # out[9], the cache, in place
                    keys = out[13] if warp is not None else None
                else:
                    sampling = None
                    if warp is not None:
                        keys, u = round_uniforms(keys, self.tree_bucket + 2)
                        sampling = (*warp, u)
                    out = cascade_rescore(self.cfg, lvl.params, self.cache, *args,
                                          sampling=sampling, **kw)
                tree, probe = list(out[:6]), out[6]
                pv, pk = SU.host(out[8]), SU.host(out[7])
                dt = self._elapsed(t0)
                self.stats["rescore_dispatches"] += 1
                if last:
                    # the dispatch holds the target verify: its wall time
                    # prices the target round (the level's own c keeps its prior)
                    self._count_verify(dt)
                else:
                    self.stats["rescore_time"] += dt
                    self.stats["host_syncs"] += 1
                    self.stats["device_wait"] += dt
                    self.costs.observe(bank.cost_key(r), dt, tokens=1)
                self._telem_host["casc_obs"][r + 1] += pv.astype(np.int32)
                self._telem_host["casc_accept"][r + 1] += (pv & pk).astype(np.int32)
                # Eq. 4: this level's verdict on level r+1's first token
                for b in np.flatnonzero(pv):
                    self.acceptance.observe(bank.slot_key(r + 1, b), bool(pk[b]))
            level_node = SU.host(probe)
        else:
            t0 = time.perf_counter()
            _, path, n_acc, bonus = self._tree_verify(tree[0], tree[1], tree[2], tree[4], tree[5],
                                                      live)  # commits in place
            self._count_verify(self._elapsed(t0))
        if warp is not None and rescored_round:
            ds["key"].copy_(keys)

        tokens, parents = SU.host(tree[0]), SU.host(tree[1])
        # the verify already read its verdict to the host (the port's
        # ``tree_verify_accept_commit_host``): the round's per-slot tallies
        # and routing rows go to the host twin, with no device copy
        self._host_round_telemetry(n_acc, np.clip(SU.host(tree[5]) - have - 1, 0, None),
                                   have, exp_b)
        routed = (use_rescore & self.live).astype(np.int32)
        for lv in bank.rescorers:
            self._telem_host["casc_routed"][lv.index] += routed
        self._telem_host["casc_routed"][bank.drafter.index] += (
            (exp_b > 0) & self.live).astype(np.int32)
        out_toks: Dict[int, List[int]] = {}
        for b in range(self.B):
            if not self.live[b]:
                continue
            nodes = path[b, : n_acc[b]]
            acc = [int(tokens[b, i]) for i in nodes]
            self.contexts[b].extend(acc)
            out_toks[b] = acc
            self.stats["tokens"] += len(acc)
            node_set = {int(i) for i in nodes}
            # Eq. 4, target-facing (parent-accepted rule): on cascade rounds
            # at the strongest level's own node; on single-level rounds at
            # the drafter's first prediction, under the direct tracker
            fn = int(level_node[b] if use_rescore[b] else first_neural[b])
            if fn < 0 or int(parents[b, fn]) not in node_set:
                continue
            if not use_rescore[b]:
                self.acceptance.observe(bank.direct_key(b), fn in node_set)
            if use_rescore[b] or L == 1:
                # the target-facing verdict (a 1-level bank's direct
                # acceptance is its level-0 alpha): row 0 of the cascade
                # tallies, always on the host
                self.acceptance.observe(bank.slot_key(0, b), fn in node_set)
                self._telem_host["casc_obs"][0, b] += 1
                self._telem_host["casc_accept"][0, b] += int(fn in node_set)
        self.pending = np.where(self.live, bonus.astype(np.int64), self.pending)
        self.stats["steps"] += 1
        return out_toks

    def _tree_verify(self, tokens, parents, depth, mask, count, live):
        """The split rounds' tree verify and commit: the greedy host walk, or
        on a sampled build the stochastic walk on uniforms split from the
        carried keys (one per node of the bucket). Returns (path, n_acc,
        bonus) as numpy arrays after the new cache."""
        args = (self.cfg, self.params, self.cache, tokens, parents, depth, mask, count, live)
        if self.sampling is None:
            return tree_verify_accept_commit_host(*args)
        ds = self.dstate
        keys, u = round_uniforms(ds["key"], tokens.shape[1])
        cache, *walk = tree_verify_accept_commit_sampled(*args, ds["temp"], ds["topk"],
                                                         ds["topp"], u)
        ds["key"].copy_(keys)
        return (cache, *(SU.host(a) for a in walk))

    def _level_gates(self, lvl) -> Optional[torch.Tensor]:
        """A bank level's gate vector on the host (mask exec), or None."""
        g = lvl.exec_gates
        return None if g is None else torch.as_tensor(g)

    # ------------------------------------------------------ single rounds
    def _plan(self):
        """The single round's segments, in order: (name, function of the
        round's intermediate tensors ``mid``, predicate). A segment with a
        predicate (the name of a () bool in ``mid``) runs only when it
        holds: behind a conditional node of the captured graph, the
        reference's ``lax.cond``. An eager round runs it masked, where it
        changes nothing when the predicate is false."""
        plan = []
        if self.prefill_chunk:
            plan += [("prefill_pred", self._seg_prefill_pred, None),
                     ("prefill", self._seg_prefill, "pf_any")]
        plan.append(("prologue", self._seg_prologue, None))
        if self._draft_fn is not None:
            plan.append(("draft", self._seg_draft, "ran"))
        plan.append(("tail", self._seg_tail, None))
        return plan

    def _state(self, mid: dict) -> dict:
        """The carried state as the decode half sees it: slots still
        prefilling are dead there (their own ``live`` stays)."""
        return dict(self.dstate, live=mid["live"]) if "live" in mid else self.dstate

    def _seg_prefill_pred(self, mid: dict) -> None:
        mid["pf_any"] = SU.any_over_data((self.dstate["pf_done"] < self.dstate["pf_len"]).any())

    def _seg_prefill(self, mid: dict) -> None:
        prefill_chunk_stage(self.cfg, self.params, self.cache, self.dstate,
                            chunk=self.prefill_chunk, sampled=self.sampling is not None)

    def _seg_prologue(self, mid: dict) -> None:
        if self.prefill_chunk:
            ds = self.dstate
            mid["live"] = ds["live"] & (ds["pf_done"] >= ds["pf_len"])
        mid.update(self._prologue_fn(self.cache, self._state(mid), self._c_dev))

    def _seg_draft(self, mid: dict) -> None:
        self._draft_fn(self.params, self.cache, self._state(mid), mid)

    def _seg_tail(self, mid: dict) -> None:
        """Verify and commit, every write in place: the cache
        (``commit_cache``), ``dstate`` and the round's row of the output
        ring."""
        state = self._state(mid)
        new, out = self._tail_fn(self.params, self.cache, state, mid)
        if self._telem_dev is not None:
            # the decode half's live: a slot still prefilling gets no round
            TM.accumulate_round(self._telem_dev, out, state["live"])
        for name, value in new.items():
            self.dstate[name].copy_(value)
        out["prefilled"] = mid.get("pf_any", self._false)
        facts = torch.stack([out[k].to(torch.int32).expand(self._bl) for k in _RING_FACTS], dim=1)
        row = torch.cat([out["acc"].to(torch.int32), facts], dim=1)
        self._ring.index_copy_(0, self._ring_at, row[None])
        self._ring_at += 1              # the host drains before the ring is full

    def _round(self) -> None:
        """One single round, eagerly, every segment (gated ones masked);
        reads nothing on the host."""
        mid: dict = {}
        for _, fn, _ in self._plan():
            fn(mid)

    def _capture(self) -> None:
        """Capture the round at build, with every slot dead, as one graph
        per segment (``CUDAGraph(keep_graph=True)``, one memory pool, in
        the order they run), and assemble them into one graph with each
        gated segment behind an IF node (``kernels.graph_cond``). A dead
        round changes nothing but ``ctx[b, 0]`` of dead rows, which
        admission overwrites. Warm-up rounds on a side stream first load the
        kernels and PyTorch's lazy state; a capture or an assembly that
        fails raises."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._round()
                self._ring_at.zero_()
                if self._telem_dev is not None:
                    self._telem_dev.zero_()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()        # as the capture does first: its pool is the growth
        reserved, allocated = torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        mid, steps, pool = self._graph_mid, [], None
        for name, fn, pred in self._plan():
            before, grown = launch_counts(), torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # port: noqa-PORT003: once a segment
            with torch.cuda.graph(graph, pool=pool):  # port: noqa-PORT003: at build, once a segment
                fn(mid)
            pool = graph.pool() if pool is None else pool
            self.segment_pool_bytes[name] = torch.cuda.memory_reserved(dev) - grown
            self.segment_launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
            steps.append(("child", graph) if pred is None else ("if", mid[pred], graph))
        self._graph = CondGraph(steps, dev)
        torch.cuda.synchronize(dev)
        self.capture_s = self._elapsed(t0)
        self.capture_ptrs = self.state_ptrs()    # the storage the graph writes in place
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph_live_bytes = torch.cuda.memory_allocated(dev) - allocated
        self.replay_launches = {k: sum(self.segment_launches[name][k]
                                       for name, _, pred in self._plan() if pred is None)
                                for k in launch_counts()}
        self.graph_launches = {k: 0 for k in self.replay_launches}

    def state_ptrs(self) -> Dict[str, Tuple[int, int]]:
        """(``data_ptr``, bytes) of every tensor of the cache and
        ``dstate``, by path: the storage the captured graph reads and writes
        in place."""
        out: Dict[str, Tuple[int, int]] = {}
        stack: List[Tuple[str, object]] = [("cache", self.cache), ("dstate", self.dstate)]
        while stack:
            path, t = stack.pop()
            if isinstance(t, torch.Tensor):
                out[path] = (t.data_ptr(), t.numel() * t.element_size())
            elif isinstance(t, dict):
                stack.extend((f"{path}[{k!r}]", v) for k, v in t.items())
            elif isinstance(t, (list, tuple)):
                stack.extend((f"{path}[{i}]", v) for i, v in enumerate(t))
        return out

    def _step_single(self) -> Dict[int, List[int]]:
        if self._graph is not None:
            self._graph.launch()
            self.stats["graph_replays"] += 1
            for k, v in self.replay_launches.items():
                self.graph_launches[k] += v
        else:
            self._round()
        self._inflight += 1
        self.stats["steps"] += 1
        self.stats["round_dispatches"] += 1
        self.stats["target_calls"] += 1
        if self._inflight >= self.sync_every:
            return self.flush()
        out, self._out_buf = self._out_buf, {}     # drained out of band (admission)
        return out

    def _drain(self) -> None:
        """Read the ring of the rounds in flight (one host sync) and fold
        their accepted tokens into the output buffer, in round order."""
        if not self._inflight:
            return
        t0 = time.perf_counter()
        rows = SU.gather_rows(self._ring[: self._inflight], dim=1).cpu().numpy()
        self.stats["host_syncs"] += 1
        self.stats["device_wait"] += time.perf_counter() - t0
        self._inflight = 0
        self._ring_at.zero_()
        w = rows.shape[2] - len(_RING_FACTS)
        self._fold_ring(rows, w)
        for r in rows:
            facts = dict(zip(_RING_FACTS, r[:, w:].T))
            for stat, fact, seg in (("draft_rounds", "ran", "draft"),
                                    ("prefill_rounds", "prefilled", "prefill")):
                ran = int(facts[fact][0])
                self.stats[stat] += ran
                if ran and self._graph is not None:    # the gated segment ran in the replay
                    for k, v in self.segment_launches[seg].items():
                        self.graph_launches[k] += v
            for b in range(self.B):
                nb = int(facts["n_acc"][b])
                if nb:
                    self._out_buf.setdefault(b, []).extend(int(t) for t in r[b, :nb])
                    self.stats["tokens"] += nb

    def _fold_ring(self, rows: np.ndarray, w: int) -> None:
        """Fold drained ring rows (rounds, B, w + facts) into ``ring_totals``,
        the host twin of what the device buffer holds for single rounds (a
        slot is live in a round exactly when it accepted a token), and count
        their neural drafted tokens."""
        f = {k: rows[:, :, w + i] for i, k in enumerate(_RING_FACTS)}
        live = f["n_acc"] > 0
        rt = self.ring_totals
        rt["rounds"] += live.sum(0, dtype=np.int32)
        rt["accepted"] += f["n_acc"].sum(0, dtype=np.int32)
        rt["drafted"] += f["drafted"].sum(0, dtype=np.int32)
        rt["pld_tokens"] += f["pld_have"].sum(0, dtype=np.int32)
        rt["pld_hit_rounds"] += ((f["pld_have"] > 0) & live).sum(0, dtype=np.int32)
        K1 = rt["budget_hist"].shape[1]
        slots = np.broadcast_to(np.arange(self.B), live.shape)
        np.add.at(rt["budget_hist"], (slots, np.clip(f["budget"], 0, K1 - 1)),
                  live.astype(np.int32))
        self.stats["drafted_tokens"] += int(f["drafted"].sum())

    @_on_mesh
    def flush(self) -> Dict[int, List[int]]:
        """Drain the rounds in flight and the telemetry, and return the
        buffered tokens per slot. Split rounds return their tokens from
        ``step`` and leave nothing in flight; for them this is empty."""
        self._drain()
        self._drain_telemetry()
        out, self._out_buf = self._out_buf, {}
        return out

    # ------------------------------------------------------------ telemetry
    def _host_round_telemetry(self, n_acc, drafted, pld_have, budget) -> None:
        """Add one host-read round (split, ``legacy``, tree or cascade) to
        the numpy twin, from arrays the round already read."""
        th = self._telem_host
        li = self.live.astype(np.int32)
        th["rounds"] += li
        th["accepted"] += np.asarray(n_acc, np.int32) * li
        th["drafted"] += np.asarray(drafted, np.int32) * li
        th["pld_tokens"] += np.asarray(pld_have, np.int32) * li
        th["pld_hit_rounds"] += ((np.asarray(pld_have) > 0) & self.live).astype(np.int32)
        K1 = th["budget_hist"].shape[1]
        th["budget_hist"][np.arange(self.B), np.clip(np.asarray(budget), 0, K1 - 1)] += li

    def _drain_telemetry(self) -> None:
        """Fold the telemetry added since the last drain into the registry.
        Callers drained the ring first, so the buffer belongs to rounds
        already read: one copy, no new host sync. A single-round server's
        buffer must equal the fold of its drained ring rows."""
        if self._bshard:
            # the buffer's slot rows of every data rank (cascade rows carry
            # the slots on their second dim)
            totals = TM.merge_totals(None, self._telem_host)
            for k, v in self._telem_dev.items():
                totals[k] = totals[k] + SU.host(v, dim=1 if k.startswith("casc_") else 0)
        else:
            totals = TM.merge_totals(self._telem_dev, self._telem_host)
        if self._telem_dev is not None and self.round_mode == "single":
            bad = [k for k, v in self.ring_totals.items() if not np.array_equal(totals[k], v)]
            if bad:
                raise RuntimeError(f"round telemetry {bad} on the device differs from the "
                                   "drained ring rows")
        delta = {k: v - self._telem_seen[k] for k, v in totals.items()}
        self._telem_seen = totals
        TM.fold_telemetry(self.metrics, delta)

    @_on_mesh
    def telemetry_totals(self) -> Dict[str, np.ndarray]:
        """Cumulative drained telemetry (device buffer + host twin), keyed by
        the ``telemetry_schema`` names. Drains the rounds in flight first
        (their tokens stay buffered for the next ``flush``)."""
        self._drain()
        self._drain_telemetry()
        return {k: v.copy() for k, v in self._telem_seen.items()}

    @_on_mesh
    def metrics_summary(self) -> Dict[str, Any]:
        """A JSON-able end-of-run summary from the registry and the drained
        telemetry: tokens per step, dispatch and sync accounting and per-level
        cascade acceptance; the last line of ``launch/serve.py``."""
        tot = self.telemetry_totals()
        s = self.stats
        steps = max(s["steps"], 1)
        out: Dict[str, Any] = {
            "mode": self.mode,
            "round_mode": self.round_mode,
            "rounds": s["steps"],
            "tokens": s["tokens"],
            "tokens_per_step": s["tokens"] / steps,
            "round_dispatches": s["round_dispatches"],
            "host_syncs": s["host_syncs"],
            "device_wait_s": s["device_wait"],
            "rounds_per_slot": tot["rounds"].tolist(),
            "accepted_per_slot": tot["accepted"].tolist(),
            "drafted_per_slot": tot["drafted"].tolist(),
            "pld_tokens_per_slot": tot["pld_tokens"].tolist(),
        }
        # mean tokens committed per round, and the share of proposed (PLD +
        # neural) tokens the verify accepted; the pending token every round
        # emits is left out of the numerator
        out["sampled"] = self.sampling is not None
        rounds_t = float(tot["rounds"].sum())
        acc_t = float(tot["accepted"].sum())
        prop_t = float(tot["drafted"].sum() + tot["pld_tokens"].sum())
        out["accepted_per_round"] = acc_t / rounds_t if rounds_t else None
        out["spec_accept_rate"] = (acc_t - rounds_t) / prop_t if prop_t > 0 else None
        if "casc_obs" in tot:
            obs = tot["casc_obs"].sum(axis=1)
            acc = tot["casc_accept"].sum(axis=1)
            out["cascade_acceptance"] = [(float(a) / float(o) if o else None)
                                         for a, o in zip(acc.tolist(), obs.tolist())]
            out["cascade_routed_rounds"] = tot["casc_routed"].sum(axis=1).tolist()
        return out

