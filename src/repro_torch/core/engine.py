"""CAS-Spec single-sequence engine: DSIA draft execution + tree verification.

Execution modes for layer-gated drafts:
  - "slice": run only the kept layers (fewer FLOPs — the honest speed of a
    layer-sparse draft; requires a homogeneous layer stack).
  - "mask": run every layer with the gate vector (gated-off layers add
    nothing to the residual stream).

Cache discipline: drafts are STAGE-ONLY (never committed); only the full
target model's verification staged KV is committed, so the cache is always
exact — the losslessness invariant (see models.model).
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
