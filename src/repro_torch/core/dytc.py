"""Dynamic Tree Cascade (DyTC) — Algorithm 1 + 2 of CAS-Spec (§4.2); a copy of
the reference's host scheduler over the port's engine.

Per decoding round, grow a draft token tree:
  1. pick the active leaf with the highest accumulated acceptance P_acc
     (Alg. 1 line 5),
  2. pick (configuration, draft length k) maximizing the A*-style admissible
     objective Eq. 5 — local speedup + the *least future speedup* of ending
     with the bottom model (Alg. 2),
  3. expand: neural configs draft k tokens (top-K children per step, TOP-P
     filtered); VC(M_di, PLD) configs let PLD propose and M_di verify/extend
     in a single joint forward; PLD proposes retrieval chains,
  4. stop when P_acc·(alpha_dn/c_dn) < t_min or the tree is full,
then verify once with the target model (engine.verify_and_commit) and update
the EMA acceptance estimates from first-token outcomes (Eq. 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import verify as verify_lib
from repro_torch.core.dsia import DraftSpec, PLD_SPEC
from repro_torch.core.engine import SpecEngine, check_tree_stack
from repro_torch.core.ewif import best_dytc_k
from repro_torch.core.tree import DraftTree


@dataclasses.dataclass
class DyTCConfig:
    max_tree: int = 24               # M_tree_max
    k_max: int = 5                   # max draft length per expansion (paper: 5)
    t_min: float = 1.1               # min overall speedup threshold (paper: 1.1)
    top_k: int = 2                   # sibling candidates per step
    top_p: float = 0.3               # tree probability threshold P_tree
    max_expansions: int = 8
    token_level: bool = True         # §4.2 token-level P_acc refinement


@dataclasses.dataclass
class Candidate:
    """A scheduling configuration: single DSIA model or VC(model, PLD)."""
    name: str
    spec: Optional[DraftSpec]        # None for pure PLD
    vc_with_pld: bool = False


class DyTCScheduler:
    def __init__(
        self,
        engine: SpecEngine,
        hierarchy: Sequence[DraftSpec],
        cfg: Optional[DyTCConfig] = None,
    ):
        # DyTC grows branching trees: refused at the start of a run on a
        # stack with Mamba-2 blocks, not midway at its first branch
        check_tree_stack(engine.cfg, "DyTCScheduler")
        self.engine = engine
        self.cfg = cfg or DyTCConfig()
        self.bottom = next((s for s in hierarchy if s.kind == "retrieval"), PLD_SPEC)
        neural = [s for s in hierarchy if s.kind == "neural"]
        for s in hierarchy:
            engine.register_draft(s)
        self.candidates: List[Candidate] = []
        for s in neural:
            self.candidates.append(Candidate(name=s.name, spec=s))
            self.candidates.append(
                Candidate(name=f"VC({s.name},{self.bottom.name})", spec=s, vc_with_pld=True)
            )
            engine.acceptance.set_prior(f"VC({s.name},{self.bottom.name})", s.prior_alpha)
            engine.costs.set_prior(f"VC({s.name},{self.bottom.name})", s.prior_c)
        self.candidates.append(Candidate(name=self.bottom.name, spec=None))

    # ----------------------------------------------------------------- Alg. 2
    def find_best_configuration(
        self, pld_available: bool
    ) -> Tuple[Optional[Candidate], int, float]:
        acc, costs = self.engine.acceptance, self.engine.costs
        a_dn = acc.alpha(self.bottom.name)
        c_dn = max(costs.c_hat(self.bottom.name, self.bottom.prior_c), 1e-3)
        best: Tuple[Optional[Candidate], int, float] = (None, 0, -math.inf)
        for cand in self.candidates:
            if cand.spec is None and not pld_available:
                continue
            a = acc.alpha(cand.name)
            c = max(costs.c_hat(cand.name, 0.5), 1e-3)
            if cand.spec is None:
                c = c_dn
            val, k = best_dytc_k(a, c, a_dn, c_dn, self.cfg.k_max)
            if val > best[2]:
                best = (cand, k, val)
        if best[2] <= 0:
            return None, 0, best[2]
        return best

    # ----------------------------------------------------------- expansions
    def _chain_arrays(self, tree: DraftTree, leaf: int):
        path = tree.path_to(leaf)
        tokens = np.asarray([tree.tokens[i] for i in path], np.int32)
        rel = np.asarray([tree.depth[i] for i in path], np.int32)
        n = len(path)
        mask = np.tril(np.ones((n, n), bool))
        return path, tokens, rel, mask

    def _expand_neural(
        self, tree: DraftTree, leaf: int, cand: Candidate, k: int
    ) -> Optional[int]:
        """Draft k tokens with a DSIA model along a chain from ``leaf``.
        Returns the first added node (for acceptance bookkeeping)."""
        ecfg = self.cfg
        alpha = self.engine.acceptance.alpha(cand.name)
        first_node = None
        node = leaf
        for _ in range(k):
            path, tokens, rel, mask = self._chain_arrays(tree, node)
            logits = self.engine.draft_logits(cand.spec.name, tokens, rel, mask)
            last = logits[len(path) - 1]
            probs = verify_lib.softmax(last)
            top_idx = np.argsort(-probs)[: ecfg.top_k]
            # TOP-P filter over sibling candidates (Alg. 1 line 19)
            kept = [int(t) for t in top_idx if probs[t] >= ecfg.top_p * probs[top_idx[0]]]
            if not kept:
                kept = [int(top_idx[0])]
            child_main = None
            for rank, t in enumerate(kept):
                if len(tree) >= ecfg.max_tree:
                    break
                a_node = alpha
                if ecfg.token_level:
                    a_node = min(1.0, alpha * float(probs[t] / max(probs[kept[0]], 1e-9)) ** 0.5)
                c = tree.add_child(node, t, cand.name, a_node)
                if rank == 0:
                    child_main = c
                if first_node is None and rank == 0:
                    first_node = c
            if child_main is None:
                break
            node = child_main
        return first_node

    def _expand_vc(
        self, tree: DraftTree, leaf: int, cand: Candidate, k: int
    ) -> Optional[int]:
        """VC(M_di, PLD): PLD proposes, M_di verifies + extends — one joint
        draft forward over [chain .. pld tokens]."""
        ctx = np.concatenate(
            [np.asarray(self.engine.tokens, np.int32),
             np.asarray(tree.path_tokens(leaf), np.int32)]
        )
        pld_toks, conf = self.engine.pld.propose_with_confidence(ctx, k)
        if len(pld_toks) == 0:
            return self._expand_neural(tree, leaf, cand, k)
        path, tokens, rel, mask = self._chain_arrays(tree, leaf)
        n0 = len(path)
        ext_tokens = np.concatenate([tokens, pld_toks.astype(np.int32)])
        ext_rel = np.concatenate(
            [rel, rel[-1] + 1 + np.arange(len(pld_toks), dtype=np.int32)]
        )
        n = len(ext_tokens)
        ext_mask = np.tril(np.ones((n, n), bool))
        logits = self.engine.draft_logits(cand.spec.name, ext_tokens, ext_rel, ext_mask)
        nxt = np.argmax(logits, axis=-1)
        alpha = self.engine.acceptance.alpha(cand.name)
        node = leaf
        first_node = None
        # accept pld tokens the draft model agrees with, then extend by one
        for i, tok in enumerate(pld_toks):
            if int(nxt[n0 - 1 + i]) != int(tok):
                break
            if len(tree) >= self.cfg.max_tree:
                return first_node
            node = tree.add_child(node, int(tok), cand.name, alpha)
            first_node = first_node or node
        if len(tree) < self.cfg.max_tree:
            ext = int(nxt[min(n0 - 1 + len(pld_toks), n - 1)]) if node != leaf else int(nxt[n0 - 1])
            node = tree.add_child(node, ext, cand.name, alpha)
            first_node = first_node or node
        return first_node

    def _expand_pld(self, tree: DraftTree, leaf: int, k: int) -> Optional[int]:
        ctx = np.concatenate(
            [np.asarray(self.engine.tokens, np.int32),
             np.asarray(tree.path_tokens(leaf), np.int32)]
        )
        toks, conf = self.engine.pld.propose_with_confidence(ctx, k)
        if len(toks) == 0:
            return None
        alpha = self.engine.acceptance.alpha(self.bottom.name)
        if self.cfg.token_level:
            alpha = min(1.0, alpha * (0.5 + conf))   # n-gram length confidence
        node = leaf
        first = None
        for t in toks:
            if len(tree) >= self.cfg.max_tree:
                break
            node = tree.add_child(node, int(t), self.bottom.name, alpha)
            first = first or node
        return first

    # ----------------------------------------------------------------- Alg. 1
    def build_tree(self) -> Tuple[DraftTree, List[Tuple[str, int]]]:
        eng = self.engine
        tree = DraftTree(eng.pending)
        expansions: List[Tuple[str, int]] = []   # (config name, first node)
        a_dn = eng.acceptance.alpha(self.bottom.name)
        c_dn = max(eng.costs.c_hat(self.bottom.name, self.bottom.prior_c), 1e-3)
        n_exp = 0
        while len(tree) < self.cfg.max_tree and n_exp < self.cfg.max_expansions:
            leaf = tree.best_active_leaf()
            if leaf is None:
                break
            # stop rule: least-future-speedup below threshold
            if tree.p_acc[leaf] * (a_dn / c_dn) < self.cfg.t_min and leaf != 0:
                tree.deactivate(leaf)
                continue
            ctx = np.concatenate(
                [np.asarray(eng.tokens, np.int32),
                 np.asarray(tree.path_tokens(leaf), np.int32)]
            )
            pld_ok = len(eng.pld.propose(ctx, 1)) > 0
            cand, k, val = self.find_best_configuration(pld_ok)
            if cand is None:
                tree.deactivate(leaf)
                break
            if cand.spec is None:
                first = self._expand_pld(tree, leaf, k)
            elif cand.vc_with_pld:
                first = self._expand_vc(tree, leaf, cand, k)
            else:
                first = self._expand_neural(tree, leaf, cand, k)
            tree.deactivate(leaf)
            n_exp += 1
            if first is not None:
                expansions.append((cand.name, first))
        return tree, expansions

    def step(self) -> List[int]:
        """One DyTC round: build tree, verify, commit, update estimators."""
        tree, expansions = self.build_tree()
        accepted = self.engine.verify_and_commit(tree)
        # first-token outcomes (Eq. 4): an expansion is observed iff its
        # parent was accepted; outcome = its first node accepted.
        acc_set = self._last_path(tree, accepted)
        for name, first in expansions:
            parent = tree.parents[first]
            if parent in acc_set or parent == 0:
                self.engine.acceptance.observe(name, first in acc_set)
        return accepted

    @staticmethod
    def _last_path(tree: DraftTree, accepted: List[int]) -> set:
        """Recover the accepted node path from the committed token list."""
        nodes = {0}
        node = 0
        for tok in accepted[1:]:
            nxt = None
            for c in tree.children.get(node, ()):
                if tree.tokens[c] == tok:
                    nxt = c
                    break
            if nxt is None:
                break
            nodes.add(nxt)
            node = nxt
        return nodes

    def generate(self, n_tokens: int) -> List[int]:
        out_start = len(self.engine.tokens)
        while len(self.engine.tokens) - out_start < n_tokens:
            self.step()
        return self.engine.tokens[out_start : out_start + n_tokens]
