"""The scheduler base, the autoregressive baseline and the static cascade
baselines (CS-Drafting-style, and the SWIFT-style tree); a copy of the
reference's ``core/cascade.py``.

These are the paper's comparison points (Fig. 3):
  SD(spec)  — vanilla self-speculative chain drafting with a fixed k
  PLD       — prompt lookup alone
  VC        — vertical cascade: PLD drafts, M_d1 verifies/extends, n rounds
  HC        — horizontal cascade: M_d1 drafts k1 early tokens, PLD continues
  VC+HC     — CS-Drafting combination
  Tree (Tr) — fixed top-K tree with a single draft model (SWIFT w/ tree attn)
  Tr+VC     — fixed tree over the vertical cascade

Every scheduler builds a DraftTree on the host from the engine's draft
logits and PLD, and verifies through the same engine, so every baseline is
lossless by construction and differs only in scheduling.
The tree baselines (Tree, Tr+VC) and DyTC branch, so they refuse a stack
with Mamba-2 blocks at construction (``engine.check_tree_stack``); AR, PLD,
SD, VC, HC and VC+HC draft chains and serve every stack.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import verify as verify_lib
from repro_torch.core.dsia import PLD_SPEC, DraftSpec
from repro_torch.core.engine import SpecEngine, check_tree_stack
from repro_torch.core.tree import DraftTree


class BaseScheduler:
    def __init__(self, engine: SpecEngine):
        self.engine = engine

    def build_tree(self) -> DraftTree:
        raise NotImplementedError

    def step(self) -> List[int]:
        tree = self.build_tree()
        return self.engine.verify_and_commit(tree)

    def generate(self, n_tokens: int) -> List[int]:
        start = len(self.engine.tokens)
        while len(self.engine.tokens) - start < n_tokens:
            self.step()
        return self.engine.tokens[start: start + n_tokens]


class ARScheduler(BaseScheduler):
    """Autoregressive baseline (tree = root only)."""

    def build_tree(self) -> DraftTree:
        return DraftTree(self.engine.pending)


class PLDScheduler(BaseScheduler):
    def __init__(self, engine: SpecEngine, k: int = 8):
        super().__init__(engine)
        self.k = k
        engine.register_draft(PLD_SPEC)

    def build_tree(self) -> DraftTree:
        eng = self.engine
        tree = DraftTree(eng.pending)
        toks = eng.pld.propose(eng.context, self.k)
        node = 0
        for t in toks:
            node = tree.add_child(node, int(t), "PLD", 0.5)
        return tree


class SDScheduler(BaseScheduler):
    """Vanilla (self-)speculative chain drafting with fixed draft length."""

    def __init__(self, engine: SpecEngine, spec: DraftSpec, k: int = 5):
        super().__init__(engine)
        self.spec, self.k = spec, k
        engine.register_draft(spec)

    def _draft_chain(self, tree: DraftTree, start_node: int, k: int) -> int:
        node = start_node
        for _ in range(k):
            path = tree.path_to(node)
            tokens = np.asarray([tree.tokens[i] for i in path], np.int32)
            rel = np.asarray([tree.depth[i] for i in path], np.int32)
            mask = np.tril(np.ones((len(path), len(path)), bool))
            logits = self.engine.draft_logits(self.spec.name, tokens, rel, mask)
            t = int(np.argmax(logits[len(path) - 1]))
            node = tree.add_child(node, t, self.spec.name, 0.5)
        return node

    def build_tree(self) -> DraftTree:
        tree = DraftTree(self.engine.pending)
        self._draft_chain(tree, 0, self.k)
        return tree


class VCScheduler(SDScheduler):
    """Vertical cascade: PLD drafts k2, M_d1 verifies + extends, n rounds."""

    def __init__(self, engine: SpecEngine, spec: DraftSpec, n: int = 2, k2: int = 6):
        super().__init__(engine, spec, k=0)
        self.n, self.k2 = n, k2

    def build_tree(self) -> DraftTree:
        eng = self.engine
        tree = DraftTree(eng.pending)
        node = 0
        for _ in range(self.n):
            ctx = np.concatenate(
                [np.asarray(eng.tokens, np.int32),
                 np.asarray(tree.path_tokens(node), np.int32)]
            )
            pld = eng.pld.propose(ctx, self.k2)
            path = tree.path_to(node)
            base_tokens = np.asarray([tree.tokens[i] for i in path], np.int32)
            base_rel = np.asarray([tree.depth[i] for i in path], np.int32)
            n0 = len(path)
            ext = np.concatenate([base_tokens, pld.astype(np.int32)])
            rel = np.concatenate(
                [base_rel, base_rel[-1] + 1 + np.arange(len(pld), dtype=np.int32)]
            )
            mask = np.tril(np.ones((len(ext), len(ext)), bool))
            logits = eng.draft_logits(self.spec.name, ext, rel, mask)
            nxt = np.argmax(logits, axis=-1)
            for i, t in enumerate(pld):
                if int(nxt[n0 - 1 + i]) != int(t):
                    break
                node = tree.add_child(node, int(t), self.spec.name, 0.5)
            # extend by the draft model's own token at the accepted frontier
            last_row = n0 - 1 + _accepted_prefix(nxt[n0 - 1 :], pld)
            node = tree.add_child(node, int(nxt[last_row]), self.spec.name, 0.5)
        return tree


class HCScheduler(SDScheduler):
    """Horizontal cascade: M_d1 drafts k1 early tokens, PLD appends k2."""

    def __init__(self, engine: SpecEngine, spec: DraftSpec, k1: int = 3, k2: int = 5):
        super().__init__(engine, spec, k=k1)
        self.k2 = k2

    def build_tree(self) -> DraftTree:
        tree = DraftTree(self.engine.pending)
        node = self._draft_chain(tree, 0, self.k)
        ctx = np.concatenate(
            [np.asarray(self.engine.tokens, np.int32),
             np.asarray(tree.path_tokens(node), np.int32)]
        )
        pld = self.engine.pld.propose(ctx, self.k2)
        for t in pld:
            node = tree.add_child(node, int(t), "PLD", 0.4)
        return tree


class VCHCScheduler(VCScheduler):
    """CS-Drafting: vertical + horizontal — VC rounds, then a PLD tail."""

    def __init__(self, engine: SpecEngine, spec: DraftSpec, n: int = 2, k2: int = 5, tail: int = 4):
        super().__init__(engine, spec, n=n, k2=k2)
        self.tail = tail

    def build_tree(self) -> DraftTree:
        tree = super().build_tree()
        # deepest node
        node = max(range(len(tree)), key=lambda i: tree.depth[i])
        ctx = np.concatenate(
            [np.asarray(self.engine.tokens, np.int32),
             np.asarray(tree.path_tokens(node), np.int32)]
        )
        pld = self.engine.pld.propose(ctx, self.tail)
        for t in pld:
            node = tree.add_child(node, int(t), "PLD", 0.4)
        return tree


class TreeScheduler(SDScheduler):
    """SWIFT-with-tree-attention baseline: fixed-depth top-K branching."""

    def __init__(self, engine: SpecEngine, spec: DraftSpec, depth: int = 4,
                 top_k: int = 2, max_tree: int = 16):
        check_tree_stack(engine.cfg, type(self).__name__)
        super().__init__(engine, spec, k=depth)
        self.top_k, self.max_tree = top_k, max_tree

    def build_tree(self) -> DraftTree:
        tree = DraftTree(self.engine.pending)
        frontier = [0]
        for _ in range(self.k):
            nxt_frontier = []
            for node in frontier:
                if len(tree) >= self.max_tree:
                    break
                path = tree.path_to(node)
                tokens = np.asarray([tree.tokens[i] for i in path], np.int32)
                rel = np.asarray([tree.depth[i] for i in path], np.int32)
                mask = np.tril(np.ones((len(path), len(path)), bool))
                logits = self.engine.draft_logits(self.spec.name, tokens, rel, mask)
                probs = verify_lib.softmax(logits[len(path) - 1])
                top = np.argsort(-probs)[: self.top_k]
                for rank, t in enumerate(top):
                    if len(tree) >= self.max_tree:
                        break
                    c = tree.add_child(node, int(t), self.spec.name, 0.5)
                    if rank == 0:
                        nxt_frontier.append(c)
            # branch only at the first level (SpecInfer-style narrow tree)
            frontier = nxt_frontier[:1] if len(tree) > 1 + self.top_k else nxt_frontier
        return tree


class TreeVCScheduler(TreeScheduler):
    """Tree attention over the vertical cascade (Tr+VC in Fig. 3)."""

    def build_tree(self) -> DraftTree:
        tree = super().build_tree()
        node = max(range(len(tree)), key=lambda i: tree.depth[i])
        ctx = np.concatenate(
            [np.asarray(self.engine.tokens, np.int32),
             np.asarray(tree.path_tokens(node), np.int32)]
        )
        pld = self.engine.pld.propose(ctx, 4)
        for t in pld:
            if len(tree) >= self.max_tree + 4:
                break
            node = tree.add_child(node, int(t), "PLD", 0.4)
        return tree


def _accepted_prefix(nxt: np.ndarray, proposed: np.ndarray) -> int:
    n = 0
    for i, t in enumerate(proposed):
        if int(nxt[i]) != int(t):
            break
        n += 1
    return n
