"""Scheduler base and the autoregressive baseline; a copy of the reference's
``core/cascade.py`` (the static cascade baselines are later slices).

Every scheduler builds a DraftTree and verifies through the same engine, so
it is lossless by construction and differs only in scheduling.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.engine import SpecEngine
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
