"""Lossless greedy verification (host walk), a copy of the reference's.

The accepted path is exactly the target model's own greedy continuation,
so spec-decoded output is token-identical to AR decoding.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.tree import DraftTree


def greedy_accept_tree(tree: DraftTree, next_argmax: np.ndarray) -> Tuple[List[int], int]:
    """Walk the tree following the target's argmax at every node.

    ``next_argmax[i]`` = target's argmax next-token after node i (from the
    verify forward). Returns (accepted node path incl. root, bonus token).
    """
    path = [0]
    node = 0
    while True:
        want = int(next_argmax[node])
        nxt = None
        for c in tree.children.get(node, ()):
            if tree.tokens[c] == want:
                nxt = c
                break
        if nxt is None:
            return path, want
        path.append(nxt)
        node = nxt


def softmax(x: np.ndarray, temperature: float = 1.0, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64) / max(temperature, 1e-6)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
