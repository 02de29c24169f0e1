"""Lossless greedy verification (host walks), a copy of the reference's.

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


def greedy_accept_tree_batched(
    tokens: np.ndarray,             # (B, N) int node tokens (node 0 = root)
    parents: np.ndarray,            # (B, N) int, -1 at root/unused
    count: np.ndarray,              # (B,) int real nodes per slot
    next_argmax: np.ndarray,        # (B, N) int target argmax after each node
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``greedy_accept_tree`` over a batch of padded array trees, the
    reference's vectorized walk (N-1 masked steps, first matching child) in
    numpy: the split serving round reads the target's argmax to the host
    once and walks there.

    Returns (path_idx (B, N) int32 — accepted node indices in path order,
    zero-padded; n_acc (B,) int32 — accepted nodes incl. the root; bonus
    (B,) int32 — the target's next token after the last accepted node).
    """
    tokens, parents, next_argmax = (np.asarray(a) for a in (tokens, parents, next_argmax))
    B, N = tokens.shape
    b_idx = np.arange(B)
    real = np.arange(N)[None, :] < np.asarray(count)[:, None]
    node = np.zeros(B, np.int32)
    n_acc = np.ones(B, np.int32)
    done = np.zeros(B, bool)
    path = np.zeros((B, N), np.int32)
    for _ in range(N - 1):
        want = next_argmax[b_idx, node]
        cand = real & (parents == node[:, None]) & (tokens == want[:, None])
        found = cand.any(axis=1) & ~done
        child = cand.argmax(axis=1).astype(np.int32)          # first matching child
        path[b_idx[found], n_acc[found]] = child[found]
        node = np.where(found, child, node)
        n_acc = n_acc + found
        done |= ~found
    return path, n_acc.astype(np.int32), next_argmax[b_idx, node].astype(np.int32)


def softmax(x: np.ndarray, temperature: float = 1.0, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64) / max(temperature, 1e-6)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
