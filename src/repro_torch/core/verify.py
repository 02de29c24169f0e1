"""Lossless greedy verification, a copy of the reference's: host walks
(numpy) and the batched walk on tensors that the serving rounds run.

The accepted path is exactly the target model's own greedy continuation,
so spec-decoded output is token-identical to AR decoding.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

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


def greedy_accept_tree_device(
    tokens: torch.Tensor,           # (B, N) int32 node tokens (node 0 = root)
    parents: torch.Tensor,          # (B, N) int32, -1 at root/unused
    count: torch.Tensor,            # (B,) int32 real nodes per slot
    next_argmax: torch.Tensor,      # (B, N) int32 target argmax after each node
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``greedy_accept_tree_batched`` on tensors, with no host read: N-1
    masked steps (the longest possible path), first matching child, as the
    reference's device walk. Returns (path_idx (B, N), n_acc (B,), bonus
    (B,)), int32 tensors on the inputs' device."""
    B, N = tokens.shape
    dev = tokens.device
    slot = torch.arange(N, device=dev)
    real = slot[None, :] < count[:, None]
    node = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    n_acc = torch.ones((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    path = torch.zeros((B, N), dtype=torch.int32, device=dev)
    for _ in range(N - 1):
        want = torch.gather(next_argmax, 1, node)
        cand = real & (parents == node) & (tokens == want)
        found = cand.any(dim=1) & ~done
        child = cand.to(torch.uint8).argmax(dim=1, keepdim=True)   # first matching child
        path = torch.where(found[:, None] & (slot[None, :] == n_acc[:, None]),
                           child.to(torch.int32), path)
        node = torch.where(found[:, None], child, node)
        n_acc = n_acc + found.to(torch.int32)
        done |= ~found
    return path, n_acc, torch.gather(next_argmax, 1, node)[:, 0].to(torch.int32)


def softmax(x: np.ndarray, temperature: float = 1.0, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64) / max(temperature, 1e-6)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
