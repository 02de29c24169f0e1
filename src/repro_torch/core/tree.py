"""Draft token tree for DyTC (host-side structure) and the batched server's
tree seed (numpy for the split rounds, tensors for the single-dispatch
round), copies of the reference's.

Node 0 is the root: the *pending bonus token* from the previous verification
(Alg. 1 line 1). Its KV is not yet committed; every verification pass
therefore processes the full tree including the root, and the root is
accepted unconditionally (it is the target model's own token). Trees are
padded to fixed bucket sizes, with a dense (T, T) ancestor-closure mask.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TREE_BUCKETS = (8, 16, 32, 64, 128)


def bucket_for(n: int) -> int:
    for b in TREE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"tree too large: {n} > {TREE_BUCKETS[-1]}")


class DraftTree:
    def __init__(self, root_token: int):
        self.tokens: List[int] = [int(root_token)]
        self.parents: List[int] = [-1]
        self.depth: List[int] = [0]
        self.config: List[str] = ["root"]
        self.p_acc: List[float] = [1.0]
        self.active: List[bool] = [True]
        self.children: Dict[int, List[int]] = {0: []}

    def __len__(self) -> int:
        return len(self.tokens)

    def add_child(self, parent: int, token: int, config: str, alpha: float) -> int:
        idx = len(self.tokens)
        self.tokens.append(int(token))
        self.parents.append(parent)
        self.depth.append(self.depth[parent] + 1)
        self.config.append(config)
        self.p_acc.append(self.p_acc[parent] * float(alpha))
        self.active.append(True)
        self.children[idx] = []
        self.children[parent].append(idx)
        return idx

    def deactivate(self, node: int) -> None:
        self.active[node] = False

    def best_active_leaf(self) -> Optional[int]:
        """argmax P_acc over active nodes (Alg. 1 line 5)."""
        best, best_p = None, -1.0
        for i in range(len(self.tokens)):
            if self.active[i] and self.p_acc[i] > best_p:
                best, best_p = i, self.p_acc[i]
        return best

    def path_to(self, node: int) -> List[int]:
        path = []
        while node != -1:
            path.append(node)
            node = self.parents[node]
        return path[::-1]

    def path_tokens(self, node: int) -> List[int]:
        return [self.tokens[i] for i in self.path_to(node)]

    def siblings(self, node: int) -> List[int]:
        p = self.parents[node]
        if p == -1:
            return []
        return [c for c in self.children[p] if c != node]

    def flatten(
        self, bucket: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens (T,), rel_pos (T,), mask (T,T), real (T,)).

        rel_pos[i] = depth[i]; mask[i, j] = True iff j is an ancestor-or-self
        of i. Padded nodes have real=False, self-only visibility and
        positions past the deepest node.
        """
        n = len(self.tokens)
        T = bucket or bucket_for(n)
        tokens = np.zeros(T, np.int32)
        rel = np.zeros(T, np.int32)
        mask = np.eye(T, dtype=bool)
        real = np.zeros(T, bool)
        tokens[:n] = self.tokens
        rel[:n] = self.depth
        real[:n] = True
        for i in range(n):
            j = i
            while j != -1:
                mask[i, j] = True
                j = self.parents[j]
        rel[n:] = np.arange(T - n) + max(self.depth) + 1 if n else 0
        return tokens, rel, mask, real


def chain_tree(root_token: int, chain: Sequence[int], config: str, alpha: float) -> DraftTree:
    """A pure-chain tree (vanilla SD and the cascades)."""
    t = DraftTree(root_token)
    node = 0
    for tok in chain:
        node = t.add_child(node, tok, config, alpha)
    return t


def tree_seed_arrays(
    pending: np.ndarray,          # (B,) int
    chains: np.ndarray,           # (B, K) int — PLD-prefilled chain per slot
    have: np.ndarray,             # (B,) int — chain tokens actually proposed
    bucket: int,
    pld_alpha: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched tree seed: per-slot chain trees padded to ``bucket``.

    Node 0 is the pending bonus token; nodes 1..have[b] are the slot's PLD
    chain (parent = previous node). Same node layout and mask convention as
    ``DraftTree.flatten``: unused slots see only themselves and no real node
    sees them. Returns (tokens (B,N) i32, parents (B,N) i32 with -1 at
    roots/unused, depth (B,N) i32, p_acc (B,N) f32, mask (B,N,N) bool,
    count (B,) i32).
    """
    pending = np.asarray(pending)
    chains = np.asarray(chains)
    have = np.asarray(have)
    B, K = chains.shape
    N = bucket
    if N < K + 1:
        raise ValueError(f"bucket {N} cannot hold a {K}-token chain + root")
    j = np.arange(N)
    seeded = (j[None, :] >= 1) & (j[None, :] <= have[:, None])   # (B, N)
    tokens = np.zeros((B, N), np.int32)
    tokens[:, 0] = pending
    tokens[:, 1: K + 1] = np.where(seeded[:, 1: K + 1], chains, 0)
    parents = np.where(seeded, j[None, :] - 1, -1).astype(np.int32)
    depth = np.where(seeded, j[None, :], 0).astype(np.int32)
    p_acc = np.where(seeded, pld_alpha ** depth.astype(np.float64), 0.0)
    p_acc[:, 0] = 1.0
    p_acc = p_acc.astype(np.float32)
    # chain ancestor closure: node i sees j <= i; unused slots are self-only
    mask = np.broadcast_to(np.eye(N, dtype=bool), (B, N, N)).copy()
    mask |= (j[None, None, :] < j[None, :, None]) & seeded[:, :, None]
    count = (have + 1).astype(np.int32)
    return tokens, parents, depth, p_acc, mask, count


def tree_seed_device(pending: torch.Tensor, chains: torch.Tensor, have: torch.Tensor,
                     bucket: int, pld_alpha: float = 0.3):
    """``tree_seed_arrays`` on tensors, for the single-dispatch serving
    round: the same node layout, mask convention and P_acc seeding, shapes
    fixed by ``bucket``, no host read."""
    B, K = chains.shape
    N = bucket
    if N < K + 1:
        raise ValueError(f"bucket {N} cannot hold a {K}-token chain + root")
    dev = chains.device
    j = torch.arange(N, device=dev)
    seeded = (j[None, :] >= 1) & (j[None, :] <= have[:, None])     # (B, N)
    tokens = torch.zeros((B, N), dtype=torch.int32, device=dev)
    tokens[:, 0] = pending
    tokens[:, 1: K + 1] = torch.where(seeded[:, 1: K + 1], chains.to(torch.int32), 0)
    parents = torch.where(seeded, j[None, :] - 1, -1).to(torch.int32)
    depth = torch.where(seeded, j[None, :], 0).to(torch.int32)
    p_acc = torch.where(seeded, pld_alpha ** depth.float(), 0.0)
    p_acc[:, 0] = 1.0
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    mask = eye[None] | ((j[None, None, :] < j[None, :, None]) & seeded[:, :, None])
    return tokens, parents, depth, p_acc, mask, (have + 1).to(torch.int32)
