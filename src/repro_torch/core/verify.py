"""Lossless verification, a copy of the reference's: host walks (numpy)
and the batched walks on tensors that the serving rounds run.

Greedy mode: the accepted path is exactly the target model's own greedy
continuation, so spec-decoded output is token-identical to AR decoding.

Sampling mode: speculative sampling of point-mass drafts against the
warped target distribution (``sampling_probs``) — accept a drafted token
``x`` with probability q(x), else resample from the residual — lossless in
law. The walks take their uniforms as inputs (``round_uniforms`` splits
them from the carried per-slot threefry keys, ``core.prng``), so given the
same uniforms they are deterministic, the host oracles
(``sample_accept_*_host``) replay them exactly, and with the reference's
key stream they give the reference's tokens.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import prng
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


def sampling_probs(
    logits: torch.Tensor,           # (B, V) or (B, T, V) logits
    temperature: torch.Tensor,      # (B,) float32, <= 0 -> greedy point mass
    top_k: torch.Tensor,            # (B,) int32, <= 0 -> no top-k filter
    top_p: torch.Tensor,            # (B,) float32, >= 1 -> no nucleus filter
) -> torch.Tensor:
    """The warped target distribution q per slot, float32 (the tensor twin
    of ``serving.sampler.warp_probs``).

    Exact-k top-k with a stable index tie-break (ties at the k-th value keep
    the lowest token indices), exclusive-cumulative top-p (a token is kept
    iff the sorted mass strictly before it is < top_p), and slots with
    temperature <= 0 get a one-hot at the argmax of the raw logits, which
    makes every accept / resample walk below reproduce the greedy walks
    token for token. The rank is the inverse of the stable sort's
    permutation, by scatter (the reference argsorts twice)."""
    squeeze = logits.ndim == 2
    if squeeze:
        logits = logits[:, None, :]
    t = temperature.float()[:, None, None]
    k = top_k[:, None, None]
    tp = top_p.float()[:, None, None]
    x = logits.float() / torch.clamp_min(t, 1e-6)
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    ids = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ids)
    x = torch.where((k <= 0) | (rank < k), x, float("-inf"))
    p = torch.softmax(x, dim=-1)
    p_sorted = p.gather(-1, order)
    keep_sorted = (torch.cumsum(p_sorted, dim=-1) - p_sorted) < torch.clamp_min(tp, 1e-9)
    p = torch.where(keep_sorted.gather(-1, rank), p, 0.0)
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    onehot = torch.zeros_like(p).scatter_(-1, logits.argmax(dim=-1, keepdim=True), 1.0)
    q = torch.where(t <= 0.0, onehot, p)
    return q[:, 0] if squeeze else q


def _inv_cdf(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Deterministic inverse-CDF draw from unnormalized nonnegative (B, V)
    mass rows at uniforms u (B,) in [0, 1): the first index whose inclusive
    cumulative mass exceeds ``u * total``. int32 (B,)."""
    cum = torch.cumsum(p, dim=-1)
    hit = cum > u[:, None] * cum[:, -1:]
    return hit.to(torch.uint8).argmax(dim=-1).to(torch.int32)


def round_uniforms(keys: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split per-slot threefry keys (B, 2) and draw ``n`` uniforms per slot
    from the second half. Returns (new_keys (B, 2), u (B, n) float32), the
    reference's split-then-uniform, bit for bit, on the keys' device."""
    sub = prng.split(keys, 2)
    return sub[:, 0], prng.uniform(sub[:, 1], n)


def sample_accept_chain_batched(
    chains: torch.Tensor,           # (B, K) int drafted chain tokens
    have: torch.Tensor,             # (B,) int real drafted tokens per slot
    q: torch.Tensor,                # (B, K+1, V) warped target dist per position
    u_acc: torch.Tensor,            # (B, K) accept uniforms
    u_next: torch.Tensor,           # (B,) residual / bonus uniform
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched speculative sampling for point-mass drafts: drafted token j
    is accepted iff ``u_acc[j] < q[j, token]`` and every earlier one was;
    at the first rejection the next token is drawn from q with the rejected
    token zeroed (renormalized by the draw), and a fully accepted chain
    draws its bonus from row K. With one-hot q this is the greedy rule.
    Returns (n_chain (B,), next_tok (B,)), int32."""
    B, K = chains.shape
    V = q.shape[-1]
    chains = chains.long()
    tok_q = q[:, :K].gather(-1, chains[..., None])[..., 0]
    steps = torch.arange(K, device=q.device)
    ok = (steps[None] < have[:, None]) & (u_acc < tok_q)
    n_chain = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    row = q.gather(1, n_chain.long()[:, None, None].expand(B, 1, V))[:, 0]
    rejected = n_chain < have
    rej_tok = chains.gather(1, torch.clamp(n_chain, max=K - 1).long()[:, None])
    zero = rejected[:, None] & (torch.arange(V, device=q.device)[None] == rej_tok)
    resid = torch.where(zero, 0.0, row)
    use = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, row)
    return n_chain, _inv_cdf(use, u_next)


def sample_accept_tree_batched(
    tokens: torch.Tensor,           # (B, N) int node tokens (node 0 = root)
    parents: torch.Tensor,          # (B, N) int, -1 at root/unused
    count: torch.Tensor,            # (B,) int real nodes per slot
    q: torch.Tensor,                # (B, N, V) warped target dist after each node
    u: torch.Tensor,                # (B, N) one uniform per walk step
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stochastic tree walk for point-mass drafts (sequential sibling
    fallback, SpecInfer-style): at each node, one uniform drives an
    inverse CDF over the children's masses [q(x_1), .., q(x_m), rest] in
    index order; the first child whose inclusive cumulative mass exceeds u
    is accepted, and if u falls in ``rest`` the walk stops and draws the
    next token from the residual (q with every child token zeroed) with the
    leftover uniform rescaled onto [0, 1). N masked steps, one more than
    the greedy walk (a fully accepted maximal chain still draws its bonus
    at the leaf), no host read. With one-hot q it is the greedy walk.
    Returns (path_idx (B, N), n_acc (B,), next_tok (B,)), int32."""
    B, N = tokens.shape
    V = q.shape[-1]
    dev = tokens.device
    slot = torch.arange(N, device=dev)
    real = slot[None, :] < count[:, None]
    tok = tokens.long()
    node = torch.zeros((B,), dtype=torch.int64, device=dev)
    n_acc = torch.ones((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    path = torch.zeros((B, N), dtype=torch.int32, device=dev)
    nxt_tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(N):
        u_s = u[:, s]
        q_v = q.gather(1, node[:, None, None].expand(B, 1, V))[:, 0]          # (B, V)
        is_child = real & (parents == node[:, None])
        m = q_v.gather(1, tok) * is_child
        cum = torch.cumsum(m, dim=1)
        total = cum[:, -1]
        hit = is_child & (m > 0) & (cum > u_s[:, None])
        found = hit.any(dim=1) & ~done
        child = hit.to(torch.uint8).argmax(dim=1)
        # no child segment holds u: stop here and resample from the residual
        # with the leftover uniform rescaled onto [0, 1)
        stop_now = ~done & ~found
        u_left = torch.clamp((u_s - total) / torch.clamp_min(1.0 - total, 1e-9), 0.0, 1.0 - 1e-7)
        # the reference's drop-mode write of 0 at the children's tokens: into
        # a padded column V where a node is no child
        col = torch.where(is_child, tok, V)
        zero = torch.zeros((B, V + 1), dtype=torch.bool, device=dev).scatter_(1, col, True)
        resid = torch.where(zero[:, :V], 0.0, q_v)
        use = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, q_v)
        nxt_tok = torch.where(stop_now, _inv_cdf(use, u_left), nxt_tok)
        path = torch.where(found[:, None] & (slot[None, :] == n_acc[:, None]),
                           child.to(torch.int32)[:, None], path)
        node = torch.where(found, child, node)
        n_acc = n_acc + found.to(torch.int32)
        done = done | ~found
    return path, n_acc, nxt_tok


def sample_accept_chain_host(chains: np.ndarray, have: int, q: np.ndarray,
                             u_acc: np.ndarray, u_next: float) -> Tuple[int, int]:
    """Host oracle twin of ``sample_accept_chain_batched`` for ONE slot: the
    same accept rule and inverse-CDF residual / bonus draw under the same
    uniforms. (chains (K,), q (K+1, V), u_acc (K,).)"""
    K = len(chains)
    n = 0
    while n < min(have, K) and u_acc[n] < q[n, chains[n]]:
        n += 1
    row = np.asarray(q[n], np.float64).copy()
    if n < have:
        row[int(chains[n])] = 0.0
        if row.sum() <= 0:
            row = np.asarray(q[n], np.float64)
    cum = np.cumsum(row)
    return n, int(np.argmax(cum > u_next * cum[-1]))


def sample_accept_tree_host(tokens: np.ndarray, parents: np.ndarray, count: int,
                            q: np.ndarray, u: np.ndarray) -> Tuple[List[int], int, int]:
    """Host oracle twin of ``sample_accept_tree_batched`` for ONE slot: the
    sequential sibling walk written plainly. Returns (path node indices incl.
    the root, n_acc, next token)."""
    path = [0]
    node = 0
    for s in range(len(tokens)):
        u_s = float(u[s])
        q_v = np.asarray(q[node], np.float64)
        kids = [j for j in range(count) if parents[j] == node]
        acc = 0.0
        nxt = None
        for c in kids:
            mass = float(q_v[int(tokens[c])])
            if mass > 0 and acc + mass > u_s:
                nxt = c
                break
            acc += mass
        if nxt is not None:
            path.append(nxt)
            node = nxt
            continue
        u_left = min(max((u_s - acc) / max(1.0 - acc, 1e-9), 0.0), 1.0 - 1e-7)
        resid = q_v.copy()
        for c in kids:
            resid[int(tokens[c])] = 0.0
        if resid.sum() <= 0:
            resid = q_v
        cum = np.cumsum(resid)
        return path, len(path), int(np.argmax(cum > u_left * cum[-1]))
    raise AssertionError("walk must stop within N steps")


def spec_sample_chain(
    draft_tokens: np.ndarray,       # (k,)
    draft_probs: np.ndarray,        # (k, V) draft distribution per position
    target_probs: np.ndarray,       # (k+1, V) target distribution (incl. bonus)
    rng: np.random.Generator,
) -> Tuple[int, int]:
    """Leviathan et al.'s chain speculative sampling with explicit draft
    distributions. Returns (n_accepted, next_token): the residual-resampled
    token at the rejection point, or a fresh sample from the bonus position
    when everything is accepted."""
    k = len(draft_tokens)
    for i in range(k):
        tok = int(draft_tokens[i])
        p_t = float(target_probs[i, tok])
        p_d = float(draft_probs[i, tok])
        if p_d <= 0.0 or rng.random() < min(1.0, p_t / max(p_d, 1e-30)):
            if p_d <= 0.0 and p_t <= 0.0:
                pass  # fall through to rejection
            else:
                continue
        residual = np.clip(target_probs[i] - draft_probs[i], 0.0, None)
        z = residual.sum()
        if z <= 0:
            residual = target_probs[i]
            z = residual.sum()
        nxt = int(rng.choice(len(residual), p=residual / z))
        return i, nxt
    p = target_probs[k]
    nxt = int(rng.choice(len(p), p=p / p.sum()))
    return k, nxt


def softmax(x: np.ndarray, temperature: float = 1.0, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float64) / max(temperature, 1e-6)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
