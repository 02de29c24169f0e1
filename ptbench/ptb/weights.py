"""The served model's weights, made on the device from the configuration's
own ``weight_seed`` (never from ``--seed``): a deployment serves one model
while its traffic changes.

The leaves are laid out as the program takes them (``params["embed"]``,
``"final_norm"``, ``"lm_head"`` and ``"segments"``: one segment of the
``num_layers`` identical layers, each leaf stacked on a leading layer
axis), and are views into one flat buffer per type, filled by a
``torch.Generator`` on the device in a few large calls: a standard normal
times the leaf's scale (1 / sqrt(fan-in)), and zeros for the norms, which
are stored as offsets from one. The MoE router stays float32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ptb.counts import head_dim, padded_vocab

ALIGN = 256                 # elements between leaf starts (TMA wants 16-byte bases)
CHUNK = 1 << 30             # elements drawn by one call


def _leaf(path, shape, dtype, scale):
    return (tuple(path), tuple(int(s) for s in shape), dtype, scale)


def leaves(cfg: dict) -> List[Tuple[tuple, tuple, str, object]]:
    """(path, shape, dtype name, scale or None for zeros) of every leaf."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    V, L, dt = padded_vocab(cfg), cfg["num_layers"], cfg["dtype"]
    out = [_leaf(["embed"], (V, d), dt, d ** -0.5), _leaf(["final_norm"], (d,), dt, None)]
    if not cfg.get("tie_embeddings"):
        out.append(_leaf(["lm_head"], (d, V), dt, d ** -0.5))
    lay = ["segments", 0, 0]
    out += [_leaf(lay + ["norm1"], (L, d), dt, None),
            _leaf(lay + ["attn", "wq"], (L, d, H, hd), dt, d ** -0.5),
            _leaf(lay + ["attn", "wk"], (L, d, KV, hd), dt, d ** -0.5),
            _leaf(lay + ["attn", "wv"], (L, d, KV, hd), dt, d ** -0.5),
            _leaf(lay + ["attn", "wo"], (L, H, hd, d), dt, (H * hd) ** -0.5),
            _leaf(lay + ["norm2"], (L, d), dt, None)]
    gated = cfg.get("mlp_gated", True)
    moe = cfg.get("moe")
    if moe:
        E, F = moe["num_experts"], moe["d_ff_expert"]
        m = lay + ["moe"]
        out += [_leaf(m + ["w_router"], (L, d, E), "float32", d ** -0.5),
                _leaf(m + ["w_up"], (L, E, d, F), dt, d ** -0.5),
                _leaf(m + ["w_down"], (L, E, F, d), dt, F ** -0.5)]
        if gated:
            out.append(_leaf(m + ["w_gate"], (L, E, d, F), dt, d ** -0.5))
        if moe.get("num_shared_experts"):
            f = moe.get("d_ff_shared") or F * moe["num_shared_experts"]
            out += [_leaf(m + ["shared", "w_up"], (L, d, f), dt, d ** -0.5),
                    _leaf(m + ["shared", "w_down"], (L, f, d), dt, f ** -0.5)]
            if gated:
                out.append(_leaf(m + ["shared", "w_gate"], (L, d, f), dt, d ** -0.5))
            out.append(_leaf(m + ["w_shared_gate"], (L, d, 1), dt, d ** -0.5))
    else:
        f = cfg["d_ff"]
        out += [_leaf(lay + ["mlp", "w_up"], (L, d, f), dt, d ** -0.5),
                _leaf(lay + ["mlp", "w_down"], (L, f, d), dt, f ** -0.5)]
        if gated:
            out.append(_leaf(lay + ["mlp", "w_gate"], (L, d, f), dt, d ** -0.5))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(cfg: dict, device, seed: int) -> Dict:
    """The params tree on ``device``, drawn from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = leaves(cfg)
    params: Dict = {}
    for dtype in sorted({dt for _, _, dt, _ in spec}):
        mine = [s for s in spec if s[2] == dtype]
        offs, n = [], 0
        for _, shape, _, _ in mine:
            offs.append(n)
            n += -(-_numel(shape) // ALIGN) * ALIGN
        buf = torch.empty(n, dtype=getattr(torch, dtype), device=device)
        for i in range(0, n, CHUNK):
            buf[i:i + CHUNK].normal_(generator=gen)
        for (path, shape, _, scale), off in zip(mine, offs):
            view = buf[off:off + _numel(shape)].view(shape)
            if scale is None:
                view.zero_()
            else:
                view.mul_(scale)
            _put(params, path, view)
    return params
