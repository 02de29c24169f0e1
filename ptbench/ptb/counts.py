"""The operations an autoregressive target forward needs, from the
configuration file's sizes: a frozen copy of the counting rules of the
program's ``analysis/costs.py`` (``layer_gemms``, ``unembed``, the attention
terms of ``decode_step`` and ``prefill``, ``param_count`` /
``active_param_count``), so that no later change to the program moves the
yardstick.

FLOPs count 2 a multiply-add of the matrix products (weights and
attention); elementwise work and norms are left out. A token decoded at
position p attends to p + 1 keys (the cache and itself); each (row, key)
pair costs 4 * hd operations a head (Q.K and P.V). The head runs over the
padded vocabulary (a multiple of 256), as the program's does. An MoE layer
counts the float32 router, its top-k experts and the shared experts with
their gate."""
from __future__ import annotations


def padded_vocab(cfg: dict) -> int:
    return ((int(cfg["vocab_size"]) + 255) // 256) * 256


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"])


def _nmat(cfg: dict) -> int:
    return 3 if cfg.get("mlp_gated", True) else 2


def layer_weight_flops(cfg: dict) -> float:
    """One token's weight-GEMM operations in one layer."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    attn = 2 * (d * H * hd + 2 * d * KV * hd + H * hd * d)
    moe = cfg.get("moe")
    if moe:
        E, K, F = moe["num_experts"], moe["top_k"], moe["d_ff_expert"]
        mlp = 2 * d * E + 2 * _nmat(cfg) * K * d * F
        if moe.get("num_shared_experts"):
            f_sh = moe.get("d_ff_shared") or F * moe["num_shared_experts"]
            mlp += 2 * _nmat(cfg) * d * f_sh + 2 * d
    else:
        mlp = 2 * _nmat(cfg) * d * cfg["d_ff"]
    return float(attn + mlp)


def unembed_flops(cfg: dict, rows: int = 1) -> float:
    return 2.0 * rows * cfg["d_model"] * padded_vocab(cfg)


def attention_flops(cfg: dict, pairs: int) -> float:
    """``pairs`` (query row, visible key) pairs in every layer."""
    return 4.0 * head_dim(cfg) * cfg["num_heads"] * pairs * cfg["num_layers"]


def decode_token_flops(cfg: dict, position: int) -> float:
    """One token decoded at ``position`` (0-based): every layer's weights,
    attention over position + 1 keys, the head."""
    return (cfg["num_layers"] * layer_weight_flops(cfg) + attention_flops(cfg, position + 1)
            + unembed_flops(cfg))


def prefill_flops(cfg: dict, S: int) -> float:
    """A prompt of S tokens: every layer's weights S times, causal attention
    (S (S + 1) / 2 pairs), the head over the last position."""
    return (S * cfg["num_layers"] * layer_weight_flops(cfg)
            + attention_flops(cfg, S * (S + 1) // 2) + unembed_flops(cfg))


def generated_flops(cfg: dict, prompt_len: int, first: int, last: int) -> float:
    """Operations for a request's served tokens ``first``..``last``
    (1-based, inclusive): token j >= 2 is the decode of token j - 1 at
    position prompt_len + j - 2; token 1 is the prefill's."""
    total = 0.0
    for j in range(max(first, 2), last + 1):
        total += decode_token_flops(cfg, prompt_len + j - 2)
    return total


def param_count(cfg: dict) -> int:
    """The analytic parameter count (unpadded vocabulary), as the program's
    ``analysis/costs.py::param_count`` for an attention stack."""
    d, V, hd = cfg["d_model"], cfg["vocab_size"], head_dim(cfg)
    n = V * d * (1 if cfg.get("tie_embeddings") else 2) + d
    per = d + 2 * d * cfg["num_heads"] * hd + 2 * d * cfg["num_kv_heads"] * hd + d
    moe = cfg.get("moe")
    if moe:
        E, F = moe["num_experts"], moe["d_ff_expert"]
        per += d * E + E * _nmat(cfg) * d * F
        if moe.get("num_shared_experts"):
            per += _nmat(cfg) * d * (moe.get("d_ff_shared") or F * moe["num_shared_experts"]) + d
    else:
        per += _nmat(cfg) * d * cfg["d_ff"]
    return n + cfg["num_layers"] * per


def active_param_count(cfg: dict) -> int:
    """Parameters a token touches (MoE: its top-k and the shared experts)."""
    moe = cfg.get("moe")
    if not moe:
        return param_count(cfg)
    return param_count(cfg) - cfg["num_layers"] * (moe["num_experts"] - moe["top_k"]) * (
        _nmat(cfg) * cfg["d_model"] * moe["d_ff_expert"])
