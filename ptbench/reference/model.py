"""A decoder's forward pass in plain PyTorch, from the weights alone.

The equations are those of the configuration files' models as the program
states them (its ``models/`` and the JAX reference's): token embedding;
per layer RMSNorm (weight stored as an offset from one), RoPE (split-half,
``rope_theta``), causal GQA attention (query head h reads KV head
h // (H / KV)), the output projection; RMSNorm, then a SwiGLU MLP, or an
MoE block: a float32 softmax router, the top-k experts with their weights
renormalised to sum to one, and the shared experts' SwiGLU scaled by a
sigmoid gate; the final RMSNorm and the head. Every product runs in
float32 with TF32 off, the weights upcast one layer at a time, the layers
outermost so that each layer's weights are read once for every sequence.

``precision="fp8"`` is the control: every product of a bfloat16 weight
(and the head) takes its operands rounded to float8 e4m3, the weight with
one scale a column and the activations with one scale a row (absolute
maximum over 448), and accumulates in float32; the router stays float32,
as the configuration states it.

``precision="bfloat16"`` is a witness, not a control: every such product
takes bfloat16 operands and rounds its result to bfloat16, the served
precision, the router and the rest in float32 as before. It shows what
rounding at the served precision alone does to the first choices.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8", "bfloat16")
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the duration (and the old settings back after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(t: torch.Tensor, reduce_dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 with one scale per slice along
    ``reduce_dim`` (its absolute maximum maps to 448), back in float32."""
    amax = t.abs().amax(dim=reduce_dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Prec:
    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}; pick one of {PRECISIONS}")
        self.fp8 = precision == "fp8"
        self.bf16 = precision == "bfloat16"

    def weight(self, w: torch.Tensor, in_dim: int) -> torch.Tensor:
        """A weight leaf in float32 (rounded per output column in fp8; in
        bfloat16 for the witness)."""
        if self.bf16:
            return w.to(torch.bfloat16)
        w = w.float()
        return fp8_round(w, in_dim) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.bf16:
            return (x.to(torch.bfloat16) @ w).float()
        if self.fp8:
            x = fp8_round(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, heads, hd) rotated by positions 0..T-1."""
    T, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Causal GQA: q (T, H, hd), k / v (T, KV, hd) -> (T, H, hd)."""
    T, H, hd = q.shape
    KV = k.shape[1]
    rep = H // KV
    qg = q.view(T, KV, rep, hd).permute(1, 2, 0, 3) * hd ** -0.5    # (KV, rep, T, hd)
    kg, vg = k.permute(1, 0, 2), v.permute(1, 0, 2)                 # (KV, T, hd)
    out = []
    keys = torch.arange(T, device=q.device)
    for i in range(0, T, chunk):
        s = torch.einsum("grqd,gkd->grqk", qg[:, :, i:i + chunk], kg)
        rows = torch.arange(i, min(i + chunk, T), device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("grqk,gkd->grqd", p, vg))
    o = torch.cat(out, dim=2)                                       # (KV, rep, T, hd)
    return o.permute(2, 0, 1, 3).reshape(T, H, hd)


def _swiglu(pr: _Prec, x, w_gate, w_up, w_down):
    return pr.mm(F.silu(pr.mm(x, w_gate)) * pr.mm(x, w_up), w_down)


def _layer_weights(params: dict, cfg: dict, layer: int, pr: _Prec) -> Dict:
    p = params["segments"][0][0]
    d, H, KV = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    a = p["attn"]
    hd = a["wq"].shape[-1]
    w = {"norm1": p["norm1"][layer].float(), "norm2": p["norm2"][layer].float(),
         "wq": pr.weight(a["wq"][layer].reshape(d, H * hd), 0),
         "wk": pr.weight(a["wk"][layer].reshape(d, KV * hd), 0),
         "wv": pr.weight(a["wv"][layer].reshape(d, KV * hd), 0),
         "wo": pr.weight(a["wo"][layer].reshape(H * hd, d), 0)}
    if "moe" in p:
        m = p["moe"]
        w["router"] = m["w_router"][layer].float()
        w["experts"] = [pr.weight(m[n][layer], 1) for n in ("w_gate", "w_up", "w_down")]
        if "shared" in m:
            s = m["shared"]
            w["shared"] = [pr.weight(s[n][layer], 0) for n in ("w_gate", "w_up", "w_down")]
            w["shared_gate"] = pr.weight(m["w_shared_gate"][layer], 0)
    else:
        w["mlp"] = [pr.weight(p["mlp"][n][layer], 0) for n in ("w_gate", "w_up", "w_down")]
    return w


def _moe(x: torch.Tensor, w: Dict, cfg: dict, pr: _Prec) -> torch.Tensor:
    moe = cfg["moe"]
    probs = torch.softmax(x @ w["router"], dim=-1)
    top_w, top_ids = torch.topk(probs, moe["top_k"], dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    wg, wu, wd = w["experts"]
    for e in torch.unique(top_ids).tolist():
        rows, slot = (top_ids == e).nonzero(as_tuple=True)
        out = _swiglu(pr, x[rows], wg[e], wu[e], wd[e])
        y.index_add_(0, rows, out * top_w[rows, slot, None])
    if "shared" in w:
        y = y + _swiglu(pr, x, *w["shared"]) * torch.sigmoid(pr.mm(x, w["shared_gate"]))
    return y


def _block(h: torch.Tensor, w: Dict, cfg: dict, pr: _Prec) -> torch.Tensor:
    T = h.shape[0]
    H, KV = cfg["num_heads"], cfg["num_kv_heads"]
    eps, theta = float(cfg["norm_eps"]), float(cfg["rope_theta"])
    x = rms_norm(h, w["norm1"], eps)
    q = rope(pr.mm(x, w["wq"]).view(T, H, -1), theta)
    k = rope(pr.mm(x, w["wk"]).view(T, KV, -1), theta)
    v = pr.mm(x, w["wv"]).view(T, KV, -1)
    h = h + pr.mm(attention(q, k, v).reshape(T, -1), w["wo"])
    x = rms_norm(h, w["norm2"], eps)
    return h + (_moe(x, w, cfg, pr) if "router" in w else _swiglu(pr, x, *w["mlp"]))


def logits(params: dict, cfg: dict, sequences: Sequence[Sequence[int]], first_rows: Sequence[int],
           precision: str = "float32") -> List[torch.Tensor]:
    """For each token sequence, the float32 logits (rows, vocab_size) of its
    positions ``first_rows[i]`` .. len - 1 (the unpadded vocabulary)."""
    pr = _Prec(precision)
    emb = params["embed"]
    dev = emb.device
    V = int(cfg["vocab_size"])
    with torch.no_grad(), exact_float32():
        hs = [emb[torch.as_tensor(list(s), dtype=torch.long, device=dev)].float()
              for s in sequences]
        for layer in range(int(cfg["num_layers"])):
            w = _layer_weights(params, cfg, layer, pr)
            hs = [_block(h, w, cfg, pr) for h in hs]
            del w
        head = pr.weight(params["lm_head"][:, :V], 0)
        out = []
        for h, r in zip(hs, first_rows):
            x = rms_norm(h[int(r):], params["final_norm"], float(cfg["norm_eps"]))
            out.append(pr.mm(x, head))
        return out
