"""Mamba-2 (SSD, state-space duality) block: the port of the reference's
``src/repro/models/ssm.py``. [arXiv:2405.21060]

Plain functions on tensors, as the reference computes all of this in
``jnp`` outside any Pallas kernel: the chunked dual form for prefill and
training (``ssd_chunked``: the intra-chunk quadratic product, per-chunk
states and the inter-chunk recurrence) and the per-token recurrence for
decode, whose conv windows, inputs and readouts run for all T tokens at
once around a loop of state updates. Decode over T staged tokens returns *every*
per-step state, so a speculative verify can commit the state after the
accepted prefix. The states are
cumulative, so they follow one chain of tokens: tree drafts and carried
draft KV do not apply to these blocks (the engine and server refuse them).

The input projection is kept as separate matrices (``w_z``, ``w_x``,
``w_B``, ``w_C``, ``w_dt``), the reference's layout, so params cross the
bridge one to one.

State per layer (the cache's leaves; each carries a leading batch axis):
  ssm:     (B, nh, hd, ds)       recurrent state, float32 whatever the model's type
  conv_x:  (B, d_conv-1, din)    causal-conv tails, in the model's type
  conv_B:  (B, d_conv-1, g*ds)
  conv_C:  (B, d_conv-1, g*ds)
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import SSMConfig
from repro_torch.models import shard_utils as SU
from repro_torch.models.layers import Init, rms_norm

# the reference's deterministic leaves (not draws); they stay float32
# whatever the model's type
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")
STATE_LEAVES = ("ssm", "conv_x", "conv_B", "conv_C")


def ssm_init(d_model: int, s: SSMConfig, dtype: torch.dtype) -> dict:
    """The leaves of one Mamba-2 block, as the reference's ``ssm_init``
    (l.34) makes them (``Init``): the projections and conv kernels drawn,
    ``norm_w`` zeros, ``A_log``, ``D`` and ``dt_bias`` the reference's
    deterministic float32 values (``ssm_fixed``)."""
    din, nh = s.d_inner(d_model), s.num_heads(d_model)
    gds = s.ngroups * s.d_state
    sc = d_model ** -0.5
    return {
        "w_z": Init((d_model, din), sc, dtype),
        "w_x": Init((d_model, din), sc, dtype),
        "w_B": Init((d_model, gds), sc, dtype),
        "w_C": Init((d_model, gds), sc, dtype),
        "w_dt": Init((d_model, nh), sc, dtype),
        "conv_x": Init((s.d_conv, din), s.d_conv ** -0.5, dtype),
        "conv_B": Init((s.d_conv, gds), s.d_conv ** -0.5, dtype),
        "conv_C": Init((s.d_conv, gds), s.d_conv ** -0.5, dtype),
        "A_log": Init((nh,), None, torch.float32, functools.partial(ssm_fixed, "A_log")),
        "D": Init((nh,), None, torch.float32, functools.partial(ssm_fixed, "D")),
        "dt_bias": Init((nh,), None, torch.float32, functools.partial(ssm_fixed, "dt_bias")),
        "norm_w": Init((din,), None, dtype),
        "out_proj": Init((din, d_model), din ** -0.5, dtype),
    }


def ssm_fixed(name: str, n: int, device=None) -> torch.Tensor:
    """The reference's deterministic value of leaf ``name`` (float32, length
    ``n``): ``A_log`` log(linspace(1, 16)), ``D`` ones, ``dt_bias`` the
    inverse softplus of linspace(1e-3, 0.1); computed in float64 and
    rounded once."""
    if name == "A_log":
        v = torch.linspace(1.0, 16.0, n, dtype=torch.float64).log()
    elif name == "D":
        v = torch.ones(n, dtype=torch.float64)
    elif name == "dt_bias":
        v = torch.linspace(1e-3, 0.1, n, dtype=torch.float64).expm1().log()
    else:
        raise KeyError(name)
    return v.to(torch.float32).to(device)


def init_state(d_model: int, s: SSMConfig, batch: int, dtype: torch.dtype, device) -> dict:
    """A zero state of ``batch`` rows (the reference's fresh layer cache)."""
    din, nh = s.d_inner(d_model), s.num_heads(d_model)
    gds = s.ngroups * s.d_state
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, s.d_conv - 1, din), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, s.d_conv - 1, gds), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, s.d_conv - 1, gds), dtype=dtype, device=device),
    }


def _conv_full(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C), then SiLU."""
    K, S = w.shape[0], xs.shape[1]
    pads = F.pad(xs, (0, 0, K - 1, 0))
    out = pads[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pads[:, i:i + S] * w[i]
    return F.silu(out)


def _conv_continued(stream: torch.Tensor, tail: torch.Tensor, w: torch.Tensor):
    """The conv with a carried tail: (outputs aligned to ``stream``, the tail
    and the stream concatenated). The reference returns the new tail, the
    last K-1 rows; a decode stages the window after each token, rows
    t+1 .. t+K-1."""
    S = stream.shape[1]
    full = torch.cat([tail.to(stream.dtype), stream], dim=1)
    return _conv_full(full, w)[:, -S:], full


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L) lower-triangular segment sums,
    out[i, j] = sum_{j < t <= i} x_t, and -inf above the diagonal (the
    ``where`` comes before any ``exp``, as in the reference)."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(tri, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(
    x: torch.Tensor,           # (B, S, nh, hd) conv'd inputs
    dt: torch.Tensor,          # (B, S, nh) softplus'd
    A: torch.Tensor,           # (nh,) negative
    B_: torch.Tensor,          # (B, S, g, ds)
    C_: torch.Tensor,          # (B, S, g, ds)
    init_state: torch.Tensor,  # (B, nh, hd, ds)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in chunks of ``chunk``, in float32. Returns (y (B, S,
    nh, hd), final state (B, nh, hd, ds))."""
    Bsz, S, nh, hd = x.shape
    g, ds = B_.shape[2], B_.shape[3]
    rep = nh // g
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    nc, L = (S + pad) // chunk, chunk

    xc = x.reshape(Bsz, nc, L, nh, hd).float()
    dtc = dt.reshape(Bsz, nc, L, nh).float()
    Bc = B_.reshape(Bsz, nc, L, g, ds).float()
    Cc = C_.reshape(Bsz, nc, L, g, ds).float()

    dA = dtc * A                                          # (B, nc, L, nh)
    dA_cum = torch.cumsum(dA, dim=2)                      # within-chunk cumsum
    x_dt = xc * dtc[..., None]

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2)))       # (B, nc, nh, L, L)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    CB = CB.repeat_interleave(rep, dim=2)                 # groups -> heads
    y_diag = torch.einsum("bchls,bcshp->bclhp", CB * Lmat, x_dt)

    # per-chunk input states: sum_s B_s (x dt)_s decay_s
    decay = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)      # (B, nc, L, nh)
    Bh = Bc.repeat_interleave(rep, dim=3)                 # (B, nc, L, nh, ds)
    Ch = Cc.repeat_interleave(rep, dim=3)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh * decay[..., None], x_dt)

    # inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # (B, nc, nh)
    st = init_state.float()
    prev = []
    for c in range(nc):
        prev.append(st)                                   # the state BEFORE chunk c
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B, nc, nh, hd, ds)

    # the carried-in state's contribution
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * L, nh, hd)[:, :S]
    return y, st


def mamba_forward(
    params: dict,
    h: torch.Tensor,           # (B, S, d) block input (after the norm)
    d_model: int,
    s: SSMConfig,
    layer_cache: Optional[dict],   # {"ssm", "conv_x", "conv_B", "conv_C"}; None to train
    *,
    mode: str,                 # "train" | "prefill" | "decode"
) -> Tuple[torch.Tensor, dict]:
    """Returns (out (B, S, d), staged). ``staged`` holds the per-step states
    (B, T, ...) in decode mode, for the speculative commit; in prefill it
    holds the final states with a length-1 step axis. ``mode="train"`` is
    the prefill path over a fresh zero state (the reference's
    ``model._mamba_layer``, l.376-394), differentiable, staging nothing
    (``staged`` is empty).

    On a mesh whose ``model`` axis divides the head count
    (``shard_utils.mamba_sharded``) the params and states hold this rank's
    heads of d_inner: the replicated per-head leaves (``w_dt``, ``A_log``,
    ``D``, ``dt_bias``) and B/C groups are cut to them, the gated norm's
    mean over d_inner is summed over ``model``, and so is the
    ``out_proj`` product. In a training graph the replicated tensors cut
    to this rank's heads sum their gradients over ``model``
    (``shard_utils.enter_shards``), and so does the norm's sum of
    squares, whose consumers are this rank's heads."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mamba_forward: unknown mode {mode!r}")
    B, S, _ = h.shape
    if mode == "train":
        layer_cache = init_state(d_model, s, B, h.dtype, h.device)
    nh, hd, din = s.num_heads(d_model), s.head_dim, s.d_inner(d_model)
    g, ds, K = s.ngroups, s.d_state, s.d_conv
    tp = SU.mamba_sharded(nh)
    hs = SU.enter_shards(h) if tp else h
    z = hs @ params["w_z"]
    raw = [hs @ params["w_x"]] + [h @ params[n] for n in ("w_B", "w_C")]
    dt_raw = h @ params["w_dt"]
    A_log, D, dt_bias = params["A_log"], params["D"], params["dt_bias"]
    if tp:
        # this rank's heads of the replicated per-head leaves, and their groups
        nh_full, nh = nh, nh // SU.model_axis_size()
        h0, rep = SU.model_index() * nh, nh_full // g
        if not (nh % rep == 0 if nh >= rep else rep % nh == 0):
            raise ValueError(f"mamba_forward: {nh} local heads do not cover whole groups of {rep}")
        heads = slice(h0, h0 + nh)
        groups = slice(h0 // rep, (h0 + nh - 1) // rep + 1)
        din, g = nh * hd, groups.stop - groups.start
        dt_raw, A_log, D, dt_bias = (SU.enter_shards(t)[..., heads]
                                     for t in (dt_raw, A_log, D, dt_bias))
        if mode == "train":         # the fresh state of this rank's heads
            layer_cache = {"ssm": layer_cache["ssm"][:, heads],
                           "conv_x": layer_cache["conv_x"][..., :din],
                           "conv_B": layer_cache["conv_B"], "conv_C": layer_cache["conv_C"]}
    A = -torch.exp(A_log.float())                         # (nh,)
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    D = D.float()
    # the three causal convs (x, B, C) as one over their concatenated
    # channels, each continuing its carried tail
    widths = [r.shape[-1] for r in raw]
    out, full = _conv_continued(torch.cat(raw, dim=-1),
                                torch.cat([layer_cache[n] for n in STATE_LEAVES[1:]], dim=-1),
                                torch.cat([params[n] for n in STATE_LEAVES[1:]], dim=-1))
    xc, Bc, Cc = out.split(widths, dim=-1)
    x = xc.reshape(B, S, nh, hd).float()
    if tp:
        B_h = SU.enter_shards(Bc).reshape(B, S, s.ngroups, ds)[:, :, groups]
        C_h = SU.enter_shards(Cc).reshape(B, S, s.ngroups, ds)[:, :, groups]
    else:
        B_h, C_h = Bc.reshape(B, S, g, ds), Cc.reshape(B, S, g, ds)

    if mode == "decode":
        y, states = _recurrence(x, dt, A, B_h, C_h, layer_cache["ssm"])
        staged = {"ssm": states}
        tails = full.unfold(1, K - 1, 1)[:, 1:].transpose(2, 3)   # (B, T, K-1, C)
    else:
        y, final = ssd_chunked(x, dt, A, B_h, C_h, layer_cache["ssm"], s.chunk_size)
        staged = {"ssm": final[:, None]}
        tails = full[:, None, -(K - 1):]                      # (B, 1, K-1, C)
    for n, tail in zip(STATE_LEAVES[1:], tails.split(widths, dim=-1)):
        staged[n] = tail.contiguous()
    y = y + D[None, None, :, None] * x

    yf = y.reshape(B, S, din)
    if tp:
        out = _sharded_norm(yf * F.silu(z.float()), params["norm_w"], 1e-5, din * SU.model_axis_size())
        out = SU.all_sum(out.to(h.dtype) @ params["out_proj"])
    else:
        yf = rms_norm(yf * F.silu(z.float()), params["norm_w"], 1e-5)
        out = yf.to(h.dtype) @ params["out_proj"]
    return out, ({} if mode == "train" else staged)


def _sharded_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, width: int) -> torch.Tensor:
    """``layers.rms_norm`` of a tensor whose last dim is sharded over
    ``model``: the sum of squares is summed over the ranks, the mean taken
    over the full ``width``."""
    x32 = x.float()
    ms = SU.all_sum(x32.square().sum(dim=-1, keepdim=True), grad_sum=True) / width
    return (x32 * torch.rsqrt(ms + eps) * (1.0 + weight.float())).to(x.dtype)


def _recurrence(x, dt, A, B_h, C_h, ssm0):
    """The decode's state update over its T tokens (x (B, T, nh, hd), dt (B,
    T, nh), B_h / C_h (B, T, g, ds)): returns (y without the D skip (B, T,
    nh, hd) float32, every step's state (B, T, nh, hd, ds)). Only the update
    is sequential, two launches a token; the reference's per-token inputs
    and readouts are elementwise in t, or reduce over d_state alone, so they
    run for all T tokens at once with the same per-token arithmetic."""
    nh, g = x.shape[2], B_h.shape[2]
    dA = torch.exp(dt * A)                                    # (B, T, nh)
    Bx = torch.einsum("btgn,bthp->bthpn", B_h.float(), x * dt[..., None])
    states = torch.empty_like(Bx)
    st = ssm0.float()
    for t in range(x.shape[1]):
        st = torch.mul(st, dA[:, t, :, None, None], out=states[:, t])
        st.add_(Bx[:, t])
    C_n = C_h.float().repeat_interleave(nh // g, dim=2)       # groups -> heads
    return torch.einsum("bthpn,bthn->bthp", states, C_n), states
