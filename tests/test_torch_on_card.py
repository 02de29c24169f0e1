"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA GPU
(the kernels have no CPU mode). The module imports no JAX, so it is
collected on the card's machine, which has none:

    python -m pytest -q -m cuda tests/test_torch_on_card.py

Tolerances: the attention kernels compute with TF32 tensor-core products
(3xTF32 for float32 operands), within 1e-4 of the plain versions in float32
and bfloat16; the paged kernel is bitwise equal to the dense kernel on the
gathered view, and a launch that reads its live length from the committed
lengths over the whole cache is bitwise equal to a launch over the cache
cut to that length on the host; the W8A8 kernel adds exact int32 partial
sums and scales in the plain version's order, so it is bitwise equal
(tolerance 0); the tree kernel with a carried segment is within 1e-4 of
its plain version. The attention kernels are held at head dims 64, 128 and
288 and GQA reps 1 to 12, with a window mask over a cache four times the
window and over a ring cache scanned whole; another head dim raises. The
single-dispatch serving round, at vicuna-7b width
and reduced depth, captured as segment graphs with the draft (and chunked
prefill) behind conditional nodes: its replays equal eager rounds bitwise
with carried or recomputed draft KV and with chunked prefill, an eager
round makes no host sync, and a replay whose budgets need no draft runs
none of the draft's kernels and equals a PLD-only twin bitwise. Sampled
serving: the threefry key stream on the card is bitwise the CPU's, the
warp (``sampling_probs``) within 1e-6 of the CPU's with the same support,
sampled replays equal eager sampled rounds bitwise (dense tree_fused and
chunked-prefill paged chain_fused), an eager sampled round makes no host
sync, and a sampled build's segments launch the greedy build's kernels,
leaving a greedy build's segments as they were. Round telemetry: the
buffer a captured round adds to equals the eager rounds' bitwise, and
telemetry on or off launches and syncs alike. Training: two train steps
on the card within 1e-4 of the same steps on the CPU; two data=2 train
steps by two gloo ranks sharing the card (FSDP) equal to the one-device
steps. The grouped expert
GEMM of the MoE dispatch: within 1e-4 of its plain version in float32 and
within one bfloat16 ulp of the output (2^-7 of the value, plus 1e-4: the
float32 sums' order) in bfloat16, at qwen2-moe's shape and its model = 2
and 4 shard widths, at ragged shapes, with most experts empty, and with
one expert of 1, 63, 64, 65 and 130 rows about the bfloat16 kernel's
64-row tiles; the rows of N1 tokens bitwise equal when more tokens are
batched with them, before them in the same experts too (a later tile);
an expert starting inside its neighbour's tile leaves the neighbour's
rows, and a launch the rows in no segment, as they were; a captured
bfloat16 launch replayed over new rows and offsets equal to an eager one;
a captured single round of qwen2-moe at full width equal to eager rounds
bitwise. The Mamba-2 stacks
(mamba2-130m and jamba-v0.1-52b, reduced, 4 layers, float32): a captured
``chain_fused`` single round, dense and paged, equals eager rounds bitwise,
one graph launch a round, and its streams equal AR's on the card. The
codebook stack (musicgen-medium, reduced): a joint T=3 decode equals two
steps and a commit, then the third, within 1e-4, through the attention
kernels. MoE and Mamba-2 training (qwen2-moe-a2.7b and mamba2-130m,
reduced): five train steps give finite losses and a falling ce. The
analysis layer's contracts: a 2-layer single round's captured graph passes
every dispatch contract and a telemetry-off twin's differs in the tail
only; a graph captured with a device-to-host copy fails
``assert_no_host_transfers``. The mesh (``tests/torch_mesh_workers.py``):
two ``gloo`` ranks sharing the card give vicuna-7b's (reduced, 4 layers)
prefill and decode logits of a ``model=2`` shard within 1e-4 of the
one-device call, and a context-parallel ``decode_attention`` (kernel #1
over each rank's sequence slice, the cross-rank combine, the tree merge)
within 1e-5 of the unsliced call; an ``all_reduce`` of a one-rank NCCL
group captured in a CUDA graph replays with the eager result.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import tree_attention as ta  # noqa: E402
from torch_inputs import (  # noqa: E402
    attention_inputs,
    bounded_inputs,
    close,
    int8_inputs,
    moe_routing,
    moe_sorted,
    moe_weights,
    paged_inputs,
    tensors,
    warp_cases,
)

pytestmark = pytest.mark.cuda
ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_match_plain_on_card(dtype):
    dev = _card()
    q, k, v, kv_pos, q_pos, kn, vn, tmask = tensors(*attention_inputs(2, 4, 2, 8, 300, 128, pos=250))
    dt = getattr(torch, dtype)
    q, k, v, kn, vn = (a.to(dev, dt) for a in (q, k, v, kn, vn))
    kv_pos, q_pos, tmask = kv_pos.to(dev), q_pos.to(dev), tmask.to(dev)
    tree = ta.tree_attention_partial(q, kn, vn, tmask)
    for g, w in zip(tree, ref.tree_attention_partial(q, kn, vn, tmask)):
        close(g.cpu(), w.cpu(), ATOL)
    got = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
    want = ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kn, vn, tmask)
    close(got.cpu(), want.cpu(), ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,rep,T,S", [
    (128, 1, 5, 300),       # R = 5: one padded 16-row tile; S not a multiple of the 32-slot key tile
    (128, 1, 16, 300),      # R = 16: one full row tile
    (128, 1, 32, 2048),     # R = 32: two m16 tiles in one CTA, the main path's verify
    (128, 8, 8, 300),       # R = 64 (GQA rep 8): two 32-row CTAs per head
    (128, 4, 8, 300),
    (128, 6, 32, 300),      # internlm2-20b: GQA rep 6, R = 192
    (128, 12, 32, 300),     # starcoder2-3b: GQA rep 12, R = 384
    (64, 1, 5, 300),        # stablelm-1.6b: hd 64
    (64, 1, 32, 2048),
    (288, 4, 16, 300),      # gemma3-1b: hd 288, MQA rep 4, R = 64 in four 16-row CTAs
    (288, 4, 5, 2048),      # R = 20
])
def test_attention_kernels_at_tile_edges_on_card(dtype, hd, rep, T, S):
    """The tensor-core kernels at the row and key tiles' edges, at every
    instantiated head dim and the served GQA reps, with a fully masked
    cache row and a fully masked tree row, against the plain twins."""
    dev = _card()
    q, k, v, kv_pos, q_pos, kn, vn, tmask = attention_inputs(2, 2, rep, T, S, hd, pos=S - 21, seed=6)
    tmask[1, 1] = False                                  # a fully masked tree row
    dt = getattr(torch, dtype)
    q, k, v, kn, vn = (a.to(dev, dt) for a in tensors(q, k, v, kn, vn))
    kv_pos, q_pos, tmask = (a.to(dev) for a in tensors(kv_pos, q_pos, tmask))
    tree = ta.tree_attention_partial(q, kn, vn, tmask)
    want_t = ref.tree_attention_partial(q, kn, vn, tmask)
    for g, w in zip(tree, want_t):
        close(g.cpu(), w.cpu(), ATOL)
    got = fd.flash_decode_partial(q, k, v, kv_pos, q_pos)
    want = ref.flash_decode_partial(q, k, v, kv_pos, q_pos)
    close((got[0] / got[2][..., None]).cpu(), (want[0] / want[2][..., None]).cpu(), ATOL)
    close(got[1].cpu(), want[1].cpu(), ATOL)
    assert float(got[2][0, 0, 0]) == S                   # the masked row averages every slot
    merged = fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree)
    close(merged.cpu(), ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kn, vn, tmask).cpu(), ATOL)


# ------------------------------------------------------------- paged attention
def _paged(x, names, dev, dtype=None):
    return [a.to(dev, dtype) if dtype else a.to(dev) for a in tensors(*(x[n] for n in names))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(dtype):
    dev = _card()
    x = paged_inputs(B=2, KV=4, rep=1, T=32, hd=128, P=16, n_pp=6)
    q, kp, vp = _paged(x, ("q", "k_pages", "v_pages"), dev, getattr(torch, dtype))
    table, kv_pos, q_pos = _paged(x, ("table", "kv_pos", "q_pos"), dev)
    got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    for g, w in zip(got, want):
        close((g / got[2][..., None] if g.ndim == 4 else g).cpu(),
              (w / want[2][..., None] if w.ndim == 4 else w).cpu(), ATOL)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    dense = fd.flash_decode_partial(q, k, v, kv_pos, q_pos)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,rep,T", [(16, 1, 5), (64, 1, 16), (16, 1, 32), (64, 8, 8)])
def test_paged_kernel_tile_edges_on_card(dtype, P, rep, T):
    """Pages of 16 (two per key tile) and 64 (two key tiles per page) at
    R = 5, 16, 32 and 64 rows, ragged live lengths and a -1 tail, a fully
    masked row: within 1e-4 of the plain version and bitwise equal to the
    dense kernel on the gathered view, partials and merged output."""
    dev = _card()
    x = paged_inputs(B=2, KV=2, rep=rep, T=T, hd=128, P=P, n_pp=300 // P + 1, seed=5)
    q, kp, vp, kn, vn = _paged(x, ("q", "k_pages", "v_pages", "k_new", "v_new"), dev,
                               getattr(torch, dtype))
    table, kv_pos, q_pos, tmask = _paged(x, ("table", "kv_pos", "q_pos", "tmask"), dev)
    got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos)
    close((got[0] / got[2][..., None]).cpu(), (want[0] / want[2][..., None]).cpu(), ATOL)
    close(got[1].cpu(), want[1].cpu(), ATOL)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    for g, w in zip(got, fd.flash_decode_partial(q, k, v, kv_pos, q_pos)):
        assert torch.equal(g, w)
    tree = ref.tree_attention_partial(q, kn, vn, tmask)
    paged = fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree)
    assert torch.equal(paged, fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree))
    close(paged.cpu(), ref.merge_partials(want, tree).cpu(), ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,n_pp,pos", [
    (1, 32, 32, (160,)),                # the single-stream verify: 160 live slots of 2048
    (4, 16, 16, (232, 168, 104, 40)),   # the server's tree verify over a 1024-slot cache
    (4, 5, 16, (232, 168, 104, 40)),    # its chain verify
    (2, 32, 4, (1, 0)),                 # a one-slot prefix beside an empty slot
])
def test_device_bound_equals_host_cut_on_card(dtype, B, T, n_pp, pos):
    """Dense and paged launches over the whole cache that read their live
    length from ``bound`` equal, bit for bit, a dense launch over the cache
    cut on the host to L = max(1, max(pos)): partials and merged output."""
    dev = _card()
    x = bounded_inputs(B, 32, T, 64, n_pp, pos)
    q, kp, vp, kn, vn = _paged(x, ("q", "k_pages", "v_pages", "k_new", "v_new"), dev,
                               getattr(torch, dtype))
    table, kv_pos, q_pos, tmask = _paged(x, ("table", "kv_pos", "q_pos", "tmask"), dev)
    bound = torch.tensor(pos, dtype=torch.int32, device=dev)
    L = max(max(pos), 1)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    cut = (k[:, :, :L], v[:, :, :L], kv_pos[:, :L].contiguous(), q_pos)
    tree = ref.tree_attention_partial(q, kn, vn, tmask)
    want = fd.flash_decode_partial(q, *cut)
    want_m = fd.flash_decode_merge(q, *cut, tree)
    for got, got_m in (
            (fd.flash_decode_partial(q, k, v, kv_pos, q_pos, bound=bound),
             fd.flash_decode_merge(q, k, v, kv_pos, q_pos, tree, bound=bound)),
            (fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, bound=bound),
             fd.flash_decode_paged_merge(q, kp, vp, table, kv_pos, q_pos, tree, bound=bound))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(got_m, want_m)
    close(want_m.cpu(), ref.ref_verify_attention(q, k, v, kv_pos, q_pos, kn, vn, tmask).cpu(),
          ATOL)


# ------------------------------------------- head dims other than 128, windows
def test_other_head_dims_raise_on_card():
    dev = _card()
    q, k, v, kv_pos, q_pos, kn, vn, tmask = tensors(*attention_inputs(1, 1, 1, 4, 64, 96, pos=40))
    q, k, v, kn, vn, kv_pos, q_pos, tmask = (a.to(dev) for a in (q, k, v, kn, vn, kv_pos, q_pos,
                                                                 tmask))
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128, 288\)"):
        fd.flash_decode_partial(q, k, v, kv_pos, q_pos)
    with pytest.raises(ValueError, match=r"head_dim in \(64, 128, 288\)"):
        ta.tree_attention_partial(q, kn, vn, tmask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,rep", [(288, 4), (64, 1), (128, 6)])
def test_window_mask_past_the_window_on_card(dtype, hd, rep):
    """The window kind over a cache four times longer than the window
    (gemma3's sliding layers past 1024 tokens): dense and paged partials
    against the plain twin, and paged bitwise equal to dense on the
    gathered view."""
    dev = _card()
    x = paged_inputs(B=2, KV=1, rep=rep, T=8, hd=hd, P=64, n_pp=8, seed=8)
    q, kp, vp = _paged(x, ("q", "k_pages", "v_pages"), dev, getattr(torch, dtype))
    table, kv_pos, q_pos = _paged(x, ("table", "kv_pos", "q_pos"), dev)
    kw = dict(kind="window", window=128)
    got = fd.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, **kw)
    want = ref.flash_decode_paged_partial(q, kp, vp, table, kv_pos, q_pos, **kw)
    close((got[0] / got[2][..., None]).cpu(), (want[0] / want[2][..., None]).cpu(), ATOL)
    close(got[1].cpu(), want[1].cpu(), ATOL)
    k, v = (ref.paged_gather(p, table).transpose(1, 2) for p in (kp, vp))
    for g, w in zip(got, fd.flash_decode_partial(q, k, v, kv_pos, q_pos, **kw)):
        assert torch.equal(g, w)
    assert float(want[2][0, 0, -1]) < 129                # the window cut the visible slots


@pytest.mark.parametrize("hd", [64, 288])
def test_ring_decode_attention_on_card(hd):
    """A ring cache of window slots (a sliding layer's ``ring_window``
    cache), scanned whole by the flash-decode kernel: equal to the CPU's
    plain scan within 1e-4."""
    from repro_torch.models import attention as attn

    dev = _card()
    rng = np.random.default_rng(9)
    B, T, H, KV, W = 2, 8, 4, 1, 64
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, kn, vn, kc, vc = f(B, T, H, hd), f(B, T, KV, hd), f(B, T, KV, hd), f(B, W, KV, hd), f(B, W, KV, hd)
    cache_pos = torch.tensor([200, 70], dtype=torch.int32)
    q_pos = cache_pos[:, None] + torch.tensor([0, 1, 1, 2, 2, 3, 4, 5], dtype=torch.int32)
    tm = torch.tril(torch.ones(T, T, dtype=torch.bool))
    tm[3, 2] = False
    args = (q, kc, vc, cache_pos, kn, vn, q_pos)
    kw = dict(kind="window", window=W, ring=True)
    want = attn.decode_attention(*args, tree_mask=tm, **kw)
    got = attn.decode_attention(*(a.to(dev) for a in args), tree_mask=tm.to(dev), **kw)
    close(got.cpu(), want, ATOL)


# ------------------------------------------------------------- serving rounds
ROUND_LAYERS = 4


@functools.lru_cache(maxsize=None)
def _round_model(layers: int = ROUND_LAYERS):
    """vicuna-7b at full width (head dim 128, the kernels' only one) and
    ``layers`` layers, float32, random weights from seed 0."""
    from repro_torch.config import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=layers, dtype="float32")
    return cfg, init_params(cfg, 0)


def _round_server(mode, paged, draft=True, **kw):
    """A single-mode server on the card (its round captured as a CUDA graph
    at build) with four prompts admitted. The drafter keeps every layer at
    a cheap cost prior, so that its drafts are accepted and it keeps
    drafting; ``draft=False`` serves with PLD alone."""
    from repro_torch.core.dsia import DraftSpec
    from repro_torch.serving import BatchedSpecServer

    cfg, params = _round_model()
    spec = DraftSpec("self_draft", gates=(1,) * ROUND_LAYERS, prior_alpha=0.6, prior_c=0.2)
    args = dict(max_batch=4, max_len=512, draft_k=4, tree_expansions=5, adaptive=True,
                min_obs=1, round_mode="single")
    args.update(kw)
    srv = BatchedSpecServer(cfg, params, mode=mode, draft_spec=spec if draft else None,
                            paged=paged, page_size=64, **args)
    rng = np.random.default_rng(1)
    for b, n in enumerate((40, 100, 7, 64)):
        srv.add_request(b, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32))
    return srv


def _cache_leaves(srv):
    from repro_torch.models.model import tree_map

    leaves = []
    tree_map(leaves.append, srv.cache)
    return leaves


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_graph_replay_equals_eager_rounds_on_card(mode, paged):
    """N launches of the assembled round (carried draft KV, the default)
    leave the tokens, pos, ctx and every cache leaf bitwise equal to N
    eager rounds of a twin server; the draft's kernels are counted for the
    rounds that ran it."""
    _card()
    graph, eager = _round_server(mode, paged), _round_server(mode, paged)
    assert graph.draft_kv == "carry" and graph._graph is not None
    _assert_replays_equal_eager(graph, eager, 6)
    assert graph.stats["draft_rounds"] > 0
    assert graph.segment_launches["draft"]["tree_attention"] > 0
    assert graph.graph_launches == {
        k: 6 * v + graph.stats["draft_rounds"] * graph.segment_launches["draft"][k]
        for k, v in graph.replay_launches.items()}


def _assert_replays_equal_eager(graph, eager, rounds):
    eager._graph = None                         # step() runs the round eagerly
    for r in range(rounds):
        assert graph.step() == eager.step(), f"round {r}"
    assert graph.flush() == eager.flush()
    for stat in ("draft_rounds", "prefill_rounds", "tokens"):
        assert graph.stats[stat] == eager.stats[stat], stat
    for name in graph.dstate:
        assert torch.equal(graph.dstate[name], eager.dstate[name]), name
    for a, b in zip(_cache_leaves(graph), _cache_leaves(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["tree_fused", "chain_fused"])
def test_captured_telemetry_equals_eager_on_card(mode):
    """The round telemetry buffer rides the captured tail segment: after
    six replays it is bitwise the eager rounds' buffer and the fold of the
    drained ring; a telemetry-off twin launches the graph and reads the
    host as often, with the same kernels and tokens."""
    _card()
    graph, eager = _round_server(mode, False), _round_server(mode, False)
    _assert_replays_equal_eager(graph, eager, 6)
    for name, value in graph._telem_dev.items():
        assert torch.equal(value, eager._telem_dev[name]), name
    totals = graph.telemetry_totals()
    for name, value in graph.ring_totals.items():
        assert np.array_equal(totals[name], value), name
    assert int(totals["rounds"].sum()) == 6 * 4 and int(totals["accepted"].sum()) == (
        graph.stats["tokens"])
    off = _round_server(mode, False, telemetry=False)
    assert off._telem_dev is None
    for _ in range(6):
        off.step()
    off.flush()
    for stat in ("graph_replays", "round_dispatches", "host_syncs", "tokens", "draft_rounds"):
        assert off.stats[stat] == graph.stats[stat], stat
    assert off.graph_launches == graph.graph_launches
    for name in graph.dstate:
        assert torch.equal(off.dstate[name], graph.dstate[name]), name
    for a, b in zip(_cache_leaves(off), _cache_leaves(graph)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,paged", [("tree_fused", False), ("chain_fused", True)],
                         ids=["tree_dense", "chain_paged"])
def test_round_graph_passes_its_contracts_on_card(mode, paged):
    """A 2-layer single-round server at vicuna-7b width, six rounds: its
    assembled round graph, walked node by node, passes every dispatch
    contract (``analysis.contracts.check_round``: no host node or host
    transfer, the draft behind its IF node, each segment's hand-kernel
    nodes as its wrappers counted, no collective, no copy of the cache, the
    cache and state in place and nothing left live by the capture), and a
    telemetry-off twin's graph differs in the tail segment only."""
    from repro_torch.analysis import contracts as K
    from repro_torch.core.dsia import DraftSpec
    from repro_torch.serving import BatchedSpecServer

    _card()
    cfg, params = _round_model(2)
    spec = DraftSpec("self_draft", gates=(1, 1), prior_alpha=0.6, prior_c=0.2)

    def served(**kw):
        srv = BatchedSpecServer(cfg, params, mode=mode, draft_spec=spec, paged=paged,
                                page_size=64, max_batch=4, max_len=1024, draft_k=4,
                                tree_expansions=5, adaptive=True, min_obs=1, round_mode="single",
                                **kw)
        rng = np.random.default_rng(1)
        for b, n in enumerate((40, 100, 7, 64)):
            srv.add_request(b, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32))
        for _ in range(6):
            srv.step()
        srv.flush()
        return srv

    on, off = served(), served(telemetry=False)
    cons = K.check_round(on)
    con = cons["round"]
    assert list(cons) == ["round"] and con.n_if == 1
    assert con.segments == (("prologue", False), ("draft", True), ("tail", False))
    assert con.kernel_counts("draft")["tree_attention"] == on.segment_launches["draft"][
        "tree_attention"] > 0
    assert con.kernel_counts()["set_cond"] == 1
    added = K.assert_telemetry_transparent(K.server_round_contracts(off), cons)
    assert added.get("kernel", 0) > 0
    # the first capture of the process may leave cuBLAS's workspace live;
    # the second leaves next to nothing
    assert off.graph_live_bytes < 2 ** 20 and off.graph_pool_bytes == sum(
        off.segment_pool_bytes.values())


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "dropped"])
def test_cache_copy_fails_the_contract_on_card(keep):
    """A 2-layer single-round server whose captured tail clones every cache
    tensor fails its contracts: a clone it keeps fails ``assert_donated``
    (the capture left a cache's bytes live in the graph's pool), and kept or
    dropped, the clone's memcpy nodes fail ``assert_no_cache_copy``."""
    from repro_torch.analysis import contracts as K
    from repro_torch.core.dsia import DraftSpec
    from repro_torch.serving import BatchedSpecServer

    class Cloning(BatchedSpecServer):
        def _seg_tail(self, mid):
            super()._seg_tail(mid)
            if torch.cuda.is_current_stream_capturing():
                copy = [t.clone() for t in _cache_leaves(self)]
                if keep:
                    self._shadow = copy

    _card()
    cfg, params = _round_model(2)
    spec = DraftSpec("self_draft", gates=(1, 1), prior_alpha=0.6, prior_c=0.2)
    srv = Cloning(cfg, params, mode="tree_fused", draft_spec=spec, max_batch=4, max_len=1024,
                  draft_k=4, tree_expansions=5, adaptive=True, min_obs=1, round_mode="single")
    cache = [v for k, v in srv.capture_ptrs.items() if k.startswith("cache")]
    con = K.server_round_contracts(srv)["round"]
    assert con.cache_copy_bytes(cache) >= sum(n for _, n in cache)
    with pytest.raises(K.ContractViolation, match="second copy"):
        con.assert_no_cache_copy(cache)
    if keep:
        with pytest.raises(K.ContractViolation, match="second copy"):
            K.assert_donated(srv.capture_ptrs, srv.state_ptrs(), srv.graph_live_bytes)
    else:
        K.assert_donated(srv.capture_ptrs, srv.state_ptrs(), srv.graph_live_bytes)
    with pytest.raises(K.ContractViolation, match="second copy"):
        K.check_round(srv)


def test_host_transfer_fails_the_contract_on_card():
    """A graph captured with a device-to-host copy into pinned memory shows
    a DtoH memcpy node and fails ``assert_no_host_transfers``; the same
    graph without the copy passes."""
    from repro_torch.analysis import contracts as K

    _card()
    x = torch.ones(1024, device="cuda")
    host = torch.empty(1024, pin_memory=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for copy in (False, True):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            y = x * 2
            if copy:
                host.copy_(y, non_blocking=True)
        graphs.append(g)
    clean, leaky = (K.GraphContract.from_graph(g) for g in graphs)
    clean.assert_no_host_callbacks().assert_no_host_transfers()
    assert clean.node_counts.get("kernel", 0) >= 1 and "memcpy" not in clean.node_counts
    assert [n.name for n in leaky.nodes if n.kind == "memcpy"] == ["DtoH"]
    with pytest.raises(K.ContractViolation, match="host end"):
        leaky.assert_no_host_transfers()


def test_recompute_replay_equals_eager_rounds_on_card():
    _card()
    graph, eager = (_round_server("tree_fused", False, draft_kv="recompute") for _ in range(2))
    _assert_replays_equal_eager(graph, eager, 4)
    assert graph.stats["draft_rounds"] > 0


def test_chunked_prefill_replay_equals_eager_rounds_on_card():
    """A paged server with prefill_chunk=64 (the 100-token prompt takes two
    rounds): replays equal eager rounds bitwise, and the prefill segment's
    kernels are counted for the rounds that ran it."""
    _card()
    graph, eager = (_round_server("chain_fused", True, prefill_chunk=64) for _ in range(2))
    assert [name for name, _, _ in graph._plan()][:2] == ["prefill_pred", "prefill"]
    _assert_replays_equal_eager(graph, eager, 6)
    assert graph.stats["prefill_rounds"] == 2
    assert graph.graph_launches["flash_decode_paged"] == (
        6 * graph.replay_launches["flash_decode_paged"]
        + 2 * graph.segment_launches["prefill"]["flash_decode_paged"]
        + graph.stats["draft_rounds"] * graph.segment_launches["draft"]["flash_decode_paged"])


def test_eager_round_makes_no_host_sync_on_card():
    _card()
    srv = _round_server("tree_fused", True, sync_every=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv._round()
        srv._round()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    srv._inflight = 2
    out = srv.flush()
    assert srv.stats["draft_rounds"] == 2 and all(len(t) >= 2 for t in out.values())


def _device_kernels(fn, by_name: bool = False):
    """Device activities (kernels, copies, memsets) the profiler records
    while ``fn`` runs, synchronised: their count, or with ``by_name`` a
    Counter of them by name."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = collections.Counter({e.key: e.count for e in prof.key_averages()
                                 if e.device_type == torch.autograd.DeviceType.CUDA})
    return names if by_name else sum(names.values())


def test_draft_with_every_budget_covered_changes_nothing_on_card():
    """The reference skips the draft where no budget needs it, and so does
    the assembled round. With every budget at 0 (warmed-up estimators at
    alpha 0) a replay reports that no budget needed the draft, runs none of
    the draft's kernels (no more device activities than the PLD-only twin's
    replay, the set_cond kernel and the budget arithmetic of the drafter's
    prologue), and its tokens, state and cache equal those of a twin server
    whose rounds have no drafter at all (PLD only)."""
    from repro_torch.core import engine

    _card()
    srv, plain = _round_server("tree_fused", False), _round_server("tree_fused", False,
                                                                      draft=False)
    counts, names, out = [], [], {}
    for _ in range(3):
        srv.dstate["hist_n"].fill_(5)           # warmed up: budgets follow alpha
        srv.dstate["alpha"].fill_(0.0)
        assert [srv._slot_tree_budget(b) for b in range(4)] == [0] * 4
        names.append(tuple(_device_kernels(lambda s=s: out.update({s: s.step()}), by_name=True)
                           for s in (srv, plain)))
        counts.append(tuple(sum(n.values()) for n in names[-1]))
        assert out[srv] == out[plain]
    assert srv.stats["draft_rounds"] == 0
    for name in ("pending", "ctx"):
        assert torch.equal(srv.dstate[name], plain.dstate[name]), name
    for a, b in zip(_cache_leaves(srv), _cache_leaves(plain)):
        assert torch.equal(a, b)
    # the budget arithmetic the drafter's prologue adds, eagerly
    kw = dict(draft_k=srv.k, expansions=srv.tree_expansions, bucket=srv.tree_bucket,
              pld_alpha=0.3, adaptive=True, min_obs=srv.min_obs, t_min=srv.t_min)
    budget_names = [_device_kernels(lambda u=u: engine.tree_prologue(
        srv.cache, dict(srv.dstate), srv._c_dev, use_draft=u, **kw), by_name=True)
        for u in (True, False)]
    budget = [sum(n.values()) for n in budget_names]
    # the profiler's counts, shown by pytest where an assertion below fails:
    # the activities the skipped replay adds to the PLD-only one, by name,
    # and those the eager prologue adds with the drafter's budget
    print(f"device activities per replay (skipped, PLD-only): {counts}; prologue with and "
          f"without the drafter's budget: {budget}; the replay's extra activities "
          f"{dict(names[0][0] - names[0][1])}; the prologue's {dict(budget_names[0] - budget_names[1])}")
    for skipped, pld_only in counts:
        assert skipped <= pld_only + 1 + budget[0] - budget[1], (skipped, pld_only, budget)
    # a replay that drafts runs the draft's kernels
    srv.dstate["hist_n"].fill_(0)
    drafting = _device_kernels(srv.step)
    assert drafting > counts[0][0] + 100, (drafting, counts[0][0])


def test_two_segment_tree_kernel_matches_plain_on_card():
    """The tree kernel over [carried ++ new] keys at the draft's carry
    shapes (4 slots, 32 heads: a tree step's 2 new nodes over a 16-node
    bucket, a chain step's 1 token over 5 rows), strided views of the
    (B, N, KV, hd) buffers, with a row that sees no carried key."""
    dev = _card()
    rng = np.random.default_rng(9)
    for dtype in (torch.float32, torch.bfloat16):
        for T, N_s in ((2, 16), (1, 5), (5, 32)):
            B, KV, hd = 4, 32, 128
            f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)  # noqa: E731
            q = f(B, KV, T, hd)
            kn, vn = (f(B, T, KV, hd).transpose(1, 2) for _ in range(2))
            ks, vs = (f(B, N_s, KV, hd).transpose(1, 2) for _ in range(2))
            tmask = torch.eye(T, dtype=torch.bool, device=dev)[None].expand(B, T, T).contiguous()
            smask = torch.from_numpy(rng.random((B, T, N_s)) < 0.5).to(dev)
            smask[0, 0] = False
            seg2 = dict(k_staged=ks, v_staged=vs, staged_mask=smask)
            got = ta.tree_attention_partial(q, kn, vn, tmask, **seg2)
            want = ref.tree_attention_partial(q, kn, vn, tmask, **seg2)
            torch.cuda.synchronize()
            close((got[0] / got[2][..., None]).cpu(), (want[0] / want[2][..., None]).cpu(), ATOL)
            close(got[1].cpu(), want[1].cpu(), ATOL)
            close((got[2] / want[2]).cpu(), np.ones(tuple(want[2].shape)), ATOL)


# ------------------------------------------------------------- W8A8
def test_int8_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(5)
    x_q, w_q = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8)).to(dev)
                for s in ((40, 256), (256, 192)))
    xs = torch.rand(40, 1, device=dev)
    ws = torch.rand(1, 192, device=dev)
    torch.testing.assert_close(i8.int8_matmul(x_q, w_q, xs, ws),
                               ref.ref_int8_matmul(x_q, w_q, xs, ws), rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _weights(K, N):
    _, w_q, _, ws = int8_inputs(1, K, N, seed=K + N)
    return torch.from_numpy(w_q).cuda(), torch.from_numpy(ws).cuda()


def _int8_case(M, K, N):
    """M rows of x and their scales, and the (K, N) weight shared by every M."""
    x_q, _, xs, _ = int8_inputs(M, K, 64, seed=M + K)
    w_q, ws = _weights(K, N)
    return torch.from_numpy(x_q).cuda(), w_q, torch.from_numpy(xs).cuda(), ws


@pytest.mark.parametrize("K,N", [(4096, 11008), (11008, 4096), (256, 192)])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 20, 32, 40, 64, 96, 128])
def test_int8_kernel_bitwise_at_decode_rows_on_card(M, K, N):
    """Every row count the decode path runs (chain steps of 1-4 rows, the
    cascade drafter's carry steps of B=4 x 2 = 8, tree steps and B=4 x T=5
    verifies of 16-20, T=32, B=4 x T=16, its seed block of B=4 x 32 = 128
    in two 64-row tiles, and ragged 17, 40, 96 across row tiles) at both
    MLP shapes and a small one whose second 128-column strip ends half way:
    bitwise equal to the plain version. The plan splits K unevenly at the
    MLP shapes."""
    _card()
    x_q, w_q, xs, ws = _int8_case(M, K, N)
    got = i8.int8_matmul(x_q, w_q, xs, ws)
    assert torch.equal(got, ref.ref_int8_matmul(x_q, w_q, xs, ws))


@pytest.mark.parametrize("M,K,N,bm,splits", [
    (20, 4096, 11008, 32, 7),     # 64 K tiles in 7 ranges of 9-10
    (4, 11008, 4096, 16, 1),      # no split: the whole K in one CTA, no workspace
    (40, 256, 192, 16, 3),        # three 16-row tiles, the last partial; ranges of 1, 1, 2
    (96, 11008, 4096, 64, 13),    # 172 K tiles in ranges of 13-14, two row tiles
])
def test_int8_kernel_bitwise_under_forced_plans_on_card(M, K, N, bm, splits):
    """Launch plans the wrapper would not pick: row tiles smaller than M
    and split counts that cut K anywhere, all bitwise equal."""
    _card()
    x_q, w_q, xs, ws = _int8_case(M, K, N)
    got = i8._launch(x_q, w_q, xs, ws, bm, splits)
    assert torch.equal(got, ref.ref_int8_matmul(x_q, w_q, xs, ws))


@pytest.mark.parametrize("M", [8, 128])
def test_prequantized_product_bitwise_equals_dynamic_on_card(M):
    """A weight quantized once (the cascade bank's int8 level) gives the
    per-call ``quantized_matmul`` bit for bit, through the kernel."""
    dev = _card()
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn(M, 4096, generator=gen, device=dev)
    w = torch.randn(4096, 11008, generator=gen, device=dev) / 64
    before = i8.launches
    got = ops.quantized_matmul(x, ops.prequantize(w))
    assert i8.launches == before + 1
    assert torch.equal(got, ops.quantized_matmul(x, w))


# ------------------------------------------------------------- the cascade
def test_cascade_server_on_card():
    """``cascade_fused`` (the default mixing hierarchy) at vicuna-7b width
    and two layers: ``int8_exec="auto"`` resolves to the kernel on CUDA,
    every stream equals AR, and the int8 level launches the W8A8 kernel."""
    _card()
    from repro_torch.core import SpecEngine
    from repro_torch.serving import BatchedSpecServer

    cfg, params = _round_model(2)
    srv = BatchedSpecServer(cfg, params, mode="cascade_fused", max_batch=2, max_len=256,
                            min_obs=1)
    assert srv.bank.int8_exec == "kernel" and srv.bank.drafter.quantize == "int8"
    assert srv.bank.param_bytes > 0
    rng = np.random.default_rng(2)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, size=n), 3).astype(np.int32)
               for n in (6, 11)]
    for b, p in enumerate(prompts):
        srv.add_request(b, p)
    before = i8.launches
    gen = {0: [], 1: []}
    for _ in range(6):
        for b, toks in srv.step().items():
            gen[b].extend(toks)
    assert i8.launches > before and srv.stats["draft_dispatches"] > 0
    for b, p in enumerate(prompts):
        eng = SpecEngine(cfg, params, max_len=256)
        eng.start(p)
        assert gen[b] == eng.generate_ar(len(gen[b])), f"slot {b} left AR"


# ------------------------------------------------------------- sampled serving
def _stoch():
    from repro_torch.serving.sampler import SamplingParams

    # no seed: each request's key is fold_in(base key, admission count)
    return SamplingParams(temperature=0.8, top_k=20, top_p=0.9)


def _bits(t):
    return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()


def test_prng_on_card_bitwise_equals_cpu():
    from repro_torch.core import prng, verify

    dev = _card()
    assert torch.equal(prng.prng_key(2**31 - 1, device=dev).cpu(), prng.prng_key(2**31 - 1))
    keys = prng.split(prng.prng_key(11), 4)
    kd = keys.to(dev)
    pairs = [(prng.split(kd, n), prng.split(keys, n)) for n in (2, 5)]
    pairs += [(prng.fold_in(kd, d), prng.fold_in(keys, d)) for d in range(6)]
    pairs += [(prng.uniform(kd, n), prng.uniform(keys, n)) for n in (1, 5, 33)]
    pairs += list(zip(verify.round_uniforms(kd, 33), verify.round_uniforms(keys, 33)))
    for got, want in pairs:
        assert got.device.type == "cuda" and torch.equal(_bits(got), _bits(want))


def test_sampling_probs_on_card_matches_cpu():
    from repro_torch.core import verify

    dev = _card()
    rng = np.random.default_rng(8)
    big = (rng.normal(size=(4, 32, 32000)).astype(np.float32) * 3,
           np.array([0.8, 0.0, 1.0, 0.6], np.float32), np.array([20, 0, 0, 50], np.int32),
           np.array([0.9, 1.0, 0.5, 1.0], np.float32))
    for case in (warp_cases(), big):
        cpu = tensors(*case)
        want = verify.sampling_probs(*cpu)
        got = verify.sampling_probs(*(t.to(dev) for t in cpu)).cpu()
        assert torch.equal(got > 0, want > 0)
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("case", ["tree_fused dense", "chain_fused paged chunked"])
def test_sampled_replay_equals_eager_rounds_on_card(case):
    _card()
    mode, paged, kw = (("tree_fused", False, {}) if case == "tree_fused dense"
                       else ("chain_fused", True, dict(prefill_chunk=64)))
    graph, eager = (_round_server(mode, paged, sampling=_stoch(), **kw) for _ in range(2))
    keys = graph.dstate["key"].clone()
    _assert_replays_equal_eager(graph, eager, 6)
    assert not torch.equal(graph.dstate["key"], keys)
    if paged:
        assert graph.stats["prefill_rounds"] == 2


def test_eager_sampled_round_makes_no_host_sync_on_card():
    _card()
    srv = _round_server("tree_fused", True, sync_every=2, sampling=_stoch())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv._round()
        srv._round()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    srv._inflight = 2
    assert all(len(t) >= 2 for t in srv.flush().values())


def test_sampled_build_keeps_greedy_segments_on_card():
    """The greedy build's segments and their kernels are the same before
    and after a sampled build of the same server, and the sampled build
    captures the same segments with the same kernel launches (its warp,
    walk and key split are plain PyTorch); only its dstate has the four
    sampling entries."""
    _card()
    before = _round_server("tree_fused", False)
    sampled = _round_server("tree_fused", False, sampling=_stoch())
    after = _round_server("tree_fused", False)
    plan = [name for name, _, _ in before._plan()]
    assert plan == [name for name, _, _ in sampled._plan()] == [n for n, _, _ in after._plan()]
    assert before.segment_launches == after.segment_launches == sampled.segment_launches
    assert set(before.dstate) == set(after.dstate)
    assert set(sampled.dstate) - set(before.dstate) == {"temp", "topk", "topp", "key"}


# -------------------------------------------------------------------- training
def test_train_steps_on_card_match_cpu():
    """Two ``make_train_step`` steps (peak lr 1e-3, warm-up 1: the second
    step moves the params by ~1e-3) of vicuna-7b at the reduced width and 2
    layers, float32, TF32 off, on the card against the same steps on the
    CPU from the same params and batches: ce and grad_norm within 1e-4
    (relative for grad_norm), lr exact, every param and both moments
    within 1e-4 (an element whose gradient is near zero may move by a
    little more than its gradient's rounding)."""
    _card()
    from repro_torch import training as T
    from repro_torch.config import get_config
    from repro_torch.data import lm_batches, synthetic_corpus
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_leaves, tree_map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=2)
    cpu = init_params(cfg, 0, device="cpu")
    card = tree_map(lambda a: a.cuda(), cpu)
    o_cpu, o_card = T.adamw_init(cpu), T.adamw_init(card)
    step = T.make_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=10, remat=False)
    it = lm_batches(synthetic_corpus(cfg.vocab_size, 5_000), 4, 32)
    for _ in range(2):
        b = next(it)
        cpu, o_cpu, m_cpu = step(cpu, o_cpu, b)
        card, o_card, m_card = step(card, o_card, {"tokens": torch.as_tensor(b["tokens"]).cuda()})
        assert abs(float(m_card["ce"]) - float(m_cpu["ce"])) <= 1e-4
        assert abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1) <= 1e-4
        assert float(m_card["lr"]) == float(m_cpu["lr"])
    for got, want in zip(tree_leaves((card, o_card)), tree_leaves((cpu, o_cpu))):
        close(got.cpu(), want, 1e-4)


# ------------------------------------------------------------- MoE experts
def _moe_case(N, K, E, d, F, dtype, experts=None, seed=0):
    dev = _card()
    x, ids = moe_routing(N, K, E, d, seed=seed, experts=experts)
    x_s, offs, order = moe_sorted(x, ids, E)
    x_s, offs = (t.to(dev) for t in tensors(x_s, offs))
    w = moe_weights(E, d, F, getattr(torch, dtype), dev, seed)
    return x_s.to(getattr(torch, dtype)), offs, order, w


def _moe_close(got, want, dtype):
    if dtype == "float32":
        close(got.cpu(), want.cpu(), ATOL)
    else:
        # float32 sums within 1e-4, then rounded to bfloat16: one ulp apart
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2 ** -7 * want.float().abs() + ATOL).all()), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K,E,d,F,experts", [
    (1, 4, 60, 2048, 1408, None), (16, 4, 60, 2048, 1408, None), (128, 4, 60, 2048, 1408, None),
    (64, 4, 60, 2048, 1408, (3, 17, 41, 58)),  # most experts get no row
    (5, 2, 8, 264, 136, None),                 # k and n past the 32 x 64 tiles
    (40, 2, 8, 96, 40, (1, 2)),                # several row tiles for one expert
    # one expert with 1, 63, 64, 65 and 130 rows: the 64-row tiles' edges
    (1, 1, 8, 256, 192, (5,)), (63, 1, 8, 256, 192, (5,)), (64, 1, 8, 256, 192, (5,)),
    (65, 1, 8, 256, 192, (5,)), (130, 1, 8, 256, 192, (5,)),
    # qwen2-moe's expert d_ff over model = 2 and 4: n (up) and k (down) end
    # inside a 64-wide tile at 352
    (16, 4, 60, 2048, 704, None), (16, 4, 60, 2048, 352, None),
])
def test_moe_grouped_matches_plain_on_card(dtype, N, K, E, d, F, experts):
    from repro_torch.kernels import moe_grouped as mg

    x_s, offs, _, (w_gate, w_up, w_down) = _moe_case(N, K, E, d, F, dtype, experts)
    counter = "launches" if dtype == "float32" else "bf16_launches"      # each kernel's own
    before = getattr(mg, counter)
    h = mg.moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
    out = mg.moe_grouped(h, w_down, offs)
    h_plain = ref.ref_moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up)
    _moe_close(h, h_plain, dtype)
    _moe_close(out, ref.ref_moe_grouped(h, w_down, offs), dtype)
    two = mg.moe_grouped(x_s, w_up, offs, act="gelu")              # a 2-matrix expert
    _moe_close(two, ref.ref_moe_grouped(x_s, w_up, offs, act="gelu"), dtype)
    torch.cuda.synchronize()
    assert getattr(mg, counter) == before + 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_grouped_is_batch_invariant_on_card(dtype):
    """The (token, expert) rows of the first N1 tokens are bitwise equal
    whether 0 or N2 more tokens are batched with them (their rows then sit
    at other positions among more rows of the same experts)."""
    from repro_torch.kernels import moe_grouped as mg

    N1, N2, K, E, d, F = 5, 75, 4, 60, 2048, 1408
    dev = _card()
    x, ids = moe_routing(N1 + N2, K, E, d, seed=3)
    w_gate, w_up, w_down = moe_weights(E, d, F, getattr(torch, dtype), dev, 3)
    rows = []
    for n in (N1, N1 + N2):
        x_s, offs, order = moe_sorted(x[:n], ids[:n], E)
        x_s, offs = (t.to(dev) for t in tensors(x_s, offs))
        h = mg.moe_grouped(x_s.to(w_up.dtype), w_gate, offs, act="silu", w_mul=w_up)
        out = mg.moe_grouped(h, w_down, offs)
        inv = np.argsort(order)
        rows.append(out[torch.from_numpy(inv[:N1 * K]).to(dev)])
    assert torch.equal(rows[0], rows[1])
    # the last N1 tokens alone and after N2 tokens routed to the same K
    # experts: their rows then sit at 75-79 of each expert's 80, in its
    # second 64-row tile
    x, ids = moe_routing(N1 + N2, K, E, d, seed=4, experts=(3, 17, 41, 58))
    rows = []
    for lo in (N2, 0):
        x_s, offs, order = moe_sorted(x[lo:], ids[lo:], E)
        x_s, offs = (t.to(dev) for t in tensors(x_s, offs))
        h = mg.moe_grouped(x_s.to(w_up.dtype), w_gate, offs, act="silu", w_mul=w_up)
        out = mg.moe_grouped(h, w_down, offs)
        inv = np.argsort(order)
        rows.append(out[torch.from_numpy(inv[-N1 * K:]).to(dev)])
    assert torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_grouped_keeps_to_its_rows_on_card(dtype):
    """Expert 1's rows start at row 70, inside expert 0's second 64-row
    tile, and expert 2's at 100: every row holds its own expert's product.
    Rows past offs[E] are in no segment, and a launch leaves them as they
    were, though the last expert's tile covers them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_grouped as mg

    dev, torch_dtype = _card(), getattr(torch, dtype)
    sizes, P, K, N = (70, 30, 17), 128, 256, 192
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((P, K)).astype(np.float32)).to(dev, torch_dtype)
    w_gate, w_up, _ = moe_weights(len(sizes), K, N, torch_dtype, dev, 5)
    got = mg.moe_grouped(x, w_gate, offs, act="silu", w_mul=w_up)
    want = ref.ref_moe_grouped(x, w_gate, offs, act="silu", w_mul=w_up)
    _moe_close(got[:sum(sizes)], want[:sum(sizes)], dtype)
    out = torch.full((P, N), 7.0, dtype=torch_dtype, device=dev)
    lib = _build.load("moe_grouped", mg._SIGNATURES)
    _build.check(lib.moe_grouped(_build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
                                 _build.ptr(offs), _build.ptr(out), P, K, N, len(sizes),
                                 mg._DTYPES[torch_dtype], 1, mg.ACTS["silu"],
                                 mg._plan(K, N, len(sizes), torch_dtype),
                                 _build.stream_ptr(x.device)), "moe_grouped")
    torch.cuda.synchronize()
    assert torch.equal(out[:sum(sizes)], got[:sum(sizes)])
    assert bool((out[sum(sizes):] == 7.0).all())


def test_moe_grouped_replay_reads_its_buffers_on_card():
    """bfloat16, qwen2-moe's expert shape: the tensor maps a captured
    launch bakes in point at the captured buffers, so a replay after new
    rows and offsets are copied into them equals an eager launch on
    those."""
    from repro_torch.kernels import moe_grouped as mg

    N, K, E, d, F = 16, 4, 60, 2048, 1408
    dev = _card()
    w_gate, w_up, w_down = moe_weights(E, d, F, torch.bfloat16, dev, 6)
    cases = []
    for seed in (6, 7):
        x, ids = moe_routing(N, K, E, d, seed=seed)
        x_s, offs, _ = moe_sorted(x, ids, E)
        cases.append([t.to(dev) for t in tensors(x_s, offs)])
    x_s, offs = (t.clone() for t in cases[0])
    x_s = x_s.to(torch.bfloat16)

    def layer():
        return mg.moe_grouped(mg.moe_grouped(x_s, w_gate, offs, act="silu", w_mul=w_up),
                              w_down, offs)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layer()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = layer()
    for new_x, new_offs in cases[::-1]:
        x_s.copy_(new_x.to(torch.bfloat16))
        offs.copy_(new_offs)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, layer())


def test_moe_single_round_replay_equals_eager_on_card():
    """qwen2-moe-a2.7b at full width, 2 layers, float32: the captured
    single round (the dispatch and both grouped launches per layer inside
    the graph) equals eager rounds bitwise, one graph launch a round."""
    from repro_torch.config import get_config
    from repro_torch.core.dsia import DraftSpec
    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedSpecServer

    _card()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2, dtype="float32")
    params = init_params(cfg, 0)
    spec = DraftSpec("self_draft", gates=(1, 1), prior_alpha=0.6, prior_c=0.2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (40, 100, 7, 64)]
    servers = []
    for _ in range(2):
        srv = BatchedSpecServer(cfg, params, mode="tree_fused", draft_spec=spec, max_batch=4,
                                max_len=256, draft_k=4, tree_expansions=5, adaptive=True,
                                min_obs=1, round_mode="single")
        for b, p in enumerate(prompts):
            srv.add_request(b, p)
        servers.append(srv)
    graph, eager = servers
    assert graph._graph is not None
    # two launches an MoE layer: the draft's two layers and the verify's two
    assert graph.segment_launches["draft"]["moe_grouped"] > 0
    assert graph.segment_launches["tail"]["moe_grouped"] == 4
    _assert_replays_equal_eager(graph, eager, 4)
    assert graph.stats["graph_replays"] == 4
    assert mg.launches > 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_ssm_single_round_replay_equals_eager_on_card(arch, paged):
    """The reduced stack at 4 layers, float32, random weights from seed 0:
    the captured ``chain_fused`` single round (the mamba recurrence inside
    the graph, recomputed draft KV) equals eager rounds bitwise, one graph
    launch a round, and every stream is a prefix of AR's."""
    from repro_torch.config import get_config
    from repro_torch.core import SpecEngine
    from repro_torch.core.dsia import DraftSpec
    from repro_torch.models import init_params
    from repro_torch.serving import BatchedSpecServer

    _card()
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4)
    params = init_params(cfg, 0)
    spec = DraftSpec("self_draft", gates=(1, 0, 1, 1), prior_alpha=0.6, prior_c=0.2)
    rng = np.random.default_rng(1)
    prompts = [np.tile(rng.integers(0, cfg.vocab_size, size=8), 4).astype(np.int32)] + [
        rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (100, 7, 64)]
    servers = []
    for _ in range(2):
        srv = BatchedSpecServer(cfg, params, mode="chain_fused", draft_spec=spec, max_batch=4,
                                max_len=256, draft_k=4, adaptive=True, min_obs=1,
                                round_mode="single", paged=paged, page_size=16)
        for b, p in enumerate(prompts):
            srv.add_request(b, p)
        servers.append(srv)
    graph, eager = servers
    assert graph._graph is not None and graph.draft_kv == "recompute"
    ar = []
    for p in prompts:
        eng = SpecEngine(cfg, params, max_len=256)
        eng.start(p)
        ar.append(eng.generate_ar(24))
    eager._graph = None                         # step() runs the round eagerly
    gen = {b: [] for b in range(4)}
    for r in range(6):
        out = graph.step()
        assert out == eager.step(), f"round {r}"
        for b, t in out.items():
            gen[b].extend(t)
    tail = graph.flush()
    assert tail == eager.flush()
    for b, t in tail.items():
        gen[b].extend(t)
    assert graph.stats["graph_replays"] == 6 and graph.stats["draft_rounds"] > 0
    for name in graph.dstate:
        assert torch.equal(graph.dstate[name], eager.dstate[name]), name
    for a, b in zip(_cache_leaves(graph), _cache_leaves(eager)):
        assert torch.equal(a, b)
    for b, t in gen.items():
        assert len(t) >= 6 and t == ar[b][:len(t)], f"slot {b} left AR"


# ------------------------------------------- codebook decode, MoE / SSM training
def test_musicgen_joint_decode_equals_commit_chain_on_card():
    """Reduced musicgen-medium (4 codebooks, hd 64, MHA), float32, random
    weights from seed 0, on the flash decode and tree kernels: a joint T=3
    decode of (B, 3, 4) codes equals two steps, a commit, then the third,
    within 1e-4, with the same argmax per codebook."""
    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    _card()
    cfg = get_config("musicgen-medium").reduced()
    params = init_params(cfg, 0)
    rng = np.random.default_rng(2)
    cache = M.init_cache(cfg, 2, 64)
    codes = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 19, 4)), device="cuda")
    M.prefill(cfg, params, {"tokens": codes[:, :16]}, cache)
    t3 = codes[:, 16:]
    fd0, ta0 = fd.launches, ta.launches
    joint, _ = M.decode_step(cfg, params, cache, t3)
    _, st2 = M.decode_step(cfg, params, cache, t3[:, :2])
    M.commit_cache(cfg, cache, st2, torch.arange(2, device="cuda"),
                   torch.tensor(2, dtype=torch.int32, device="cuda"))
    last, _ = M.decode_step(cfg, params, cache, t3[:, 2:])
    assert joint.shape == (2, 3, 4, cfg.padded_vocab)
    close(last[:, 0].cpu(), joint[:, 2].cpu(), ATOL)
    assert torch.equal(last[:, 0].argmax(-1), joint[:, 2].argmax(-1))
    assert fd.launches > fd0 and ta.launches > ta0


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m"])
def test_moe_and_ssm_train_steps_on_card(arch):
    """The reduced stack (qwen2-moe: the grouped-capacity dispatch and its
    aux losses; mamba2: the chunked scan's backward), float32, 5
    ``make_train_step`` steps on one repeated batch (peak lr 1e-2, warm-up
    1) on the card: every loss and grad_norm finite, the MoE aux above 0,
    and ce lower at the fifth step than at the first."""
    from repro_torch import training as T
    from repro_torch.config import get_config
    from repro_torch.data import lm_batches, synthetic_corpus
    from repro_torch.models import init_params

    _card()
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0)
    opt = T.adamw_init(params)
    step = T.make_train_step(cfg, peak_lr=1e-2, warmup=1, total_steps=10, remat=False)
    b = {"tokens": torch.as_tensor(next(lm_batches(synthetic_corpus(cfg.vocab_size, 5_000), 4, 32))
                                   ["tokens"], device="cuda")}
    ce = []
    for _ in range(5):
        params, opt, m = step(params, opt, b)
        assert all(np.isfinite(float(m[k])) for k in ("loss", "grad_norm", "moe_aux"))
        assert (float(m["moe_aux"]) > 0) == (cfg.moe is not None)
        ce.append(float(m["ce"]))
    assert ce[-1] < ce[0], ce


# ------------------------------------------------------------------- mesh
@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Two gloo ranks sharing the card (``torch_mesh_workers.card_rank``)."""
    _card()
    import torch_mesh_workers as W
    from repro_torch.launch.mesh import spawn

    out = tmp_path_factory.mktemp("card_mesh")
    spawn(W.card_rank, 2, ("data=1,model=2", {"attention_case": W.attention_case()}, str(out)),
          device="cuda", share_card=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_tensor_parallel_decode_shares_the_card(card_ranks):
    import torch_mesh_workers as W
    from repro_torch.models import model as M

    dev = _card()
    one = W.decode_logits(W.VICUNA, M.init_params(W.VICUNA, 0, device=dev), dev)
    for r in card_ranks:
        for got, want in zip(r["logits"], one):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_context_parallel_flash_decode_on_card(card_ranks):
    import torch_mesh_workers as W

    want = W.run_attention(W.attention_case(), _card())
    for r in card_ranks:
        np.testing.assert_allclose(r["cp"], want, rtol=0, atol=1e-5)


def test_nccl_all_reduce_captured_in_a_graph(tmp_path):
    _card()
    import torch_mesh_workers as W
    from repro_torch.launch.mesh import spawn

    spawn(W.nccl_capture_rank, 1, (str(tmp_path),), device="cuda")
    got = torch.load(tmp_path / "replayed.pt")
    assert torch.equal(got, (torch.arange(8, dtype=torch.float32) + 1) * 2)


def test_data_parallel_train_steps_share_the_card(tmp_path):
    """Two data=2 train steps of vicuna (reduced, 4 layers, FSDP) by two
    gloo ranks sharing the card equal the one-device steps: ce within 1e-5
    relative and grad_norm within 1e-4 relative at each step; after the
    second (the first update: the warm-up gives step 0 a learning rate of
    0) every param within 1e-5 but for at most one element in 10^4 of a
    leaf (within 3e-3: AdamW's update of a gradient that is rounding
    noise), and both AdamW moments within 1e-6 (the AdamW rule of
    ``test_torch_training.py``)."""
    dev = _card()
    import torch_mesh_workers as W
    from repro_torch import training as T
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh, spawn
    from repro_torch.models import model as M

    spawn(W.card_train_rank, 2, ("data=2,model=1", str(tmp_path)), device="cuda", share_card=True,
          timeout_s=300)
    p = M.init_params(W.VICUNA, 0, device=dev)
    opt = T.adamw_init(p)
    step = T.make_train_step(W.VICUNA, **W.TRAIN_STEP_KW)
    metrics = []
    for b in W.step_batches(W.VICUNA, 2):
        p, opt, m = step(p, opt, {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    assert metrics[1]["lr"] > 0
    want = {k: v.cpu().numpy() for k, v in W.flat({"p": p, "mu": opt.mu, "nu": opt.nu}).items()}
    mesh = Mesh((2, 1), ("data", "model"), shape_only=True)
    for r in range(2):
        rec = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for got, ref in zip(rec["metrics"], metrics, strict=True):
            assert got["lr"] == ref["lr"]
            for k, tol in (("ce", 1e-5), ("grad_norm", 1e-4)):
                assert abs(got[k] - ref[k]) <= tol * abs(ref[k]), k
        by_key = SH.specs_by_key({"p": rec["specs"], "mu": rec["specs"], "nu": rec["specs"]})
        for k, a in rec["leaves"].items():
            w = want[k][SH.local_slices(want[k].shape, by_key[k], mesh, {"data": r, "model": 0})]
            d = np.abs(a.numpy() - w)
            if k.startswith("['p']"):
                assert (d > 1e-5).sum() <= max(1, d.size // 10_000) and d.max() <= 3e-3, k
            else:
                assert d.max() <= 1e-6, k
