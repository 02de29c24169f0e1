"""The multi-level cascade (``cascade_fused``), its draft bank and the
``legacy`` per-step baseline in the port, against the JAX reference, on
the CPU in float32.

The port's counterpart of ``tests/test_server_cascade.py``. The cascade's
host math (``t_cascade``, ``best_cascade_k``, ``best_cascade_plan``,
``prior_alpha_given``) equals the reference's; the draft bank makes the
same levels, priors and keys. The int8 level's MLP weights are quantized
once (``kernels.ops.prequantize``) and the product is bitwise equal to the
per-call ``quantized_matmul``. ``cascade_rescore`` on a seeded batch of
trees (a full bucket, a slot not routed through the level, a probe, a
root-only tree) gives the reference's trees exactly, ``p_acc`` within 1e-6
and the level's logits within 1e-4, for a layer-sparse level and for the
int8 level run both ways: the port's ``"kernel"`` (the W8A8 kernel's plain
version, exact int32 sums) against the reference's ``"kernel"`` (the
Pallas kernel in interpret mode, float32 sums per tile), and ``"sim"``
against ``"sim"``; no near-tie flips an argmax on these seeds. Servers in
``cascade_fused`` (mixing, scaling and replacing hierarchies, dense and
paged) and ``legacy`` emit the AR stream, and with budgets pinned
(``adaptive=False``, cost trackers held at their priors) accept the same
tokens per slot, round by round, as the reference's servers.

Shapes: the 4-layer reduced vicuna-7b, ``max_len`` 128, pages of 16. The
file takes ~45 s alone on one worker, imports included (most of it the
reference's jit compiles and its interpret-mode int8 kernel).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import dsia as jdsia  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import ewif as jewif  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.draft_bank import DraftBank as JDraftBank  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import SpecEngine, dsia, engine, ewif, latency  # noqa: E402
from repro_torch.kernels import int8_matmul, ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer, DraftBank  # noqa: E402

L = 4
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=L)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=L)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
MAX_LEN = 128
# (mode, sparsities): the default mixing hierarchy, and scaling with two
# distinct layer sets (at 4 layers LS0.4 and LS0.6 both keep layers 0 and 3)
HIERARCHIES = {"mixing": ("mixing", (0.4, 0.6)), "scaling": ("scaling", (0.25, 0.5)),
               "replacing": ("replacing", (0.4, 0.6))}
_rng = np.random.default_rng(3)
PROMPTS = [_rng.integers(2, CFG.vocab_size, size=n).astype(np.int32) for n in (8, 19)]
ROUNDS = 5
N_AR = 48


def _hier(name, port=True):
    mode, sp = HIERARCHIES[name]
    return (dsia if port else jdsia).build_hierarchy(CFG if port else J_CFG, mode, sp)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


# ------------------------------------------------------------- host math
def test_cascade_ewif_and_plan_match_reference():
    for alphas in ([0.9, 0.6], [0.5, 0.95, 0.3], [0.99], [0.2, 0.2]):
        for cs in ([0.6, 0.3], [0.9, 0.5, 0.1], [0.05], [0.02, 0.01]):
            if len(cs) != len(alphas):
                continue
            for k in range(0, 7):
                assert ewif.t_cascade(alphas, cs, k) == jewif.t_cascade(alphas, cs, k)
            assert ewif.best_cascade_k(alphas, cs, 5) == jewif.best_cascade_k(alphas, cs, 5)
            for a_dir in (0.05, 0.3, 0.8):
                for e_max in (0, 3, 5):
                    for t_min in (1.0, 1.05, 1.6):
                        assert (latency.best_cascade_plan(alphas, cs, a_dir, e_max, t_min)
                                == jlat.best_cascade_plan(alphas, cs, a_dir, e_max, t_min))
    with pytest.raises(ValueError):
        ewif.t_cascade([0.5], [0.1, 0.2], 3)


def test_prior_alpha_given_matches_reference():
    port = dsia.build_hierarchy(CFG, "mixing") + dsia.build_hierarchy(CFG, "replacing")
    ref = jdsia.build_hierarchy(J_CFG, "mixing") + jdsia.build_hierarchy(J_CFG, "replacing")
    for a, ja in zip(port, ref):
        assert a.n_active_layers == ja.n_active_layers
        for b, jb in zip(port, ref):
            assert a.prior_alpha_given(b) == ja.prior_alpha_given(jb)
    assert a.prior_alpha_given(dataclasses.replace(a, prior_alpha=0.0)) == a.prior_alpha


# ------------------------------------------------------------- draft bank
@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_draft_bank_matches_reference(name):
    bank = DraftBank(CFG, PARAMS, _hier(name))
    ref = JDraftBank(J_CFG, J_PARAMS, _hier(name, port=False))
    assert bank.int8_exec == "sim"                       # "auto" on the CPU
    assert len(bank) == len(ref) and bank.pld.name == ref.pld.name
    for lvl, jl in zip(bank.levels, ref.levels):
        assert (lvl.index, lvl.name, lvl.quantize, lvl.attn_override, lvl.owns_params) == (
            jl.index, jl.name, jl.quantize, jl.attn_override, jl.owns_params)
        if jl.gates is None:
            assert lvl.gates is None and lvl.layer_ids is None
        else:
            np.testing.assert_array_equal(lvl.gates, jl.gates)
            assert lvl.layer_ids == [int(i) for i in np.flatnonzero(jl.gates)]
            assert lvl.exec_gates is None                # slice exec on this stack
    assert [lv.name for lv in bank.rescorers] == [lv.name for lv in ref.rescorers]
    assert bank.drafter.name == ref.drafter.name
    for i in range(len(bank)):
        assert bank.alpha_prior(i) == ref.alpha_prior(i)
        assert bank.c_prior(i) == ref.c_prior(i)
        assert bank.slot_key(i, 3) == ref.slot_key(i, 3)
        assert bank.cost_key(i) == ref.cost_key(i)
    assert bank.direct_key(2) == ref.direct_key(2)
    assert bank.direct_prior() == ref.direct_prior()
    assert bank.param_bytes == ref.param_bytes           # the fake-quantized copy, float32


def test_draft_bank_kernel_exec_and_errors():
    """``"kernel"`` quantizes the int8 level's MLP weights once, for its
    layers only (one copy shared by two levels over the same params); the
    level's own layers read them, any other layer raises."""
    q8 = dsia.activation_quant(CFG, 8, base=dsia.layer_sparsity(CFG, 0.5))
    hier = [q8, dataclasses.replace(q8, name="LS0.5+Q8b"), dsia.PLD_SPEC]
    bank = DraftBank(CFG, PARAMS, hier, int8_exec="kernel")
    lvl = bank.levels[0]
    assert bank.int8_exec == "kernel" and lvl.quantize == "int8" and lvl.owns_params
    mlp = lvl.params["segments"][0][0]["mlp"]
    assert sorted(mlp["w_up"].layers) == lvl.layer_ids == [0, 3]
    for name, stack in mlp.items():
        for r in lvl.layer_ids:
            qw = stack[r]
            assert qw.w_q.dtype == torch.int8 and qw.n == PARAMS["segments"][0][0]["mlp"][name].shape[-1]
            assert bank.levels[1].params["segments"][0][0]["mlp"][name][r] is qw   # shared
    with pytest.raises(KeyError):
        mlp["w_up"][1]
    per_layer = sum(int8_matmul.quantize_cols(w[0])[0].numel() + 4 * w.shape[-1]
                    for w in PARAMS["segments"][0][0]["mlp"].values())
    assert bank.param_bytes == 2 * per_layer
    assert lvl.params["segments"][0][0]["attn"] is PARAMS["segments"][0][0]["attn"]
    for bad, kw in (([dsia.PLD_SPEC], {}), (hier, dict(int8_exec="fast")),
                    ([dataclasses.replace(q8, quantize="int4")], {})):
        with pytest.raises(ValueError):
            DraftBank(CFG, PARAMS, bad, **kw)
        with pytest.raises(ValueError):
            JDraftBank(J_CFG, J_PARAMS, [_to_j(s) for s in bad], **kw)


def _to_j(spec):
    return jdsia.DraftSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize("shape", [(1, 256, 512), (8, 512, 256), (13, 100, 70)])
def test_prequantized_matmul_bitwise_equals_dynamic(shape):
    M_, K, N = shape
    rng = np.random.default_rng(M_)
    x = torch.from_numpy(rng.standard_normal((M_, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    qw = ops.prequantize(w)
    assert qw.n == N and qw.w_q.shape[0] % int8_matmul.TILE_K == 0
    assert torch.equal(ops.quantized_matmul(x, qw), ops.quantized_matmul(x, w))


# ------------------------------------------------------------- rescore
B, N = 4, 16


def _prefilled():
    rng = np.random.default_rng(5)
    prompts = rng.integers(4, CFG.vocab_size - 1, size=(B, 10)).astype(np.int32)
    j_cache = JM.init_cache(J_CFG, B, MAX_LEN)
    last, j_cache = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(prompts)}, j_cache)
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    return np.asarray(jnp.argmax(last, -1)).astype(np.int32), j_cache, cache


def _trees(pending, cache, level):
    """Seeded trees of random shape: slot 0 a full bucket, slot 1 eleven
    nodes, slot 2 seven, slot 3 the root alone. One child per parent is
    planted with ``level``'s argmax at the parent (depth by depth, so the
    parents' logits are final), so endorsement, first mismatches and
    extensions all occur."""
    rng = np.random.default_rng(11)
    count = np.array([N, 11, 7, 1], np.int32)
    tokens = np.zeros((B, N), np.int32)
    tokens[:, 0] = pending
    parents = np.full((B, N), -1, np.int32)
    depth = np.zeros((B, N), np.int32)
    mask = np.broadcast_to(np.eye(N, dtype=bool), (B, N, N)).copy()
    for b in range(B):
        for j in range(1, count[b]):
            p = int(rng.integers(max(0, j - 3), j))
            parents[b, j], depth[b, j] = p, depth[b, p] + 1
            mask[b, j] |= mask[b, p]
            tokens[b, j] = rng.integers(2, CFG.vocab_size)
    p_acc = np.where(parents >= 0, 0.9 ** depth, 0.0).astype(np.float32)
    p_acc[:, 0] = 1.0
    for d in range(1, int(depth.max()) + 1):
        logits, _ = M.decode_step(CFG, level.params, cache, torch.from_numpy(tokens),
                                  tree_mask=torch.from_numpy(mask),
                                  q_pos=cache["pos"][:, None] + torch.from_numpy(depth),
                                  layer_ids=level.layer_ids, quantize=level.quantize)
        nxt = logits.argmax(-1).numpy()
        for b in range(B):
            planted = set()
            for j in np.flatnonzero((depth[b] == d) & (np.arange(N) < count[b])):
                p = parents[b, j]
                if p not in planted and rng.random() < 0.7:
                    tokens[b, j] = nxt[b, p]
                    planted.add(p)
    probe = np.array([1, 2, 3, -1], np.int32)
    apply = np.array([True, False, True, True])
    alpha = np.array([0.8, 0.7, 0.6, 0.9], np.float32)
    return tokens, parents, depth, p_acc, mask, count, probe, apply, alpha


@pytest.fixture(scope="module")
def rescore_inputs():
    pending, j_cache, cache = _prefilled()
    banks = {ex: (DraftBank(CFG, PARAMS, _hier("mixing"), int8_exec=ex),
                  JDraftBank(J_CFG, J_PARAMS, _hier("mixing", port=False), int8_exec=ex))
             for ex in ("kernel", "sim")}
    trees = _trees(pending, cache, banks["sim"][0].levels[0])
    return j_cache, cache, banks, trees


def _j_rescore(j_cache, jl, trees, **kw):
    g = None if jl.gates is None else jnp.asarray(jl.gates)
    return jeng.cascade_rescore(J_CFG, jl.params, j_cache, *map(jnp.asarray, trees), g,
                                quantize=jl.quantize, attn_override=jl.attn_override, **kw)


def _rescore(cache, lvl, trees):
    return engine.cascade_rescore(CFG, lvl.params, cache, *map(torch.from_numpy, trees),
                                  lvl.exec_gates, layer_ids=lvl.layer_ids,
                                  quantize=lvl.quantize, attn_override=lvl.attn_override)


@pytest.mark.parametrize("case", ["LS0.4", "LS0.6+Q8 kernel", "LS0.6+Q8 sim"])
def test_cascade_rescore_matches_reference(rescore_inputs, case, monkeypatch):
    j_cache, cache, banks, trees = rescore_inputs
    i, ex = (0, "sim") if case == "LS0.4" else (1, case.split()[-1])
    lvl, jl = banks[ex][0].levels[i], banks[ex][1].levels[i]
    assert (lvl.quantize, jl.quantize) == (("int8", "int8") if ex == "kernel" else (None, None))
    # the level's logits over the tree, held within 1e-4
    logits = {}
    real_decode, j_decode = M.decode_step, JM.decode_step
    monkeypatch.setattr(M, "decode_step", lambda *a, **k: logits.setdefault(
        "port", real_decode(*a, **k)))
    monkeypatch.setattr(JM, "decode_step", lambda *a, **k: logits.setdefault(
        "ref", j_decode(*a, **k)))
    got = _rescore(cache, lvl, trees)
    want = _j_rescore(j_cache, jl, trees)
    _close(logits["port"][0], logits["ref"][0], 1e-4)
    names = ("tokens", "parents", "depth", "p_acc", "mask", "count", "level_node", "probe_ok",
             "probe_valid")
    for name, g, w in zip(names, got, want):
        if name == "p_acc":
            _close(g, w, 1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tokens, count, apply = got[0].numpy(), got[5].numpy(), trees[7]
    assert count[0] == N and not np.array_equal(tokens[2], trees[0][2])   # full; grown
    np.testing.assert_array_equal(tokens[1], trees[0][1])                 # not routed
    assert count[3] > 1 and got[6].numpy()[1] == -1 and not apply[1]


def test_cascade_rescore_verify_is_rescore_then_verify(rescore_inputs):
    _, cache, banks, trees = rescore_inputs
    lvl = banks["kernel"][0].levels[0]
    live = torch.tensor([True, True, False, True])
    t = tuple(map(torch.from_numpy, trees))
    rescored = _rescore(cache, lvl, trees)
    got_cache, want_cache = (M.tree_map(lambda a: a.clone(), cache) for _ in range(2))
    out = engine.cascade_rescore_verify(CFG, lvl.params, PARAMS, got_cache, *t, lvl.exec_gates,
                                        live, layer_ids=lvl.layer_ids)
    for g, w in zip(out[:9], rescored):
        assert torch.equal(g, w)
    tk, pr, dp, _, mk, ct = rescored[:6]
    want = engine.tree_verify_accept_commit(CFG, PARAMS, want_cache, tk, pr, dp, mk, ct, live)
    for g, w in zip(out[10:], want[1:]):                # the reference's device walk
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    for n in ("k", "v"):                                # the same commit
        assert torch.equal(out[9]["segments"][0][0][n], want[0]["segments"][0][0][n])
    assert torch.equal(out[9]["pos"], want[0]["pos"])
    # the stochastic rule at temperature 0 (one-hot q) is the greedy rule
    greedy0 = (torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
               torch.rand(B, N + 2, generator=torch.Generator().manual_seed(0)))
    sampled = engine.cascade_rescore(CFG, lvl.params, cache, *t, lvl.exec_gates,
                                     layer_ids=lvl.layer_ids, sampling=greedy0)
    for g, w in zip(sampled, rescored):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        BatchedSpecServer(CFG, PARAMS, mode="cascade_fused", sampling=object(), device="cpu")


# ------------------------------------------------------------- servers
def _pin_costs(srv):
    srv.costs.observe = lambda *a, **k: None
    srv.costs.observe_target = lambda *a, **k: None
    return srv


def _kwargs(paged=False, **kw):
    out = dict(max_batch=2, max_len=MAX_LEN, draft_k=4, tree_expansions=3, adaptive=True,
               min_obs=1)
    if paged:
        out.update(paged=True, page_size=16)
    out.update(kw)
    return out


def _run(srv, rounds=ROUNDS):
    for i, p in enumerate(PROMPTS):
        srv.add_request(i, p)
    gen = {i: [] for i in range(len(PROMPTS))}
    per_round = []
    for _ in range(rounds):
        out = srv.step()
        per_round.append(out)
        for b, t in out.items():
            gen[b].extend(t)
    return gen, per_round


@pytest.fixture(scope="module")
def ar_streams():
    """(port AR, JAX AR) streams of N_AR tokens per prompt."""
    port, jref = [], []
    for p in PROMPTS:
        eng = SpecEngine(CFG, PARAMS, max_len=MAX_LEN, device="cpu")
        eng.start(p)
        port.append(eng.generate_ar(N_AR))
        jeng_ = JEngine(J_CFG, J_PARAMS, max_len=MAX_LEN)
        jeng_.start(p)
        jref.append(jeng_.generate_ar(N_AR))
    assert port == jref
    return port


def _assert_lossless(gen, ar, rounds=ROUNDS):
    for b, stream in gen.items():
        assert len(stream) >= rounds, f"slot {b}: a round emitted no token"
        n = min(len(stream), N_AR)
        assert stream[:n] == ar[b][:n], f"slot {b} left the AR stream"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_cascade_streams_equal_ar(ar_streams, name, paged):
    srv = BatchedSpecServer(CFG, PARAMS, mode="cascade_fused", hierarchy=_hier(name),
                            device="cpu", **_kwargs(paged))
    assert srv.round_mode == "split" and srv.bank.int8_exec == "sim"
    assert srv.tree_bucket == 16            # 1 + 4 + 2 * 3 + 2 per rescorer = 13, bucketed
    gen, _ = _run(srv)
    _assert_lossless(gen, ar_streams)
    st = srv.stats
    assert st["steps"] == ROUNDS == st["target_calls"]
    assert st["tokens"] == sum(len(s) for s in gen.values())
    assert srv.expected_dispatches_per_round() == 2
    assert st["draft_dispatches"] + st["target_calls"] <= ROUNDS * 2
    assert st["rescore_dispatches"] <= st["target_calls"]


@pytest.mark.parametrize("name", ["mixing", "scaling"])
def test_cascade_rounds_match_reference(name):
    kw = _kwargs(adaptive=False)
    ref = _pin_costs(JServer(J_CFG, J_PARAMS, mode="cascade_fused",
                             hierarchy=_hier(name, port=False), int8_exec="sim", **kw))
    port = _pin_costs(BatchedSpecServer(CFG, PARAMS, mode="cascade_fused", hierarchy=_hier(name),
                                        int8_exec="sim", device="cpu", **kw))
    j_gen, j_rounds = _run(ref)
    gen, rounds = _run(port)
    assert rounds == j_rounds
    for k in ("draft_dispatches", "rescore_dispatches", "target_calls", "drafted_tokens",
              "host_syncs"):
        assert port.stats[k] == ref.stats[k], k
    assert port.stats["rescore_dispatches"] == ROUNDS           # adaptive off: every round
    assert port.acceptance.snapshot() == pytest.approx(ref.acceptance.snapshot(), abs=1e-6)


def test_pld_only_collapse_and_single_level(ar_streams):
    """A huge ``t_min`` routes every warmed-up slot to PLD alone (no neural
    dispatch); a one-level hierarchy drafts and verifies, never rescores."""
    srv = BatchedSpecServer(CFG, PARAMS, mode="cascade_fused", t_min=1e9, device="cpu",
                            **_kwargs())
    gen, _ = _run(srv, rounds=2)
    d0 = srv.stats["draft_dispatches"]
    more, _ = _run(srv, rounds=3)            # re-admitted: slot keys reset, then warm
    _assert_lossless(gen, ar_streams, rounds=2)
    _assert_lossless(more, ar_streams, rounds=3)
    plan = [srv._slot_cascade_plan(b)[:2] for b in range(2)]
    assert plan == [(0, False), (0, False)]
    assert srv.stats["draft_dispatches"] - d0 <= 1
    one = BatchedSpecServer(CFG, PARAMS, mode="cascade_fused",
                            hierarchy=[dsia.layer_sparsity(CFG, 0.5), dsia.PLD_SPEC], device="cpu",
                            **_kwargs())
    assert len(one.bank) == 1 and one.bank.rescorers == []
    assert one.expected_dispatches_per_round() == 2
    gen, _ = _run(one)
    _assert_lossless(gen, ar_streams)
    assert one.stats["rescore_dispatches"] == 0 and one.stats["draft_dispatches"] > 0
    assert one.acceptance.counts(one.bank.slot_key(0, 0)) == one.acceptance.counts(
        one.bank.direct_key(0))


def test_legacy_streams_and_rounds_match_reference(ar_streams):
    spec = dsia.layer_sparsity(CFG, 0.5)
    kw = _kwargs(adaptive=False)
    port = _pin_costs(BatchedSpecServer(CFG, PARAMS, fused=False, draft_spec=spec, device="cpu",
                                        **kw))
    ref = _pin_costs(JServer(J_CFG, J_PARAMS, fused=False, draft_spec=_to_j(spec), **kw))
    assert port.mode == ref.mode == "legacy" and port.round_mode == "split"
    gen, rounds = _run(port)
    j_gen, j_rounds = _run(ref)
    assert rounds == j_rounds
    _assert_lossless(gen, ar_streams)
    assert port.expected_dispatches_per_round() == ref.expected_dispatches_per_round() == 5
    for k in ("draft_dispatches", "target_calls", "host_syncs"):
        assert port.stats[k] == ref.stats[k], k
    paged = BatchedSpecServer(CFG, PARAMS, mode="legacy", draft_spec=spec, device="cpu",
                              **_kwargs(paged=True))
    _assert_lossless(_run(paged)[0], ar_streams)


ARG_ERRORS = {
    "cascade with draft_spec": dict(mode="cascade_fused", draft_spec="spec"),
    "hierarchy without cascade": dict(mode="tree_fused", draft_spec="spec", hierarchy="hier"),
    "cascade in single rounds": dict(mode="cascade_fused", round_mode="single"),
    "legacy in single rounds": dict(mode="legacy", draft_spec="spec", round_mode="single"),
    "int8 draft_spec on tree_fused": dict(mode="tree_fused", draft_spec="q8"),
    "unknown int8_exec": dict(mode="cascade_fused", int8_exec="fast"),
}


@pytest.mark.parametrize("case", sorted(ARG_ERRORS))
def test_argument_errors_match_reference(case):
    def resolve(kw, port):
        spec = {"spec": dsia.layer_sparsity(CFG, 0.5),
                "q8": dsia.activation_quant(CFG, 8, base=dsia.layer_sparsity(CFG, 0.5))}
        hier = _hier("mixing", port)
        out = {}
        for k, v in kw.items():
            if k == "draft_spec":
                v = spec[v] if port else _to_j(spec[v])
            elif k == "hierarchy":
                v = hier
            out[k] = v
        return out

    with pytest.raises(ValueError):
        BatchedSpecServer(CFG, PARAMS, device="cpu", **resolve(ARG_ERRORS[case], True))
    with pytest.raises(ValueError):
        JServer(J_CFG, J_PARAMS, **resolve(ARG_ERRORS[case], False))
