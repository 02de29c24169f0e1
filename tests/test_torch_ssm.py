"""The port's Mamba-2 serving path against the JAX reference, on the CPU in
float32: ``repro_torch.models.ssm`` (the chunked SSD scan, the conv tails,
the per-token recurrence) and the two stacks that serve through it,
mamba2-130m (pure SSM) and jamba-v0.1-52b (mamba and attention layers,
MoE on every other one), each at its ``reduced()`` width with 4 layers.

``ssd_chunked`` and ``mamba_forward`` agree with the reference's within
1e-5 (the scan padded to its chunk, over two chunks, from a non-zero
state; every per-step state of a T=5 decode); prefill and decode logits
within 1e-4 (through a commit chain and ``decode_commit_token`` too);
``commit_cache`` takes each slot's state at ``n_accept - 1``
and keeps it at 0, and ``write_slot`` copies the states, on a dense and a
paged jamba cache, within 1e-5 of the reference's. Single-stream AR, PLD
and SD streams equal AR's and the reference engine's; the tree schedulers
and a branching verify raise. ``chain_fused`` (single rounds dense and
paged, split rounds) and ``legacy`` give the reference server's tokens
round by round, greedy and sampled; ``draft_kv="auto"`` resolves to
``"recompute"``, and ``carry``, ``tree_fused``, ``cascade_fused`` and
``prefill_chunk`` raise with the reference's words. The bfloat16 bridge
keeps ``A_log``, ``D`` and ``dt_bias`` float32; the CLIs take both archs.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as j_config  # noqa: E402
from repro.core import dsia as j_dsia  # noqa: E402
from repro.core.cascade import ARScheduler as JAR  # noqa: E402
from repro.core.cascade import PLDScheduler as JPLD  # noqa: E402
from repro.core.cascade import SDScheduler as JSD  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving.sampler import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro.training import checkpoint as JT  # noqa: E402
import repro_torch.config as config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ARScheduler,
    DyTCScheduler,
    PLDScheduler,
    SDScheduler,
    SpecEngine,
    TreeScheduler,
    build_hierarchy,
    dsia,
)
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.core.tree import DraftTree, chain_tree  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402
from repro_torch.training.checkpoint import map_with_path  # noqa: E402

ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
STATE = ("ssm", "conv_x", "conv_B", "conv_C")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """The reduced config at 4 layers, the reference's seed-0 params and the
    same params in the port."""
    cfg = dataclasses.replace(config.get_config(arch).reduced(), num_layers=4)
    j_cfg = dataclasses.replace(j_config.get_config(arch).reduced(), num_layers=4)
    j_params = JM.init_params(j_cfg, jax.random.PRNGKey(0))
    return cfg, j_cfg, j_params, bridge.params_from_jax(jax.tree.map(np.asarray, j_params),
                                                        device="cpu")


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda k, t: out.__setitem__(k, t), tree)
    return out


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layer_kinds_equal_reference(arch):
    got, want = config.get_config(arch), j_config.get_config(arch)
    for a, b in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        kinds = [(a.block_kind(i).value, a.is_moe_layer(i), a.has_mlp(i))
                 for i in range(a.num_layers)]
        assert kinds == [(b.block_kind(i).value, b.is_moe_layer(i), b.has_mlp(i))
                         for i in range(b.num_layers)]
        assert [(s.start, s.repeats, len(s.unit)) for s in M.layout(a)] == [
            (s.start, s.repeats, len(s.unit)) for s in JM.layout(b)]
    assert M.has_mamba(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_fixed_leaves_equal_reference(arch):
    """The port's own draw has the reference's leaves, shapes and types
    (``A_log``, ``D``, ``dt_bias`` float32 in a bfloat16 model too), and
    those three and ``norm_w`` hold the reference's deterministic values."""
    j_params = _model(arch)[2]
    values = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(j_params)}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(config.get_config(arch).reduced(), num_layers=4, dtype=dtype)
        j_cfg = dataclasses.replace(j_config.get_config(arch).reduced(), num_layers=4, dtype=dtype)
        want = jax.eval_shape(lambda: JM.init_params(j_cfg, jax.random.PRNGKey(0)))
        got = M.init_params(cfg, 3, device="cpu")
        flat_w = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
        flat_g = _flat(got)
        assert {k.replace("/", "") for k in flat_g} == set(flat_w)
        for k, t in flat_g.items():
            w = flat_w[k.replace("/", "")]
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), k
            if k.endswith(("['A_log']", "['D']", "['dt_bias']", "['norm_w']")):
                _close(t.float(), np.asarray(values[k.replace("/", "")], np.float32), 5e-7)


# ------------------------------------------------------------------ the block
def test_ssd_chunked_matches_reference():
    """S=40 in chunks of 32 (padded, two chunks) from a non-zero state, at
    the model's scales: A as ``-exp(A_log)``, dt a softplus around
    ``dt_bias``'s 1e-3..0.1, unit inputs."""
    rng = np.random.default_rng(0)
    B, S, nh, hd, g, ds = 2, 40, 4, 8, 1, 16
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 3.0)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    Bm = rng.standard_normal((B, S, g, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, g, ds)).astype(np.float32)
    st0 = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    jy, jst = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, st0)), 32)
    y, st = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, st0)), 32)
    assert y.shape == (B, S, nh, hd) and st.shape == (B, nh, hd, ds)
    _close(y, jy, 1e-5)
    _close(st, jst, 1e-5)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba_forward_matches_reference(mode):
    """Output and every staged leaf (decode: each of the T=5 per-step
    states) from a non-zero carried state."""
    cfg, _, j_params, params = _model("mamba2-130m")
    s, d = cfg.ssm, cfg.d_model
    rng = np.random.default_rng(1)
    p_l = {k: v[0] for k, v in params["segments"][0][0]["mamba"].items()}
    jp_l = jax.tree.map(lambda a: a[0], j_params["segments"][0][0]["mamba"])
    S = 37 if mode == "prefill" else 5
    h = (rng.standard_normal((2, S, d)) * 0.5).astype(np.float32)
    zero = ssm.init_state(d, s, 2, torch.float32, "cpu")
    cache = {n: (rng.standard_normal(a.shape) * 0.3).astype(np.float32) for n, a in zero.items()}
    j_out, j_new, j_st = JS.mamba_forward(jp_l, jnp.asarray(h), d, s,
                                          {n: jnp.asarray(a) for n, a in cache.items()}, mode=mode)
    out, st = ssm.mamba_forward(p_l, torch.from_numpy(h), d, s,
                                {n: torch.from_numpy(a) for n, a in cache.items()}, mode=mode)
    _close(out, j_out, 1e-5)
    assert set(st) == set(STATE)
    for n in STATE:
        assert st[n].shape == j_st[n].shape, n
        _close(st[n], j_st[n], 1e-5)
        _close(st[n][:, -1], j_new[n], 1e-5)                     # the last step is the new cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch)
    prompt = _tokens(cfg, (2, 41), 1)
    jc = JM.init_cache(j_cfg, 2, 64)
    jl, jc = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(prompt)}, jc)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    tl, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    _close(tl, jl, 1e-4)
    toks = _tokens(cfg, (2, 5), 2)
    j_out, _ = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(toks))
    out, _ = M.decode_step(cfg, params, tc, torch.from_numpy(toks))
    _close(out, j_out, 1e-4)
    # the committed chain: two tokens, a commit, then the rest
    _, st2 = M.decode_step(cfg, params, tc, torch.from_numpy(toks[:, :2]))
    M.commit_cache(cfg, tc, st2, torch.arange(2), torch.tensor(2, dtype=torch.int32))
    rest, _ = M.decode_step(cfg, params, tc, torch.from_numpy(toks[:, 2:]))
    _close(rest, out[:, 2:], 1e-4)
    # decode_commit_token: one token decoded and committed at once
    tc1 = M.init_cache(cfg, 2, 64, device="cpu")
    M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc1)
    first, _ = M.decode_commit_token(cfg, params, tc1, torch.from_numpy(toks[:, 0]))
    _close(first, out[:, 0], 1e-4)
    nxt, _ = M.decode_step(cfg, params, tc1, torch.from_numpy(toks[:, 1:]))
    _close(nxt, out[:, 1:], 1e-4)


def _random_cache(j_cfg, B, paged: bool, seed: int):
    """A reference cache (numpy) with every leaf random and, paged, a
    scrambled table; ``pos`` 10 / 20 / 7."""
    rng = np.random.default_rng(seed)
    kw = dict(paged=True, page_size=16) if paged else {}
    c = jax.tree.map(np.asarray, JM.init_cache(j_cfg, B, 64, **kw))
    c = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
                     if a.dtype.kind == "f" else a, c)
    c["pos"] = np.array([10, 20, 7][:B], np.int32)
    if paged:
        n_pp = c["page_table"].shape[1]
        c["page_table"] = rng.permutation(B * n_pp).reshape(B, n_pp).astype(np.int32)
        c["page_table"][2, 1:] = -1
    return c


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_commit_cache_and_write_slot_match_reference(paged):
    """jamba (mamba and attention layers), B=3: a T=5 decode committed with
    ``n_accept`` 0, 2 and 5 in one batch; then a B=1 prefill written into
    slot 1."""
    cfg, j_cfg, j_params, params = _model("jamba-v0.1-52b")
    c_np = _random_cache(j_cfg, 3, paged, 3)
    jc = jax.tree.map(jnp.asarray, c_np)
    tc = bridge.cache_from_jax(c_np, device="cpu")
    toks = _tokens(cfg, (3, 5), 4)
    _, j_st = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(toks))
    _, st = M.decode_step(cfg, params, tc, torch.from_numpy(toks))
    path = np.tile(np.arange(5, dtype=np.int32), (3, 1))
    n_acc = np.array([0, 2, 5], np.int32)
    jc = JM.commit_cache(j_cfg, jc, j_st, jnp.asarray(path), jnp.asarray(n_acc))
    M.commit_cache(cfg, tc, st, torch.from_numpy(path), torch.from_numpy(n_acc))
    for seg, j_seg in zip(tc["segments"], jc["segments"]):
        for unit, j_unit in zip(seg, j_seg):
            for n in unit:
                _close(unit[n], j_unit[n], 1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), [10, 22, 12])
    mamba = tc["segments"][0][0]
    for n in STATE:                                             # n_accept 0 keeps the state
        np.testing.assert_array_equal(mamba[n][:, 0].numpy(), c_np["segments"][0][0][n][:, 0])
    # admission: a fresh B=1 prefill into slot 1
    prompt = _tokens(cfg, (1, 13), 5)
    j1 = JM.init_cache(j_cfg, 1, 16)
    _, j1 = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(prompt)}, j1)
    c1 = M.init_cache(cfg, 1, 16, device="cpu")
    M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, c1)
    jc = JM.write_slot(j_cfg, jc, j1, 1)
    M.write_slot(cfg, tc, c1, 1)
    for seg, j_seg in zip(tc["segments"], jc["segments"]):
        for unit, j_unit in zip(seg, j_seg):
            for n in unit:
                if paged and n.endswith("_pages"):              # the slot's live rows
                    rows = tc["page_table"][1].long()
                    _close(unit[n][:, rows], np.asarray(j_unit[n])[:, rows.numpy()], 1e-5)
                else:
                    _close(unit[n], j_unit[n], 1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_training_a_mamba_stack_raises(capsys):
    """mamba2's ``forward_train`` (the chunked scan over a fresh zero state)
    gives the reference's logits within 1e-4, and the train CLI takes a
    step on jamba. (The name is from when training them raised.)"""
    cfg, j_cfg, j_params, params = _model("mamba2-130m")
    toks = _tokens(cfg, (1, 12), 4)
    jl, _ = JM.forward_train(j_cfg, j_params, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, aux = M.forward_train(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, 1e-4)
    assert float(aux) == 0.0
    train.main(["--device", "cpu", "--reduced", "--arch", "jamba-v0.1-52b", "--steps", "1",
                "--batch", "1", "--seq", "8"])
    assert "1 steps in" in capsys.readouterr().out


# ------------------------------------------------------------------- bridge
def test_bfloat16_bridge_and_checkpoint_keep_the_ssm_constants_float32(tmp_path):
    cfg, _, j_params, params = _model("jamba-v0.1-52b")
    fixed = ("['A_log']", "['D']", "['dt_bias']", "['w_router']")
    bf = _flat(bridge.params_from_jax(jax.tree.map(np.asarray, j_params), device="cpu",
                                      dtype=torch.bfloat16))
    f32 = _flat(params)
    JT.save_checkpoint(str(tmp_path), j_params, step=1)
    ck = _flat(bridge.params_from_checkpoint(str(tmp_path), cfg, device="cpu",
                                             dtype=torch.bfloat16))
    assert sum(k.endswith(fixed[:3]) for k in bf) == 3            # one stacked mamba unit
    for flat in (bf, ck):
        for key, t in flat.items():
            if key.endswith(fixed):
                assert t.dtype == torch.float32 and torch.equal(t, f32[key]), key
            else:
                assert t.dtype == torch.bfloat16, key


# ------------------------------------------------------------ single stream
N_TOK = 16
SINGLE = {
    "pld": (PLDScheduler, JPLD, None),
    "swift": (SDScheduler, JSD, 0.5),
}


def _prompt(cfg, seed):
    """An 8-token motif repeated 4 times."""
    return np.tile(_tokens(cfg, (8,), seed), 4)


def _stream(engine, make_sched, prompt):
    engine.costs.observe = lambda *a, **k: None
    engine.costs.observe_target = lambda *a, **k: None
    engine.start(prompt)
    return make_sched(engine).generate(N_TOK)


@functools.lru_cache(maxsize=None)
def _ar(arch: str, seed: int):
    cfg, _, _, params = _model(arch)
    return _stream(SpecEngine(cfg, params, max_len=128, device="cpu"), ARScheduler,
                   _prompt(cfg, seed))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_chain_schedulers_equal_ar_and_reference(arch, name):
    cfg, j_cfg, j_params, params = _model(arch)
    sched, j_sched, ls = SINGLE[name]
    make = (lambda e: sched(e, dsia.layer_sparsity(cfg, ls))) if ls else sched
    j_make = (lambda e: j_sched(e, j_dsia.layer_sparsity(j_cfg, ls))) if ls else j_sched
    prompt = _prompt(cfg, 0)
    engine = SpecEngine(cfg, params, max_len=128, device="cpu")
    got = _stream(engine, make, prompt)
    want = _stream(JEngine(j_cfg, j_params, max_len=128), j_make, prompt)
    assert got == want == _ar(arch, 0)
    if name == "pld":                                          # the reference's AR too
        assert _stream(JEngine(j_cfg, j_params, max_len=128), JAR, prompt) == want
    assert engine.draft_exec == ("slice" if arch == "mamba2-130m" else "mask")
    if name == "swift":
        assert engine.stats["rounds"] < N_TOK                    # drafts were accepted


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_are_refused(arch):
    """DyTC and the tree baseline raise at construction; a branching tree
    raises at verify and a chain does not."""
    cfg, _, _, params = _model(arch)
    engine = SpecEngine(cfg, params, max_len=64, device="cpu")
    engine.start(_prompt(cfg, 1))
    msg = "staged SSM states are chain-ordered and cannot follow tree paths"
    with pytest.raises(ValueError, match=msg):
        DyTCScheduler(engine, build_hierarchy(cfg))
    with pytest.raises(ValueError, match=msg):
        TreeScheduler(engine, dsia.layer_sparsity(cfg, 0.5))
    tree = DraftTree(engine.pending)
    tree.add_child(0, 3, "x", 0.5)
    tree.add_child(0, 4, "x", 0.5)
    with pytest.raises(ValueError, match=msg):
        engine.verify_and_commit(tree)
    assert engine.stats["rounds"] == 0
    assert len(engine.verify_and_commit(chain_tree(engine.pending, [3, 4], "x", 0.5))) >= 1


# ------------------------------------------------------------------ serving
SPEC_KW = dict(name="ls_draft", gates=(1, 0, 1, 1), prior_alpha=0.6, prior_c=0.2)
SERVE_KW = dict(max_batch=2, max_len=128, draft_k=4, adaptive=True, min_obs=1)
SERVED = {
    "chain_fused single dense": ("chain_fused", dict(round_mode="single")),
    "chain_fused single paged": ("chain_fused", dict(round_mode="single", paged=True,
                                                      page_size=16)),
    "chain_fused split": ("chain_fused", dict(round_mode="split")),
    "legacy": ("legacy", {}),
}
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
ROUNDS = 5
# every structure on jamba's hybrid stack (mamba, attention, paged attention,
# MoE); a single and a split one on mamba2's homogeneous stack (slice exec)
SERVED_CASES = ([("jamba-v0.1-52b", n) for n in sorted(SERVED)]
                + [("mamba2-130m", n) for n in ("chain_fused single dense", "legacy")])


def _serve(srv, prompts, per_request=None, cls=SamplingParams):
    for i, p in enumerate(prompts):
        if per_request is None:
            srv.add_request(i, p)
        else:
            srv.add_request(i, p, sampling=cls(**per_request[i]))
    gen, rounds = {i: [] for i in range(len(prompts))}, []
    for _ in range(ROUNDS):
        out = srv.step()
        rounds.append(out)
        for b, t in out.items():
            gen[b].extend(t)
    for b, t in srv.flush().items():
        gen[b].extend(t)
    return gen, rounds


def _servers(arch, mode, kw, sampling=None):
    cfg, j_cfg, j_params, params = _model(arch)
    kw = dict(SERVE_KW, mode=mode, **kw)
    j_srv = JServer(j_cfg, j_params, draft_spec=JDraftSpec(**SPEC_KW), telemetry=False,
                    sampling=None if sampling is None else JSamplingParams(**sampling), **kw)
    srv = BatchedSpecServer(cfg, params, draft_spec=DraftSpec(**SPEC_KW), device="cpu",
                            sampling=None if sampling is None else SamplingParams(**sampling),
                            **kw)
    for s in (srv, j_srv):                      # wall-clock trackers at their priors
        s.costs.observe = lambda *a, **k: None
        s.costs.observe_target = lambda *a, **k: None
    return srv, j_srv


@pytest.mark.parametrize("arch,name", SERVED_CASES)
def test_chain_servers_match_reference_round_by_round(arch, name):
    """The port's server gives the reference server's tokens round by round,
    each stream a prefix of AR's, with recomputed draft KV."""
    cfg = _model(arch)[0]
    mode, kw = SERVED[name]
    srv, j_srv = _servers(arch, mode, kw)
    assert srv.draft_kv == j_srv.draft_kv == "recompute"
    prompts = [_prompt(cfg, 0), _tokens(cfg, (19,), 5)]
    gen, rounds = _serve(srv, prompts)
    j_gen, j_rounds = _serve(j_srv, prompts)
    assert rounds == j_rounds and gen == j_gen
    assert gen[0] == _ar(arch, 0)[:len(gen[0])] and len(gen[0]) >= ROUNDS
    if kw.get("round_mode") == "single":
        assert srv.stats["round_dispatches"] == srv.stats["steps"] == ROUNDS


@pytest.mark.parametrize("arch,round_mode", [("jamba-v0.1-52b", "single"),
                                             ("mamba2-130m", "split")])
def test_sampled_chain_streams_equal_reference(arch, round_mode):
    """Per-request seeds 11 and 12 at T 0.8, top-k 20, top-p 0.9: the port's
    stochastic stream is the reference server's, token for token."""
    cfg = _model(arch)[0]
    srv, j_srv = _servers(arch, "chain_fused", dict(round_mode=round_mode), dict(SAMPLED, seed=7))
    seeded = [dict(SAMPLED, seed=11 + i) for i in range(2)]
    prompts = [_prompt(cfg, 0), _tokens(cfg, (19,), 5)]
    gen, _ = _serve(srv, prompts, seeded)
    j_gen, _ = _serve(j_srv, prompts, seeded, JSamplingParams)
    assert gen == j_gen and all(len(t) > 0 for t in gen.values())
    np.testing.assert_array_equal(srv.dstate["key"].numpy(),
                                  np.asarray(j_srv.dstate["key"]).astype(np.int64))


REFUSED = {
    "carry": ("chain_fused", dict(draft_kv="carry"), "draft_kv='carry' requires an attention-only"),
    "tree_fused": ("tree_fused", {}, "staged SSM states are chain-ordered"),
    "cascade_fused": ("cascade_fused", dict(draft_spec=None), "staged SSM states are chain-ordered"),
    "prefill_chunk": ("chain_fused", dict(paged=True, page_size=16, prefill_chunk=8),
                      "prefill_chunk requires an attention-only text stack"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_server_refuses_what_the_reference_refuses(name):
    """Both packages raise ValueError in the same words on mamba2's stack."""
    cfg, j_cfg, j_params, params = _model("mamba2-130m")
    mode, kw, msg = REFUSED[name]
    kw = dict(dict(SERVE_KW, mode=mode, draft_spec=True), **kw)
    for ref in (False, True):
        args = dict(kw)
        if args["draft_spec"]:
            args["draft_spec"] = JDraftSpec(**SPEC_KW) if ref else DraftSpec(**SPEC_KW)
        with pytest.raises(ValueError, match=msg):
            if ref:
                JServer(j_cfg, j_params, telemetry=False, **args)
            else:
                BatchedSpecServer(cfg, params, device="cpu", **args)


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_ssm_configs(arch, capsys):
    for sched in ("ar", "swift"):
        serve.main(["--device", "cpu", "--reduced", "--arch", arch, "--scheduler", sched,
                    "--tokens", "3"])
        assert '"delivered_tokens": 3' in capsys.readouterr().out.splitlines()[-1]
    serve.main(["--device", "cpu", "--reduced", "--arch", arch, "--mesh", "model=1,data=1",
                "--mode", "chain_fused", "--batch", "2", "--tokens", "3"])
    assert '"delivered_tokens": ' in capsys.readouterr().out.splitlines()[-1]
    for sched in ("dytc", "tree"):
        with pytest.raises(SystemExit, match="cannot follow tree paths"):
            serve.main(["--device", "cpu", "--reduced", "--arch", arch, "--scheduler", sched])
