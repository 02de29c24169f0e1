"""The port's codebook and image stacks against the JAX reference, on the CPU
in float32: musicgen-medium (4 EnCodec codebooks, MHA, a 2-matrix GeLU MLP)
and llava-next-mistral-7b (a Mistral-7B text stack that splices image patch
embeddings in front of the text), each at its ``reduced()`` width.

Configs equal the reference's field for field (full and ``reduced()``), and
the port's own draw has as many parameters as the reference's
``param_count``; params cross the bridge and checkpoints both ways with the
reference's shapes (a codebook ``embed`` (4, V, d) and ``lm_head`` (4, d,
V)). Models, on the reference's seed-0 params carried across: musicgen's
prefill and (B, T, 4) decode logits within 1e-4, and a joint T=3 decode
equals two decodes, a commit, then the third; llava's prefill with
``image_embeds`` and ``image_mask`` (16 image tokens) and the decode after
it within 1e-4; ``forward_train`` logits and ``loss_fn`` within 1e-5 and
every gradient leaf within 1e-5 of ``jax.grad``, for both stacks. llava
serves as a text stack: ``SpecEngine`` DyTC and a ``tree_fused`` server give
the reference's streams exactly. musicgen is refused with one
``ValueError`` by the engine, by ``chain_fused`` and ``legacy`` (codebook
tokens are not scalar) and by ``tree_fused`` and ``cascade_fused`` (the
reference's "attention-only" words), and both CLIs exit with a message.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as j_config  # noqa: E402
from repro import training as JT  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.dsia import build_hierarchy as j_build_hierarchy  # noqa: E402
from repro.core.dytc import DyTCScheduler as JDyTC  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402
import repro_torch.config as config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import training as T  # noqa: E402
from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402
from repro_torch.training.checkpoint import map_with_path  # noqa: E402

ARCHS = ("musicgen-medium", "llava-next-mistral-7b")
MUSIC, LLAVA = ARCHS


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _model(arch: str, layers: int = 0):
    """Reduced config (``layers`` > 0 sets the depth), the reference's
    seed-0 params and the same params in the port."""
    kw = {"num_layers": layers} if layers else {}
    cfg = dataclasses.replace(config.get_config(arch).reduced(), **kw)
    j_cfg = dataclasses.replace(j_config.get_config(arch).reduced(), **kw)
    j_params = JM.init_params(j_cfg, jax.random.PRNGKey(0))
    return cfg, j_cfg, j_params, bridge.params_from_jax(jax.tree.map(np.asarray, j_params),
                                                        device="cpu")


def _params(arch: str) -> dict:
    """A fresh port copy of the reference's params (training writes in place)."""
    return bridge.params_from_jax(jax.tree.map(np.asarray, _model(arch)[2]), device="cpu")


def _batch(cfg, B, S, seed, images: bool = True) -> dict:
    """Tokens (B, S) or codes (B, S, nc); on the image stack, ``images``
    adds ``image_embeds`` (B, Ti, d) times 0.02 and a mask over the first Ti
    positions (the reference's ``tests/test_arch_smoke.py::make_batch``)."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)}
    if cfg.num_image_tokens and images:
        Ti = cfg.num_image_tokens
        b["image_embeds"] = (rng.standard_normal((B, Ti, cfg.d_model)) * 0.02).astype(np.float32)
        b["image_mask"] = np.zeros((B, S), np.int32)
        b["image_mask"][:, :Ti] = 1
    return b


def _j(batch: dict) -> dict:
    return jax.tree.map(jnp.asarray, batch)


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda k, t: out.__setitem__(k, t), tree)
    return out


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_count_equal_reference(arch):
    got, want = config.get_config(arch), j_config.get_config(arch)
    for a, b in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        # the draw holds the reference's analytic count (its padded vocab aside)
        n = sum(math.prod(t.shape) for t in M.tree_leaves(M.init_params(a, device="meta")))
        heads = max(a.num_codebooks, 1) * (1 if a.tie_embeddings else 2)
        assert n == b.param_count() + heads * (a.padded_vocab - a.vocab_size) * a.d_model
    assert config.list_configs() == j_config.list_configs() and arch in config.list_configs()
    assert (got.num_codebooks, got.num_image_tokens) == ((4, 0) if arch == MUSIC else (0, 2880))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_the_bridge_and_checkpoints(arch, tmp_path):
    """The port's own draw, the bridged params and a checkpoint written by
    either package hold the reference's leaves and shapes; the crossings
    are bitwise."""
    cfg, j_cfg, j_params, params = _model(arch)
    want = {jax.tree_util.keystr(k).replace("][", "]/["): v.shape
            for k, v in jax.tree_util.tree_leaves_with_path(j_params)}
    for tree in (params, M.init_params(cfg, 1, device="cpu")):
        assert {k: tuple(t.shape) for k, t in _flat(tree).items()} == want
    nc = cfg.num_codebooks
    assert tuple(params["embed"].shape) == ((nc,) if nc else ()) + (cfg.padded_vocab, cfg.d_model)
    assert tuple(params["lm_head"].shape) == ((nc,) if nc else ()) + (cfg.d_model, cfg.padded_vocab)
    JT.save_checkpoint(str(tmp_path / "ref"), j_params, step=2)
    got = _flat(bridge.params_from_checkpoint(str(tmp_path / "ref"), cfg, device="cpu"))
    ref = _flat(params)
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    T.save_checkpoint(str(tmp_path / "port"), params, step=3)
    back, step = JT.load_checkpoint(str(tmp_path / "port"), j_params)
    assert step == 3
    for k, a in _flatten_with_paths(back)[0].items():
        np.testing.assert_array_equal(np.asarray(a), ref[k].numpy())


# ------------------------------------------------------------------- musicgen
def test_musicgen_prefill_and_decode_match_reference():
    cfg, j_cfg, j_params, params = _model(MUSIC)
    b = _batch(cfg, 2, 21, 1)
    jc = JM.init_cache(j_cfg, 2, 64)
    jl, jc = JM.prefill(j_cfg, j_params, _j(b), jc)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    tl, tc = M.prefill(cfg, params, _t(b), tc)
    assert tl.shape == (2, 4, cfg.padded_vocab)
    _close(tl, jl, 1e-4)
    toks = _batch(cfg, 2, 3, 2)["tokens"]                    # (B, T, nc)
    j_out, j_st = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(toks))
    out, st = M.decode_step(cfg, params, tc, torch.from_numpy(toks))
    assert out.shape == (2, 3, 4, cfg.padded_vocab)
    _close(out, j_out, 1e-4)
    _close(st[0][-1]["k"], j_st[0][-1]["k"], 1e-5)
    # the greedy next step, each codebook by its own argmax
    nxt = out[:, -1].argmax(-1)[:, None]                     # (B, 1, nc)
    assert nxt.shape == (2, 1, 4)


def test_musicgen_joint_decode_equals_commit_chain():
    """A joint T=3 decode of (B, 3, 4) codes == 2 steps, a commit, then the
    third (``tests/test_arch_smoke.py::test_commit_chain_vs_sequential``,
    whose tolerance is rtol 5e-3 / atol 5e-5; here atol 1e-4 alone)."""
    cfg, _, _, params = _model(MUSIC)
    cache = M.init_cache(cfg, 2, 64, device="cpu")
    M.prefill(cfg, params, _t(_batch(cfg, 2, 16, 1)), cache)
    t3 = torch.from_numpy(_batch(cfg, 2, 3, 2)["tokens"])
    joint, _ = M.decode_step(cfg, params, cache, t3)
    _, st2 = M.decode_step(cfg, params, cache, t3[:, :2])
    M.commit_cache(cfg, cache, st2, torch.arange(2), torch.tensor(2, dtype=torch.int32))
    assert cache["pos"].tolist() == [18, 18]
    last, _ = M.decode_step(cfg, params, cache, t3[:, 2:])
    _close(last[:, 0], joint[:, 2], 1e-4)


# ---------------------------------------------------------------------- llava
def test_llava_image_prefill_and_decode_match_reference():
    """``prefill`` with 16 image tokens spliced in front of 8 text tokens
    (the reference's arithmetic, ``e * (1 - mask) + img * mask``), then one
    greedy decode step; the same decode equals a fresh prefill of the
    extended batch (``tests/test_arch_smoke.py::test_reduced_smoke``)."""
    cfg, j_cfg, j_params, params = _model(LLAVA)
    assert cfg.num_image_tokens == 16
    b = _batch(cfg, 2, 24, 1)
    jc = JM.init_cache(j_cfg, 2, 64)
    jl, jc = JM.prefill(j_cfg, j_params, _j(b), jc)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    tl, tc = M.prefill(cfg, params, _t(b), tc)
    _close(tl, jl, 1e-4)
    text, _ = M.prefill(cfg, params, _t(_batch(cfg, 2, 24, 1, images=False)),
                        M.init_cache(cfg, 2, 64, device="cpu"))
    assert float((text - tl).abs().max()) > 1e-3             # the images changed the logits
    nxt = tl.argmax(-1)[:, None]
    j_out, _ = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(nxt.numpy()))
    out, _ = M.decode_step(cfg, params, tc, nxt)
    _close(out, j_out, 1e-4)
    b2 = dict(b, tokens=np.concatenate([b["tokens"], nxt.numpy()], axis=1),
              image_mask=np.pad(b["image_mask"], ((0, 0), (0, 1))))
    fresh, _ = M.prefill(cfg, params, _t(b2), M.init_cache(cfg, 2, 64, device="cpu"))
    _close(out[:, 0], fresh, 1e-4)


# ------------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_loss_match_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch)
    b = _batch(cfg, 2, 24, 3)
    want, j_aux = JM.forward_train(j_cfg, j_params, _j(b), remat=False)
    got, aux = M.forward_train(cfg, params, b, remat=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)
    assert float(aux) == float(j_aux) == 0.0
    b["loss_mask"] = (np.random.default_rng(4).random((2, 23)) < 0.6).astype(np.int32)
    want, jm = JT.loss_fn(j_cfg, j_params, _j(b), remat=False)
    got, tm = T.loss_fn(cfg, params, b)
    for k in ("ce", "moe_aux", "loss"):
        _close(tm[k], jm[k], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """Every gradient leaf (the codebook tables and heads, the layers, the
    norms) of the masked loss, atol 1e-5."""
    cfg, j_cfg, j_params, _ = _model(arch)
    b = _batch(cfg, 2, 24, 5)
    b["loss_mask"] = (np.random.default_rng(6).random((2, 23)) < 0.6).astype(np.int32)
    want = jax.jit(jax.grad(lambda p: JT.loss_fn(j_cfg, p, _j(b), remat=False)[0]))(j_params)
    params = _params(arch)
    leaves = [p.requires_grad_() for p in M.tree_leaves(params)]
    loss, _ = T.loss_fn(cfg, M.tree_unflatten(params, leaves), b)
    got = _flat(M.tree_unflatten(params, torch.autograd.grad(loss, leaves)))
    ref = _flatten_with_paths(want)[0]
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], 1e-5)


# -------------------------------------------------- llava serves as text
N_TOK = 12
SPEC_KW = dict(name="ls_draft", gates=(1, 0, 1, 1), prior_alpha=0.6, prior_c=0.2)
SERVE_KW = dict(max_batch=2, max_len=128, draft_k=4, tree_expansions=3, adaptive=True,
                min_obs=1, round_mode="single")


def _stream(engine, make_sched, prompt):
    """N_TOK greedy tokens, the engine's cost tracker pinned to the draft
    priors (as ``tests/test_torch_engine.py`` does)."""
    engine.costs.observe = lambda *a, **k: None
    engine.costs.observe_target = lambda *a, **k: None
    engine.start(prompt)
    return make_sched(engine).generate(N_TOK)


def test_llava_text_streams_equal_reference():
    """``SpecEngine`` AR and DyTC, and a ``tree_fused`` single-round server,
    on llava's text stack: the reference's streams, round by round for the
    server, and every stream a prefix of AR's."""
    cfg, j_cfg, j_params, params = _model(LLAVA, layers=4)
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(2, cfg.vocab_size, size=5), 3).astype(np.int32),
               rng.integers(2, cfg.vocab_size, size=19).astype(np.int32)]
    ar = [_stream(SpecEngine(cfg, params, max_len=64, device="cpu"), ARScheduler, p)
          for p in prompts]
    engine = SpecEngine(cfg, params, max_len=64, device="cpu")
    dytc = _stream(engine, lambda e: DyTCScheduler(e, build_hierarchy(cfg)), prompts[0])
    j_dytc = _stream(JEngine(j_cfg, j_params, max_len=64),
                     lambda e: JDyTC(e, j_build_hierarchy(j_cfg)), prompts[0])
    assert dytc == ar[0] == j_dytc
    assert engine.stats["rounds"] < N_TOK                     # DyTC accepted drafts
    ref = JServer(j_cfg, j_params, draft_spec=JDraftSpec(**SPEC_KW), mode="tree_fused",
                  telemetry=False, **SERVE_KW)
    port = BatchedSpecServer(cfg, params, draft_spec=DraftSpec(**SPEC_KW), mode="tree_fused",
                             device="cpu", **SERVE_KW)
    assert port.draft_kv == ref.draft_kv == "carry"
    for i, p in enumerate(prompts):
        ref.add_request(i, p)
        port.add_request(i, p)
    gen = {i: [] for i in range(len(prompts))}
    for r in range(5):
        out = port.step()
        assert out == ref.step(), f"round {r}"
        for s, t in out.items():
            gen[s].extend(t)
    for s in gen:
        n = min(len(gen[s]), N_TOK)
        assert n > 2 and gen[s][:n] == ar[s][:n], f"slot {s} left AR"


# ------------------------------------------------------------ musicgen guards
GUARDED = {
    "SpecEngine": lambda cfg, p: SpecEngine(cfg, p, device="cpu"),
    "chain_fused": lambda cfg, p: BatchedSpecServer(cfg, p, mode="chain_fused", device="cpu"),
    "legacy": lambda cfg, p: BatchedSpecServer(cfg, p, mode="legacy", device="cpu"),
    "tree_fused": lambda cfg, p: BatchedSpecServer(cfg, p, mode="tree_fused", device="cpu"),
    "cascade_fused": lambda cfg, p: BatchedSpecServer(cfg, p, mode="cascade_fused",
                                                      device="cpu"),
    "chain_fused carry": lambda cfg, p: BatchedSpecServer(cfg, p, mode="chain_fused",
                                                          draft_kv="carry", device="cpu"),
}


@pytest.mark.parametrize("case", sorted(GUARDED))
def test_musicgen_guards(case):
    """One ``ValueError`` at construction: the text-stack guard in the
    engine, ``chain_fused`` and ``legacy``; the reference's words in
    ``tree_fused`` and ``cascade_fused`` (``tests/test_server_tree.py``'s
    "attention-only") and for carried draft KV."""
    cfg, _, _, params = _model(MUSIC)
    match = {"tree_fused": "attention-only", "cascade_fused": "attention-only",
             "chain_fused carry": "draft_kv='carry' requires an attention-only text stack"}
    with pytest.raises(ValueError, match=match.get(case, "codebook tokens are not scalar")):
        GUARDED[case](cfg, params)


def test_musicgen_clis_exit_with_a_message(capsys):
    for argv in (["--scheduler", "ar"], ["--mesh", "model=1,data=1", "--mode", "chain_fused"]):
        with pytest.raises(SystemExit, match="codebook tokens are not scalar"):
            serve.main(["--device", "cpu", "--reduced", "--arch", MUSIC, "--tokens", "3"] + argv)
    with pytest.raises(SystemExit, match=r"\(B, S, 4\) batches through .*make_train_step"):
        train.main(["--device", "cpu", "--reduced", "--arch", MUSIC, "--steps", "1"])
    # llava trains and serves as a text stack
    train.main(["--device", "cpu", "--reduced", "--arch", LLAVA, "--steps", "1", "--batch", "2",
                "--seq", "16"])
    serve.main(["--device", "cpu", "--reduced", "--arch", LLAVA, "--scheduler", "dytc",
                "--tokens", "3"])
    out = capsys.readouterr().out
    assert "1 steps in" in out and '"delivered_tokens": 3' in out.splitlines()[-1]
