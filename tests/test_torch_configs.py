"""The port's other attention-only models against the JAX reference, on the
CPU in float32: internlm2-20b (GQA rep 6), starcoder2-3b (GQA rep 12, the
2-matrix GeLU MLP), stablelm-1.6b (hd 64, MHA) and gemma3-1b (hd 288 at full
width, MQA, tied embeddings, a mixed sliding/global stack).

Configs: every field of the port's config equals the reference's, full and
``reduced()``, as do the input shapes. Models, on ``reduced()`` params
carried across by ``repro_torch.bridge``: prefill and decode logits within
1e-4 (float32 on both sides, summation order differs); a joint T-token
decode equals two decodes with a commit between them, and gemma3's ring
cache equals its full cache past the window, within 1e-4. ``reduced()``
gives hd 64 everywhere, so gemma3 also runs at hd 288 (its full-width head
dim). Streams are exact: DyTC equals AR and the reference engine's stream
on each model, and on gemma3's mixed stack the single-round server
(``tree_fused`` dense, ``chain_fused`` paged with chunked prefill) equals
the reference server round by round and AR. The kernels run as their
plain versions here (``kernels/ref.py``); the reference through
``repro.kernels.ops`` in interpret mode, as its own tests run it.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as j_config  # noqa: E402
from repro.core.cascade import ARScheduler as JAR  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.dsia import build_hierarchy as j_build_hierarchy  # noqa: E402
from repro.core.dytc import DyTCScheduler as JDyTC  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro.training import checkpoint as JT  # noqa: E402
import repro_torch.config as config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402

NEW = ("internlm2-20b", "starcoder2-3b", "stablelm-1.6b", "gemma3-1b")
ATOL = 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _cfgs(arch: str, **kw):
    """(port cfg, reference cfg), reduced; ``arch@hd288`` is gemma3 at its
    full-width head dim."""
    name, _, hd = arch.partition("@hd")
    kw = dict(kw, head_dim=int(hd)) if hd else kw
    return tuple(dataclasses.replace(get(name).reduced(), **kw)
                 for get in (config.get_config, j_config.get_config))


@functools.lru_cache(maxsize=None)
def _model(arch: str, layers: int = 0):
    """Reduced config (``layers`` > 0 sets the depth), the reference's
    seed-0 params and the same params in the port."""
    cfg, j_cfg = _cfgs(arch, **({"num_layers": layers} if layers else {}))
    j_params = JM.init_params(j_cfg, jax.random.PRNGKey(0))
    return cfg, j_cfg, j_params, bridge.params_from_jax(jax.tree.map(np.asarray, j_params),
                                                        device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=shape).astype(np.int32)


# -------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(config.list_configs()))
def test_config_equals_reference(arch):
    got, want = config.get_config(arch), j_config.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.resolved_head_dim() == want.resolved_head_dim()


def test_registry_and_input_shapes_equal_reference():
    assert config.list_configs() == sorted(("vicuna-7b", "qwen2-moe-a2.7b", "mixtral-8x22b",
                                            "mamba2-130m", "jamba-v0.1-52b", "musicgen-medium",
                                            "llava-next-mistral-7b") + NEW)
    assert config.list_configs() == j_config.list_configs()
    assert sorted(config.INPUT_SHAPES) == sorted(j_config.INPUT_SHAPES)
    for name in j_config.INPUT_SHAPES:
        assert dataclasses.asdict(config.get_shape(name)) == dataclasses.asdict(
            j_config.get_shape(name))
    assert isinstance(config.get_shape("decode_32k"), config.InputShape)
    assert [f.name for f in dataclasses.fields(config.InputShape)] == [
        f.name for f in dataclasses.fields(j_config.InputShape)]
    with pytest.raises(KeyError):
        config.get_shape("decode_64k")
    with pytest.raises(KeyError):
        config.get_config("musicgen-small")
    # the codebook stack's tables: one embedding and one head a codebook
    meta = M.init_params(config.get_config("musicgen-medium").reduced(), device="meta")
    assert tuple(meta["embed"].shape) == (4, 512, 256)
    assert tuple(meta["lm_head"].shape) == (4, 256, 512)


def test_full_width_shapes_of_the_new_models():
    """The head dims, GQA reps and layer kinds the kernels meet at full
    width."""
    shapes = {a: (c.resolved_head_dim(), c.num_heads // c.num_kv_heads)
              for a, c in ((a, config.get_config(a)) for a in NEW)}
    assert shapes == {"internlm2-20b": (128, 6), "starcoder2-3b": (128, 12),
                      "stablelm-1.6b": (64, 1), "gemma3-1b": (288, 4)}
    g = config.get_config("gemma3-1b")
    kinds = [g.attention_kind(i).value for i in range(g.num_layers)]
    assert kinds.count("sliding") == 22 and kinds.count("full") == 4
    assert [s.repeats for s in M.layout(g)] == [4, 1]


# ---------------------------------------------------------------------- bridge
@pytest.mark.parametrize("arch", NEW)
def test_bridge_and_checkpoint_carry_every_leaf(arch, tmp_path):
    """``params_from_jax`` and ``params_from_checkpoint`` give the port's own
    layout (gemma3: a tied ``embed`` and no ``lm_head``; starcoder2: no
    ``w_gate``), bitwise."""
    cfg, _, j_params, params = _model(arch)
    meta = M.init_params(cfg, device="meta")
    assert ("lm_head" in params) == (not cfg.tie_embeddings) == ("lm_head" in meta)
    assert ("w_gate" in params["segments"][0][0]["mlp"]) == cfg.mlp_gated
    want = _flat(params)
    assert {k: tuple(t.shape) for k, t in want.items()} == {
        k: tuple(t.shape) for k, t in _flat(meta).items()}
    JT.save_checkpoint(str(tmp_path), j_params, step=1)
    got = _flat(bridge.params_from_checkpoint(str(tmp_path), cfg, device="cpu"))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def _flat(tree, path=""):
    """{key path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items() for k, v in _flat(sub, f"{path}/{n}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


# ---------------------------------------------------------------------- models
MODEL_CASES = NEW + ("gemma3-1b@hd288",)


@pytest.mark.parametrize("arch", MODEL_CASES)
def test_prefill_and_decode_match_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch)
    prompt, T = _tokens(cfg, (2, 21), 1), 5
    jc = JM.init_cache(j_cfg, 2, 64)
    jl, jc = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(prompt)}, jc)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    tl, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    _close(tl, jl)
    toks = _tokens(cfg, (2, T), 2)
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = False                                          # a branch
    j_out, j_st = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(toks), tree_mask=jnp.asarray(tm))
    out, st = M.decode_step(cfg, params, tc, torch.from_numpy(toks), tree_mask=torch.from_numpy(tm))
    _close(out, j_out)
    _close(st[0][-1]["v"], j_st[0][-1]["v"], 1e-5)


@pytest.mark.parametrize("arch", MODEL_CASES)
def test_joint_decode_equals_commit_chain(arch):
    """Joint 3-token decode == 2 tokens, a commit, then the third
    (``tests/test_arch_smoke.py::test_commit_chain_vs_sequential``)."""
    cfg, _, _, params = _model(arch)
    cache = M.init_cache(cfg, 2, 64, device="cpu")
    M.prefill(cfg, params, {"tokens": torch.from_numpy(_tokens(cfg, (2, 16), 1))}, cache)
    t3 = torch.from_numpy(_tokens(cfg, (2, 3), 2))
    joint, _ = M.decode_step(cfg, params, cache, t3)
    _, st2 = M.decode_step(cfg, params, cache, t3[:, :2])
    M.commit_cache(cfg, cache, st2, torch.arange(2), torch.tensor(2, dtype=torch.int32))
    last, _ = M.decode_step(cfg, params, cache, t3[:, 2:])
    _close(last[:, 0], joint[:, 2])


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-1b@hd288"])
def test_ring_cache_equals_full_cache_past_the_window(arch):
    """gemma3 with a 16-token window and a 40-token prompt: prefill and
    decode over window-sized ring caches of its sliding layers equal those
    over full caches, and the reference's
    (``tests/test_arch_smoke.py::test_sliding_window_ring_decode``)."""
    cfg, j_cfg = _cfgs(arch, sliding_window=16)
    _, _, j_params, params = _model(arch)
    toks = _tokens(cfg, (1, 40), 1)
    outs = {}
    for ring in (False, True):
        tc = M.init_cache(cfg, 1, 128, ring_window=ring, device="cpu")
        last, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, tc)
        nxt = last.argmax(-1)[:, None]
        outs[ring] = (last, M.decode_step(cfg, params, tc, nxt)[0])
    assert M.init_cache(cfg, 1, 128, ring_window=True, device="cpu")["segments"][0][0]["k"].shape[2] == 16
    _close(outs[True][0], outs[False][0])
    _close(outs[True][1], outs[False][1])
    jc = JM.init_cache(j_cfg, 1, 128, ring_window=True)
    jl, jc = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(toks)}, jc)
    j_out, _ = JM.decode_step(j_cfg, j_params, jc, jnp.argmax(jl, -1)[:, None])
    _close(outs[True][1], j_out)


# ------------------------------------------------------------ token identity
N_TOK = 12


def _stream(engine, make_sched, prompt):
    """N_TOK greedy tokens, the engine's cost tracker pinned to the draft
    priors (as ``tests/test_torch_engine.py`` does)."""
    engine.costs.observe = lambda *a, **k: None
    engine.costs.observe_target = lambda *a, **k: None
    engine.start(prompt)
    return make_sched(engine).generate(N_TOK)


@pytest.mark.parametrize("arch", NEW)
def test_dytc_streams_equal_ar_and_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch, layers=4)
    prompt = np.tile(_tokens(cfg, (5,), 3), 3)
    ar = _stream(SpecEngine(cfg, params, max_len=64, device="cpu"), ARScheduler, prompt)
    engine = SpecEngine(cfg, params, max_len=64, device="cpu")
    dytc = _stream(engine, lambda e: DyTCScheduler(e, build_hierarchy(cfg)), prompt)
    j_dytc = _stream(JEngine(j_cfg, j_params, max_len=64),
                     lambda e: JDyTC(e, j_build_hierarchy(j_cfg)), prompt)
    assert dytc == ar == j_dytc
    assert engine.draft_exec == ("mask" if arch == "gemma3-1b" else "slice")
    assert engine.stats["rounds"] < N_TOK                     # DyTC accepted drafts


def test_reference_engine_ar_equals_port_on_gemma3_at_hd288():
    cfg, j_cfg, j_params, params = _model("gemma3-1b@hd288")
    prompt = np.tile(_tokens(cfg, (5,), 3), 3)
    ar = _stream(SpecEngine(cfg, params, max_len=64, device="cpu"), ARScheduler, prompt)
    assert ar == _stream(JEngine(j_cfg, j_params, max_len=64), JAR, prompt)


# --------------------------------------------------- serving gemma3 (mixed)
SPEC_KW = dict(name="mask_draft", gates=(1, 1, 0, 1), prior_alpha=0.6, prior_c=0.2)
SERVE_KW = dict(max_batch=2, max_len=128, draft_k=4, tree_expansions=3, adaptive=True,
                min_obs=1, round_mode="single")
SERVED = {
    "tree_fused dense": dict(mode="tree_fused"),
    "chain_fused paged, chunked prefill": dict(mode="chain_fused", paged=True, page_size=16,
                                               prefill_chunk=8),
}


@pytest.fixture(scope="module")
def gemma3_ar():
    cfg, _, _, params = _model("gemma3-1b")
    prompts = [np.tile(_tokens(cfg, (5,), 4), 3), _tokens(cfg, (19,), 5)]
    streams = []
    for p in prompts:
        eng = SpecEngine(cfg, params, max_len=128, device="cpu")
        eng.start(p)
        streams.append(eng.generate_ar(24))
    return prompts, streams


@pytest.mark.parametrize("name", sorted(SERVED))
def test_single_rounds_over_gemma3s_mixed_stack(gemma3_ar, name):
    """Mask exec in single rounds: the port's server gives the reference
    server's tokens round by round, one dispatch a round, and every stream
    is a prefix of AR's."""
    cfg, j_cfg, j_params, params = _model("gemma3-1b")
    assert len(M.layout(cfg)[0].unit) == 2                   # sliding, full: a mixed stack
    prompts, ar = gemma3_ar
    kw = dict(SERVE_KW, **SERVED[name])
    ref = JServer(j_cfg, j_params, draft_spec=JDraftSpec(**SPEC_KW), draft_kv="recompute",
                  telemetry=False, **kw)
    port = BatchedSpecServer(cfg, params, draft_spec=DraftSpec(**SPEC_KW), device="cpu", **kw)
    assert port._layer_ids is None and port._gates.device.type == "cpu"
    for i, p in enumerate(prompts):
        ref.add_request(i, p)
        port.add_request(i, p)
    gen = {i: [] for i in range(len(prompts))}
    for r in range(6):
        out = port.step()
        assert out == ref.step(), f"round {r}"
        for b, t in out.items():
            gen[b].extend(t)
    assert port.flush() == ref.flush() == {}
    assert port.stats["round_dispatches"] == port.stats["steps"] == 6
    assert port.stats["draft_rounds"] > 0
    for b in gen:
        assert len(gen[b]) > 2 and gen[b] == ar[b][:len(gen[b])], f"slot {b} left AR"


# ------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", NEW)
def test_clis_take_every_config(arch, capsys, tmp_path):
    """``--arch`` takes every registered config; ``--device cpu --reduced``
    serves (AR and DyTC, 3 tokens) and trains (one step) on the CPU."""
    for sched in ("ar", "dytc"):
        serve.main(["--device", "cpu", "--reduced", "--arch", arch, "--scheduler", sched,
                    "--tokens", "3"])
        assert '"delivered_tokens": 3' in capsys.readouterr().out.splitlines()[-1]
    train.main(["--device", "cpu", "--reduced", "--arch", arch, "--steps", "1", "--batch", "2",
                "--seq", "16"])
    assert "1 steps in" in capsys.readouterr().out
    assert serve.build_parser().parse_args(["--arch", "musicgen-medium"]).arch == "musicgen-medium"
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--arch", "musicgen-small"])


# ------------------------------------------------------------ import isolation
def test_port_imports_neither_jax_nor_the_reference():
    """Importing every module of ``repro_torch`` loads no ``jax`` and no
    module of the reference package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import repro_torch.configs
        assert {"repro_torch.configs.gemma3_1b", "repro_torch.configs.internlm2_20b",
                "repro_torch.configs.starcoder2_3b", "repro_torch.configs.stablelm_1_6b",
                "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.mixtral_8x22b",
                "repro_torch.models.moe", "repro_torch.kernels.moe_grouped",
                "repro_torch.models.ssm", "repro_torch.configs.mamba2_130m",
                "repro_torch.configs.jamba_v0_1_52b", "repro_torch.configs.musicgen_medium",
                "repro_torch.configs.llava_next_mistral_7b",
                "repro_torch.config.shapes"} <= set(sys.modules), names
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
                     or m.startswith("repro."))
        print(len(names), bad)
    """)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 40 and bad.strip() == "[]", out.stdout
