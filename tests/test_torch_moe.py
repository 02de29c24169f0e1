"""The port's mixture-of-experts serving path against the JAX reference, on
the CPU in float32: ``repro_torch.models.moe`` (the router, the dropless
dispatch, shared experts), the grouped expert GEMM's plain version
(``kernels/ref.py::ref_moe_grouped``) and the two MoE models,
qwen2-moe-a2.7b (60 experts top-4, a sigmoid-gated shared block) and
mixtral-8x22b (8 experts top-2, sliding-window attention).

``moe_apply(mode="infer")`` equals the reference's within 1e-5 (gated and
2-matrix experts, with and without shared experts) and is batch-invariant
(``tests/test_moe.py::test_dropless_batch_invariance``); configs equal the
reference's field for field; on ``reduced()`` params carried across by
``repro_torch.bridge`` prefill and decode logits agree within 1e-4 and a
joint 3-token decode equals two decodes with a commit between them; the
bfloat16 bridge keeps the router in float32; the int8 DSIA level quantizes
no expert weight, as in the reference; DyTC streams equal AR and the
reference engine's; a single-round ``tree_fused`` server and a paged
``chain_fused`` one give the reference server's tokens round by round; the
serve CLI takes both ``--arch`` values. Every routing input is checked to
have no tie at the top-k boundary, so the two packages' top-k agree.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis", reason="needs hypothesis — pip install -r requirements-dev.txt")

from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as j_config  # noqa: E402
from repro.config.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core.dsia import build_hierarchy as j_build_hierarchy  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.core.dytc import DyTCScheduler as JDyTC  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.serving.draft_bank import DraftBank as JDraftBank  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro.training import checkpoint as JT  # noqa: E402
import repro_torch.config as config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config.base import MoEConfig  # noqa: E402
from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy  # noqa: E402
from repro_torch.core import dsia  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.kernels import moe_grouped, ref  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import BatchedSpecServer, DraftBank  # noqa: E402
from repro_torch.training.checkpoint import map_with_path  # noqa: E402

MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
D = 16


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _no_ties(x, w_router, k: int) -> None:
    """The k-th and (k+1)-th router probabilities of every row differ, so
    ``torch.topk`` and ``jax.lax.top_k`` pick the same experts."""
    x = torch.tensor(np.asarray(x, np.float32)).reshape(-1, w_router.shape[0])
    probs = torch.softmax(x @ torch.tensor(np.asarray(w_router, np.float32)), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    if top.shape[1] > k:
        assert float((top[:, k - 1] - top[:, k]).min()) > 1e-6, "a top-k tie in the inputs"


# ---------------------------------------------------------------- moe_apply
MOE_CASES = {
    "gated": (dict(), True),
    "2-matrix": (dict(), False),
    "gated, shared": (dict(num_shared_experts=2, d_ff_shared=32), True),
    "2-matrix, shared": (dict(num_shared_experts=2), False),
}


@functools.lru_cache(maxsize=None)
def _moe_params(case: str):
    kw, gated = MOE_CASES[case]
    j_moe = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=32, **kw)
    j_params = JMoE.moe_init(jax.random.PRNGKey(0), D, j_moe, gated, jnp.float32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, j_params), device="cpu")
    return MoEConfig(**dataclasses.asdict(j_moe)), j_moe, gated, j_params, params


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_apply_matches_reference(case, act):
    cfg_moe, j_moe, gated, j_params, params = _moe_params(case)
    x = np.random.default_rng(1).standard_normal((2, 5, D)).astype(np.float32)
    _no_ties(x, j_params["w_router"], cfg_moe.top_k)
    jy, jaux = JMoE.moe_apply(j_params, jnp.asarray(x), j_moe, act, gated, mode="infer")
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, act, gated, mode="infer")
    _close(y, jy, 1e-5)
    assert aux.keys() == jaux.keys()
    for k in aux:
        _close(aux[k], jaux[k], 1e-6)
    y2, none = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, act, gated, with_aux=False)
    assert none is None and torch.equal(y2, y)
    assert ("shared" in params) == bool(cfg_moe.num_shared_experts)


@given(seed=st.integers(0, 1000), n1=st.integers(1, 6), n2=st.integers(1, 6))
@settings(max_examples=8, deadline=None)
def test_dropless_batch_invariance(seed, n1, n2):
    """A token's output does not depend on the tokens batched with it
    (``tests/test_moe.py::test_dropless_batch_invariance``)."""
    cfg_moe, _, gated, _, params = _moe_params("gated, shared")
    rng = np.random.default_rng(seed)
    x1 = torch.from_numpy(rng.standard_normal((1, n1, D)).astype(np.float32))
    x2 = torch.from_numpy(rng.standard_normal((1, n2, D)).astype(np.float32))
    y1, _ = moe.moe_apply(params, x1, cfg_moe, "silu", gated)
    yb, _ = moe.moe_apply(params, torch.cat([x1, x2], dim=1), cfg_moe, "silu", gated)
    _close(y1[0], yb[0, :n1], 1e-5)


@pytest.mark.parametrize("mode", ["train", "infer_grouped"])
def test_moe_training_modes_raise(mode):
    """The grouped-capacity modes (at ``capacity_factor`` 1.25 and
    ``infer_capacity_factor`` 2.0) give the reference's output within 1e-5
    and its aux losses within 1e-6. (The name is from when they raised.)"""
    cfg_moe, j_moe, gated, j_params, params = _moe_params("gated, shared")
    x = np.random.default_rng(2).standard_normal((2, 7, D)).astype(np.float32)
    _no_ties(x, j_params["w_router"], cfg_moe.top_k)
    jy, jaux = JMoE.moe_apply(j_params, jnp.asarray(x), j_moe, "silu", gated, mode=mode)
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, "silu", gated, mode=mode)
    _close(y, jy, 1e-5)
    for k in jaux:
        _close(aux[k], jaux[k], 1e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        moe.moe_apply(params, torch.from_numpy(x), cfg_moe, "silu", gated, mode="grouped")


# ------------------------------------------------------- the grouped GEMM
GROUPED = {  # (E, rows per expert)
    "every expert": (4, (3, 1, 2, 5)),
    "most experts empty": (8, (0, 0, 6, 0, 0, 0, 1, 0)),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
@pytest.mark.parametrize("gated", [True, False])
def test_ref_moe_grouped_equals_explicit_loop(case, gated):
    """The plain version (one matmul per expert) equals the explicit rule
    row by row, and the wrapper takes it for CPU tensors."""
    E, sizes = GROUPED[case]
    K, N = 24, 40
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((sum(sizes), K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32))
    w_up = (torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32))
            if gated else None)
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = ref.ref_moe_grouped(x, w, offs, act="silu", w_mul=w_up)
    expert = np.repeat(np.arange(E), sizes)
    for r, e in enumerate(expert):
        want = torch.nn.functional.silu(x[r] @ w[e])
        if gated:
            want = want * (x[r] @ w_up[e])
        _close(got[r], want, 1e-5)
    before = moe_grouped.launches
    assert torch.equal(moe_grouped.moe_grouped(x, w, offs, act="silu", w_mul=w_up), got)
    assert torch.equal(moe_grouped.moe_grouped(x, w, offs), ref.ref_moe_grouped(x, w, offs))
    assert moe_grouped.launches == before                      # the CPU runs no kernel


def test_moe_grouped_refuses_what_the_kernel_does_not_take():
    x, w = torch.zeros(4, 16), torch.zeros(2, 16, 8)
    offs = torch.tensor([0, 1, 4], dtype=torch.int32)
    bad = {
        "int64 offsets": lambda: moe_grouped.moe_grouped(x, w, offs.long()),
        "offsets of another length": lambda: moe_grouped.moe_grouped(x, w, offs[:2]),
        "mixed types": lambda: moe_grouped.moe_grouped(x, w.bfloat16(), offs),
        "float64": lambda: moe_grouped.moe_grouped(x.double(), w.double(), offs),
        "K not a multiple of 8": lambda: moe_grouped.moe_grouped(
            torch.zeros(4, 12), torch.zeros(2, 12, 8), offs),
        "a gate without activation": lambda: moe_grouped.moe_grouped(x, w, offs, w_mul=w),
        "non-contiguous weights": lambda: moe_grouped.moe_grouped(
            x, torch.zeros(2, 8, 16).transpose(1, 2), offs),
    }
    for name, call in bad.items():
        with pytest.raises((TypeError, ValueError)):
            call()
            pytest.fail(name)


def _expert_shapes():
    """Every (K, N, E) expert product of the registered configs, unsharded
    and at the model = 2 and 4 shard widths (the expert d_ff split over
    the model axis, ``launch/sharding.py``): the up projection (d, F / m)
    and the down projection (F / m, d)."""
    shapes = set()
    for arch in config.list_configs():
        cfg = config.get_config(arch)
        if cfg.moe is None:
            continue
        d, F, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
        for m in (1, 2, 4):
            shapes |= {(d, F // m, E), (F // m, d, E)}
    return sorted(shapes)


@pytest.mark.parametrize("K,N,E", _expert_shapes())
def test_grouped_plan_covers_every_config_shape(K, N, E):
    """Each expert shape of the eleven configs at model = 1, 2 and 4 meets
    the wrapper's contract and has a plan: the tensor-core kernel's ring of
    ``STAGES`` in bfloat16, none in float32 (the SIMT kernel's is fixed)."""
    assert K % 8 == 0 and N % 8 == 0
    assert moe_grouped._plan(K, N, E, torch.bfloat16) == moe_grouped.STAGES == 4
    assert moe_grouped._plan(K, N, E, torch.float32) == 0


def test_grouped_plan_reads_the_shapes_alone(monkeypatch):
    """``_plan`` takes (K, N, E, dtype) and nothing else, and the launch
    passes the C entry point the same plan whatever the row count and the
    offsets: every output element is reduced one way. Each type's kernel
    has its own launch count."""
    import inspect

    assert list(inspect.signature(moe_grouped._plan).parameters) == ["K", "N", "E", "dtype"]
    calls = []

    class Lib:
        def moe_grouped(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(moe_grouped._build, "load", lambda name, signatures: Lib())
    monkeypatch.setattr(moe_grouped._build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(moe_grouped, "launches", 0)
    monkeypatch.setattr(moe_grouped, "bf16_launches", 0)
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.zeros(4, 64, 136, dtype=dtype)
        for offs in ((0, 1, 1, 3, 3), (0, 70, 140, 141, 200)):
            x = torch.zeros(offs[-1], 64, dtype=dtype)
            moe_grouped._launch(x, w, torch.tensor(offs, dtype=torch.int32), "none", None)
        assert [c[12] for c in calls[-2:]] == [moe_grouped._plan(64, 136, 4, dtype)] * 2
    assert moe_grouped._launch(torch.zeros(0, 64), torch.zeros(4, 64, 136),
                               torch.zeros(5, dtype=torch.int32), "none", None).shape == (0, 136)
    assert len(calls) == 4                                      # no rows: no launch
    assert moe_grouped.launches == moe_grouped.bf16_launches == 2


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_equal_reference(arch):
    got, want = config.get_config(arch), j_config.get_config(arch)
    for a, b in ((got, want), (got.reduced(), want.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [f.name for f in dataclasses.fields(a.moe)] == [
            f.name for f in dataclasses.fields(b.moe)]
        assert [a.is_moe_layer(i) for i in range(a.num_layers)] == [
            b.is_moe_layer(i) for i in range(b.num_layers)]
    assert got.source == want.source and got.family == "moe"


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


def _flat(tree) -> dict:
    """{checkpoint key: leaf} of a params tree."""
    out = {}
    map_with_path(lambda k, t: out.__setitem__(k, t), tree)
    return out


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_layout_equals_reference(arch):
    """The port's own draw has the reference's leaves, shapes and types
    (the router float32 in a bfloat16 model too)."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(config.get_config(arch).reduced(), dtype=dtype)
        j_cfg = dataclasses.replace(j_config.get_config(arch).reduced(), dtype=dtype)
        want = jax.eval_shape(lambda: JM.init_params(j_cfg, jax.random.PRNGKey(0)))
        got = M.init_params(cfg, 3, device="cpu")
        flat_w = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
        flat_g = _flat(got)
        assert {k.replace("/", "") for k in flat_g} == set(flat_w)
        for k, t in flat_g.items():
            w = flat_w[k.replace("/", "")]
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), k
            assert bool(torch.isfinite(t.float()).all()), k
        moe_l = got["segments"][0][0]["moe"]
        assert moe_l["w_router"].dtype == torch.float32
        assert float(moe_l["w_up"].float().std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch)
    prompt, T = _tokens(cfg, (2, 21), 1), 5
    jc = JM.init_cache(j_cfg, 2, 64)
    jl, jc = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(prompt)}, jc)
    tc = M.init_cache(cfg, 2, 64, device="cpu")
    tl, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    _close(tl, jl, 1e-4)
    toks = _tokens(cfg, (2, T), 2)
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = False                                          # a branch
    j_out, j_st = JM.decode_step(j_cfg, j_params, jc, jnp.asarray(toks), tree_mask=jnp.asarray(tm))
    out, st = M.decode_step(cfg, params, tc, torch.from_numpy(toks), tree_mask=torch.from_numpy(tm))
    _close(out, j_out, 1e-4)
    _close(st[0][-1]["v"], j_st[0][-1]["v"], 1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
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
    _close(last[:, 0], joint[:, 2], 1e-4)


def test_training_an_moe_stack_raises(capsys):
    """qwen2-moe's ``forward_train`` gives the reference's logits (1e-4) and
    moe_aux (1e-6), and the train CLI takes a step. (The name is from when
    MoE training raised.)"""
    cfg, j_cfg, j_params, params = _model("qwen2-moe-a2.7b")
    toks = _tokens(cfg, (1, 12), 4)
    jl, jaux = JM.forward_train(j_cfg, j_params, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, aux = M.forward_train(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, 1e-4)
    _close(aux, jaux, 1e-6)
    train.main(["--device", "cpu", "--reduced", "--arch", "qwen2-moe-a2.7b", "--steps", "1",
                "--batch", "1", "--seq", "8"])
    assert "1 steps in" in capsys.readouterr().out


# ------------------------------------------------------------------- bridge
def test_bfloat16_bridge_and_checkpoint_keep_the_router_float32(tmp_path):
    cfg, _, j_params, params = _model("qwen2-moe-a2.7b")
    np_params = jax.tree.map(np.asarray, j_params)
    bf = bridge.params_from_jax(np_params, device="cpu", dtype=torch.bfloat16)
    layer = bf["segments"][0][0]
    assert layer["moe"]["w_router"].dtype == torch.float32
    assert torch.equal(layer["moe"]["w_router"], params["segments"][0][0]["moe"]["w_router"])
    assert layer["moe"]["w_up"].dtype == layer["moe"]["shared"]["w_up"].dtype == torch.bfloat16
    assert layer["attn"]["wq"].dtype == bf["embed"].dtype == torch.bfloat16
    JT.save_checkpoint(str(tmp_path), j_params, step=1)
    flat = _flat(bridge.params_from_checkpoint(str(tmp_path), cfg, device="cpu",
                                               dtype=torch.bfloat16))
    for key, t in flat.items():
        assert t.dtype == (torch.float32 if key.endswith("['w_router']") else torch.bfloat16), key
    got, want = (_flat(bridge.params_from_checkpoint(str(tmp_path), cfg, device="cpu")),
                 _flat(params))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ int8 level
def test_int8_level_quantizes_no_expert():
    """The ActivationQuant level of an MoE stack quantizes nothing (the
    reference quantizes the dense MLP only; ``src/repro/models/model.py``
    ``_mlp_layer``): the bank holds no int8 copy, as the reference's
    reports none, and its decode equals the unquantized decode."""
    cfg, j_cfg, j_params, params = _model("qwen2-moe-a2.7b", layers=4)
    hier = dsia.build_hierarchy(cfg, "mixing")
    bank = DraftBank(cfg, params, hier, int8_exec="kernel")
    j_bank = JDraftBank(j_cfg, j_params, j_build_hierarchy(j_cfg, "mixing"), int8_exec="kernel")
    assert bank.param_bytes == j_bank.param_bytes == 0
    lvl = next(lv for lv in bank.levels if lv.quantize == "int8")
    j_lvl = next(lv for lv in j_bank.levels if lv.quantize == "int8")
    for p, q in zip(M.tree_leaves(lvl.params), M.tree_leaves(params)):
        assert p is q                                          # no weight replaced
    toks = _tokens(cfg, (1, 12), 4)
    tc = M.init_cache(cfg, 1, 32, device="cpu")
    M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)}, tc)
    nxt = torch.from_numpy(_tokens(cfg, (1, 3), 5))
    kw = dict(layer_ids=lvl.layer_ids)
    q_out, _ = M.decode_step(cfg, lvl.params, tc, nxt, quantize="int8", **kw)
    f_out, _ = M.decode_step(cfg, params, tc, nxt, **kw)
    assert torch.equal(q_out, f_out)
    jc = JM.init_cache(j_cfg, 1, 32)
    _, jc = JM.prefill(j_cfg, j_params, {"tokens": jnp.asarray(toks)}, jc)
    j_out, _ = JM.decode_step(j_cfg, j_lvl.params, jc, jnp.asarray(nxt.numpy()),
                              gates=jnp.asarray(j_lvl.gates), quantize="int8")
    _close(q_out, j_out, 1e-4)


# ------------------------------------------------------------ token identity
N_TOK = 12


def _stream(engine, make_sched, prompt):
    """N_TOK greedy tokens, the engine's cost tracker pinned to the draft
    priors (as ``tests/test_torch_engine.py`` does)."""
    engine.costs.observe = lambda *a, **k: None
    engine.costs.observe_target = lambda *a, **k: None
    engine.start(prompt)
    return make_sched(engine).generate(N_TOK)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dytc_streams_equal_ar_and_reference(arch):
    cfg, j_cfg, j_params, params = _model(arch, layers=4)
    prompt = np.tile(_tokens(cfg, (5,), 3), 3)
    ar = _stream(SpecEngine(cfg, params, max_len=64, device="cpu"), ARScheduler, prompt)
    engine = SpecEngine(cfg, params, max_len=64, device="cpu")
    dytc = _stream(engine, lambda e: DyTCScheduler(e, build_hierarchy(cfg)), prompt)
    j_dytc = _stream(JEngine(j_cfg, j_params, max_len=64),
                     lambda e: JDyTC(e, j_build_hierarchy(j_cfg)), prompt)
    assert dytc == ar == j_dytc
    assert engine.draft_exec == "slice"                        # a homogeneous MoE stack
    assert engine.stats["rounds"] < N_TOK                      # DyTC accepted drafts


# ------------------------------------------------------------------ serving
SPEC_KW = dict(name="ls_draft", gates=(1, 1, 0, 1), prior_alpha=0.6, prior_c=0.2)
SERVE_KW = dict(max_batch=2, max_len=128, draft_k=4, tree_expansions=3, adaptive=True,
                min_obs=1, round_mode="single")
SERVED = {
    "tree_fused dense": dict(mode="tree_fused"),
    "chain_fused paged, chunked prefill": dict(mode="chain_fused", paged=True, page_size=16,
                                               prefill_chunk=8),
}


@pytest.fixture(scope="module")
def qwen_ar():
    cfg, _, _, params = _model("qwen2-moe-a2.7b", layers=4)
    prompts = [np.tile(_tokens(cfg, (5,), 4), 3), _tokens(cfg, (19,), 5)]
    streams = []
    for p in prompts:
        eng = SpecEngine(cfg, params, max_len=128, device="cpu")
        eng.start(p)
        streams.append(eng.generate_ar(24))
    return prompts, streams


@pytest.mark.parametrize("name", sorted(SERVED))
def test_single_rounds_match_reference_server(qwen_ar, name):
    """The port's single-round server gives the reference server's tokens
    round by round on qwen2-moe's stack (slice exec), one dispatch a round,
    and every stream is a prefix of AR's."""
    cfg, j_cfg, j_params, params = _model("qwen2-moe-a2.7b", layers=4)
    prompts, ar = qwen_ar
    kw = dict(SERVE_KW, **SERVED[name])
    j_srv = JServer(j_cfg, j_params, draft_spec=JDraftSpec(**SPEC_KW), draft_kv="recompute",
                    telemetry=False, **kw)
    srv = BatchedSpecServer(cfg, params, draft_spec=DraftSpec(**SPEC_KW), device="cpu", **kw)
    assert srv._layer_ids == [0, 1, 3] and srv.round_mode == "single"
    for i, p in enumerate(prompts):
        j_srv.add_request(i, p)
        srv.add_request(i, p)
    gen = {i: [] for i in range(len(prompts))}
    for r in range(6):
        out = srv.step()
        assert out == j_srv.step(), f"round {r}"
        for b, t in out.items():
            gen[b].extend(t)
    assert srv.flush() == j_srv.flush() == {}
    assert srv.stats["round_dispatches"] == srv.stats["steps"] == 6
    assert srv.stats["draft_rounds"] > 0
    for b in gen:
        assert len(gen[b]) > 2 and gen[b] == ar[b][:len(gen[b])], f"slot {b} left AR"


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_takes_the_moe_configs(arch, capsys):
    for argv in (["--scheduler", "ar"], ["--scheduler", "dytc"],
                 ["--mesh", "model=1,data=1", "--mode", "tree_fused", "--batch", "2"]):
        serve.main(["--device", "cpu", "--reduced", "--arch", arch, "--tokens", "3"] + argv)
        assert '"delivered_tokens": ' in capsys.readouterr().out.splitlines()[-1]
