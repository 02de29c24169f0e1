"""Training the port's MoE and Mamba-2 stacks against the JAX reference, on
the CPU in float32.

``models/ssm.py::mamba_forward(mode="train")`` (the chunked scan over a
fresh zero state, over two chunks) gives the reference's output within
1e-5, and its gradients (every param and the input) the reference's
within 1e-5 of each leaf's largest magnitude, with none NaN.
``models/moe.py``'s grouped-capacity dispatch:
with ``capacity_factor`` 8 nothing drops and it equals the dropless output
within 1e-5; at 0.01 (one row an expert a group) it drops the reference's
(token, k) pairs and gives its output; with ``exec_groups`` 2 and 3 (3
halves to 1 on 14 tokens) and in ``mode="infer_grouped"`` it equals the
reference's; the load-balance and router-z losses within 1e-6. For
mamba2-130m, jamba-v0.1-52b and qwen2-moe-a2.7b at ``reduced()`` width
(jamba at 4 layers, which keeps its attention layer and two MoE layers):
``forward_train`` logits and ``moe_aux`` within 1e-5, every gradient leaf
within 1e-5 of ``jax.grad``, and three ``train_step``s (ce and moe_aux
atol 1e-5, grad_norm rtol 1e-5, every param atol 1e-5 but for at most one
element in 10^4 of a leaf, within the learning rate: AdamW's update of a
gradient that is rounding noise) against the reference's; a
checkpoint of params and AdamW state crosses the two packages bitwise; the
train CLI takes ``--reduced`` steps on each.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as j_config  # noqa: E402
from repro import training as JT  # noqa: E402
from repro.config.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402
import repro_torch.config as config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import training as T  # noqa: E402
from repro_torch.config.base import MoEConfig  # noqa: E402
from repro_torch.data import lm_batches, synthetic_corpus  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.training.checkpoint import map_with_path  # noqa: E402

ARCHS = ("mamba2-130m", "jamba-v0.1-52b", "qwen2-moe-a2.7b")
D = 16


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda k, t: out.__setitem__(k, t), tree)
    return out


def _pairs(port_tree, ref_tree):
    """(key, port leaf, reference leaf) over the reference's key strings."""
    ref = _flatten_with_paths(ref_tree)[0]
    got = _flat(port_tree)
    assert got.keys() == ref.keys()
    return [(k, got[k], ref[k]) for k in sorted(ref)]


# ------------------------------------------------------------ mamba_forward
@functools.lru_cache(maxsize=None)
def _mamba_params():
    cfg = config.get_config("mamba2-130m").reduced()
    j_cfg = j_config.get_config("mamba2-130m").reduced()
    j_p = JS.ssm_init(jax.random.PRNGKey(3), j_cfg.d_model, j_cfg.ssm, jnp.float32)
    return cfg, j_cfg, j_p


def test_mamba_forward_train_matches_reference_with_finite_gradients():
    """B=2, S=45 over chunks of 32 (two chunks, the second padded): the
    output within 1e-5, and the gradient of a weighted sum of it against
    every param and the input, each leaf within 1e-5 of its largest
    magnitude (the params' gradients reach ~12: a sum over 23040 outputs)."""
    cfg, j_cfg, j_p = _mamba_params()
    s, d = cfg.ssm, cfg.d_model
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 45, d)).astype(np.float32)
    wts = rng.standard_normal((2, 45, d)).astype(np.float32)
    zero = jax.tree.map(lambda a: a[0], JM.init_cache(j_cfg, 2, 8)["segments"][0][0])

    def j_loss(p, x):
        out, _, _ = JS.mamba_forward(p, x, d, j_cfg.ssm, zero, mode="train")
        return jnp.sum(out * wts), out

    (_, j_out), (j_gp, j_gh) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        j_p, jnp.asarray(h))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, j_p), device="cpu")
    leaves = [p.requires_grad_() for p in M.tree_leaves(params)]
    x = torch.from_numpy(h).requires_grad_()
    out, staged = ssm.mamba_forward(M.tree_unflatten(params, leaves), x, d, s, None, mode="train")
    assert staged == {}
    _close(out.detach(), j_out, 1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), leaves + [x])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    pairs = [("h", grads[-1], j_gh)] + _pairs(M.tree_unflatten(params, list(grads[:-1])), j_gp)
    for _, a, w in pairs:
        _close(a, w, 1e-5 * max(1.0, float(np.abs(np.asarray(w)).max())))
    # the train path is the prefill path from a zero state
    pre, _ = ssm.mamba_forward(params, x.detach(), d, s, ssm.init_state(d, s, 2, torch.float32,
                                                                       "cpu"), mode="prefill")
    assert torch.equal(pre, out.detach())


# ----------------------------------------------------------- grouped capacity
GATED = dict(num_shared_experts=2, d_ff_shared=32)


def _moe(**kw):
    """(port MoEConfig, reference MoEConfig, the reference's params, the
    same in the port): 4 experts top-2, gated, a shared block."""
    j_moe = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=32, **dict(GATED, **kw))
    j_params = JMoE.moe_init(jax.random.PRNGKey(0), D, j_moe, True, jnp.float32)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, j_params), device="cpu")
    return MoEConfig(**dataclasses.asdict(j_moe)), j_moe, j_params, params


def _x(seed, n=14):
    return np.random.default_rng(seed).standard_normal((2, n // 2, D)).astype(np.float32)


def _both(mode, seed=1, **kw):
    cfg_moe, j_moe, j_params, params = _moe(**kw)
    x = _x(seed)
    jy, jaux = JMoE.moe_apply(j_params, jnp.asarray(x), j_moe, "silu", True, mode=mode)
    y, aux = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, "silu", True, mode=mode)
    return (y, aux), (jy, jaux), (cfg_moe, params, x)


def test_capacity_8_drops_nothing_and_equals_dropless():
    (y, _), (jy, _), (cfg_moe, params, x) = _both("train", capacity_factor=8.0)
    _close(y, jy, 1e-5)
    dropless, _ = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, "silu", True, mode="infer")
    _close(y, dropless, 1e-5)
    top_ids = moe._router(params, torch.from_numpy(x).reshape(-1, D), cfg_moe, False)[1]
    slot, keep, C = moe.capacity_slots(top_ids, cfg_moe, 8.0)
    assert bool(keep.all()) and C == 56 and slot.shape == (1, 28)


def test_capacity_001_drops_the_references_pairs():
    """C = max(1, int(0.01 * 14 * 2 / 4 + 0.999)) = 1: each expert keeps its
    first (token, k) pair in token-major, k-minor order; the output equals
    the reference's, so the same pairs dropped."""
    (y, aux), (jy, jaux), (cfg_moe, params, x) = _both("train", capacity_factor=0.01)
    _close(y, jy, 1e-5)
    top_ids = moe._router(params, torch.from_numpy(x).reshape(-1, D), cfg_moe, False)[1]
    slot, keep, C = moe.capacity_slots(top_ids, cfg_moe, 0.01)
    assert C == 1
    flat = top_ids.reshape(-1).tolist()
    first = {e: flat.index(e) for e in set(flat)}
    assert keep.reshape(-1).tolist() == [first[e] == i for i, e in enumerate(flat)]
    assert int(keep.sum()) == len(first) < len(flat)
    assert slot.reshape(-1)[~keep.reshape(-1)].eq(4 * C).all()
    dropless, _ = moe.moe_apply(params, torch.from_numpy(x), cfg_moe, "silu", True, mode="infer")
    assert float((y - dropless).abs().max()) > 1e-3
    for k in jaux:
        _close(aux[k], jaux[k], 1e-6)


@pytest.mark.parametrize("groups", [2, 3])
def test_exec_groups_match_reference(groups):
    """Two groups of 7 tokens each compete for their own capacity; 3 does
    not divide 14 and halves to 1 group."""
    (y, _), (jy, _), (cfg_moe, _, _) = _both("train", capacity_factor=1.0, exec_groups=groups)
    _close(y, jy, 1e-5)
    ids = torch.zeros((14, 2), dtype=torch.long)
    assert moe.capacity_slots(ids, cfg_moe, 1.0)[0].shape[0] == (2 if groups == 2 else 1)


def test_infer_grouped_matches_reference():
    (y, aux), (jy, jaux), _ = _both("infer_grouped", seed=4)
    _close(y, jy, 1e-5)
    (y2, _), (jy2, _), _ = _both("infer_grouped", seed=4, infer_capacity_factor=0.5)
    _close(y2, jy2, 1e-5)
    assert float((y2 - y).abs().max()) > 1e-4                # the factor reached the dispatch


@pytest.mark.parametrize("mode", ["train", "infer", "infer_grouped"])
def test_aux_losses_match_reference(mode):
    (_, aux), (_, jaux), _ = _both(mode, seed=5, load_balance_loss=0.5, router_z_loss=0.25)
    assert aux.keys() == jaux.keys() == {"load_balance", "router_z"}
    for k in jaux:
        _close(aux[k], jaux[k], 1e-6)
        assert float(aux[k]) > 0


# ------------------------------------------------------------------ the stacks
@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """The reduced config (jamba at 4 layers: MMMA... two MoE layers), the
    reference's seed-0 params."""
    kw = {"num_layers": 4} if arch == "jamba-v0.1-52b" else {}
    cfg = dataclasses.replace(config.get_config(arch).reduced(), **kw)
    j_cfg = dataclasses.replace(j_config.get_config(arch).reduced(), **kw)
    return cfg, j_cfg, JM.init_params(j_cfg, jax.random.PRNGKey(0))


def _params(arch):
    return bridge.params_from_jax(jax.tree.map(np.asarray, _model(arch)[2]), device="cpu")


def _batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S - 1)) < 0.7).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_gradients_match_reference(arch):
    cfg, j_cfg, j_params = _model(arch)
    b = _batch(cfg, 1)
    jb = jax.tree.map(jnp.asarray, b)
    want, j_aux = JM.forward_train(j_cfg, j_params, jb, remat=False)
    got, aux = M.forward_train(cfg, _params(arch), b, remat=False)
    _close(got, want, 1e-5)
    _close(aux, j_aux, 1e-5)
    assert (float(aux) > 0) == (cfg.moe is not None)
    j_grads = jax.jit(jax.grad(lambda p: JT.loss_fn(j_cfg, p, jb, remat=False)[0]))(j_params)
    params = _params(arch)
    leaves = [p.requires_grad_() for p in M.tree_leaves(params)]
    loss, _ = T.loss_fn(cfg, M.tree_unflatten(params, leaves), b)    # remat on
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for _, a, w in _pairs(M.tree_unflatten(params, list(grads)), j_grads):
        _close(a, w, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    cfg, j_cfg, jp = _model(arch)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10, remat=False)
    j_step = jax.jit(JT.make_train_step(j_cfg, **kw))
    t_step = T.make_train_step(cfg, **kw)
    tp = _params(arch)
    jo, to = JT.adamw_init(jp), T.adamw_init(tp)
    it = lm_batches(synthetic_corpus(cfg.vocab_size, 5_000), 2, 24)
    for _ in range(3):
        b = next(it)
        jp, jo, jm = j_step(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = t_step(tp, to, b)
        for k in ("ce", "moe_aux"):
            _close(tm[k], jm[k], 1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        for k, a, w in _pairs(tp, jp):
            d = np.abs(a.numpy() - np.asarray(w))
            # AdamW divides by sqrt(nu): where a gradient is rounding noise
            # (~1e-9, an unseen token's row), the two packages' noise gives
            # updates of up to the learning rate
            assert (d > 1e-5).sum() <= max(1, d.size // 10_000) and d.max() <= 3e-3, k
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_of_an_moe_ssm_model_crosses_bitwise(writer, tmp_path):
    """jamba (mamba, attention and MoE leaves, the float32 SSM constants and
    router): params and an AdamW state, written by one package, read by the
    other bitwise."""
    cfg, _, jp = _model("jamba-v0.1-52b")
    rng = np.random.default_rng(9)
    jo = JT.AdamWState(step=jnp.asarray(4, jnp.int32),
                       mu=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jp),
                       nu=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), a.dtype), jp))
    path = str(tmp_path / "ckpt")
    if writer == "reference":
        JT.save_checkpoint(path, jp, jo, step=4)
        params = bridge.params_from_checkpoint(path, cfg, device="cpu")
        tp, to, step = T.load_checkpoint(path, params, T.adamw_init(params), device="cpu")
        assert step == 4 and int(to.step) == 4
        for tree_t, tree_j in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
            for _, a, w in _pairs(tree_t, tree_j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    else:
        tp = _params("jamba-v0.1-52b")

        def draw(fn):
            return M.tree_map(lambda a: torch.from_numpy(fn(a.shape).astype(np.float32)), tp)

        to = T.AdamWState(step=torch.tensor(4, dtype=torch.int32),
                          mu=draw(lambda s: rng.normal(size=s)), nu=draw(rng.random))
        T.save_checkpoint(path, tp, to, step=4)
        back_p, back_o, step = JT.load_checkpoint(path, jp, JT.adamw_init(jp))
        assert step == 4
        for tree_t, tree_j in ((tp, back_p), (to.mu, back_o.mu), (to.nu, back_o.nu)):
            for _, a, w in _pairs(tree_t, tree_j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_reduced(arch, capsys, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced --arch A``
    prints the reference CLI's lines, every number finite, and its
    checkpoint reads back through ``params_from_checkpoint``."""
    ckpt = str(tmp_path / "ckpt")
    train.main(["--device", "cpu", "--reduced", "--arch", arch, "--steps", "2", "--batch", "2",
                "--seq", "16", "--ckpt", ckpt])
    lines = capsys.readouterr().out.strip().splitlines()
    pat = r"step +\d+ ce=(\d+\.\d+) lr=\d\.\d\de[-+]\d+ gnorm=(\d+\.\d+)"
    assert [bool(re.fullmatch(pat, ln)) for ln in lines[:2]] == [True, True]
    assert re.fullmatch(r"2 steps in \d+\.\ds", lines[2]) and lines[3] == f"saved {ckpt}"
    params = bridge.params_from_checkpoint(ckpt, config.get_config(arch).reduced(), device="cpu")
    assert all(bool(torch.isfinite(t).all()) for t in M.tree_leaves(params))
