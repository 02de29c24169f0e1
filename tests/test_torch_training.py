"""The port's training path against the JAX reference's, on the CPU:
``forward_train``, the loss and its gradient, AdamW and the cosine
schedule, three train steps, checkpoints across the two packages, the
``repro_torch.launch.train`` CLI, and ``decode_commit_token``.

Both packages start from the reference's params (``bridge.params_from_jax``)
and take the same numpy inputs. Tolerances (float32 on both sides):
the learning rate atol 1e-7; AdamW atol 1e-6 over three updates; logits
atol 1e-4; the loss atol 1e-5; every gradient leaf atol 1e-5; three train
steps: ce and grad_norm atol 1e-5, lr atol 1e-9 and every param atol 1e-5;
``remat=True`` bitwise equal to ``remat=False``; checkpoints bitwise with
the same key strings and step; ``decode_commit_token`` logits atol 1e-4,
the new cache row atol 1e-5 of the reference's and bitwise the row
``decode_step`` staged, every other row and ``pos`` bitwise.
"""
import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as j_train  # noqa: E402
from repro import training as JT  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.config.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import training as T  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.config.base import MoEConfig  # noqa: E402
from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy  # noqa: E402
from repro_torch.data import lm_batches, synthetic_corpus  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))


def _params():
    """A fresh port copy of the reference's params (training writes in place)."""
    return bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")


def _batch(B=2, S=24, seed=3, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, CFG.vocab_size, size=(B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S - 1)) < 0.6).astype(np.int32)
    return b


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=0)


def _pairs(port_tree, ref_tree):
    """(key, port leaf, reference leaf) over the reference's key strings."""
    ref, _ = _flatten_with_paths(ref_tree)
    got = {}
    T.checkpoint.map_with_path(lambda k, a: got.__setitem__(k, a), port_tree)
    assert set(got) == set(ref)
    return [(k, got[k], ref[k]) for k in sorted(ref)]


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 60), (3e-4, 100, 10_000), (6e-4, 10, 3)])
def test_cosine_lr_matches_reference(peak, warmup, total):
    steps = np.arange(121, dtype=np.int32)
    want = JT.cosine_lr(jnp.asarray(steps), peak=peak, warmup=warmup, total=total)
    got = T.cosine_lr(torch.from_numpy(steps), peak=peak, warmup=warmup, total=total)
    assert got.dtype == torch.float32
    _close(got, want, 1e-7)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"final_norm": (6,), "norm1": (3, 6), "w": (3, 6, 4), "seg": [{"w2": (6, 5)}],
              "frozen_final": (6,), "frozen_norm": (3, 6)}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_reference(clip):
    """Three updates of a tree with 1-D, stacked 2-D and 3-D leaves, the
    global-norm clip active (gradients of norm ~60) or not (~0.3). The
    ``frozen_*`` leaves get zero gradients: the stacked (L, d) norm still
    decays, the (d,) one does not move."""
    p0 = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)   # updated in place
    jo, to = JT.adamw_init(jp), T.adamw_init(tp)
    j_update = jax.jit(JT.adamw_update)
    for i in range(3):
        g = jax.tree.map(lambda a: a * (10.0 if clip else 0.05), _opt_tree(10 + i))
        g["frozen_final"] = np.zeros_like(g["frozen_final"])
        g["frozen_norm"] = np.zeros_like(g["frozen_norm"])
        gnorm = np.sqrt(sum(float(np.square(a).sum()) for a in jax.tree.leaves(g)))
        assert (gnorm > 1.0) == clip
        lr = 0.01 * (i + 1)
        jp, jo = j_update(jp, jax.tree.map(jnp.asarray, g), jo, lr=jnp.asarray(lr, jnp.float32))
        tp, to = T.adamw_update(tp, jax.tree.map(torch.from_numpy, g), to, lr=lr)
        for tree_t, tree_j in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
            for _, a, b in _pairs(tree_t, tree_j):
                _close(a, b, 1e-6)
        assert int(to.step) == int(jo.step) == i + 1
    np.testing.assert_array_equal(tp["frozen_final"].numpy(), p0["frozen_final"])
    decay = np.prod([1 - 0.01 * (i + 1) * 0.1 for i in range(3)])
    np.testing.assert_allclose(tp["frozen_norm"].numpy(), p0["frozen_norm"] * decay, rtol=1e-6)


@pytest.mark.parametrize("gates", [False, True])
def test_forward_train_logits_match_reference(gates):
    b = _batch()
    g = np.array([1, 0, 1, 1], np.float32) if gates else None
    want, aux = JM.forward_train(J_CFG, J_PARAMS, jax.tree.map(jnp.asarray, b),
                                 gates=None if g is None else jnp.asarray(g), remat=False)
    got, t_aux = M.forward_train(CFG, _params(), b, gates=g, remat=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 1e-4)
    assert float(t_aux) == float(aux) == 0.0


@pytest.mark.parametrize("mask", [False, True])
def test_loss_fn_matches_reference(mask):
    b = _batch(mask=mask)
    want, jm = JT.loss_fn(J_CFG, J_PARAMS, jax.tree.map(jnp.asarray, b), remat=False)
    got, tm = T.loss_fn(CFG, _params(), b, remat=False)
    _close(got, want, 1e-5)
    for k in ("ce", "moe_aux", "loss"):
        _close(tm[k], jm[k], 1e-5)


def _port_grads(params, batch, remat):
    leaves = [p.requires_grad_() for p in M.tree_leaves(params)]
    loss, _ = T.loss_fn(CFG, params, batch, remat=remat)
    return loss, M.tree_unflatten(params, torch.autograd.grad(loss, leaves))


def test_gradients_match_jax_grad():
    """Every leaf of the gradient (embed, stacked layer weights, norms,
    lm_head), with the loss mask, atol 1e-5."""
    b = _batch(mask=True)
    want = jax.jit(jax.grad(
        lambda p: JT.loss_fn(J_CFG, p, jax.tree.map(jnp.asarray, b), remat=False)[0]))(J_PARAMS)
    _, got = _port_grads(_params(), b, remat=False)
    for _, a, w in _pairs(got, want):
        _close(a, w, 1e-5)


def test_remat_is_bitwise_on_cpu():
    b = _batch(mask=True)
    l0, g0 = _port_grads(_params(), b, remat=False)
    l1, g1 = _port_grads(_params(), b, remat=True)
    assert torch.equal(l0, l1)
    for a, c in zip(M.tree_leaves(g0), M.tree_leaves(g1)):
        assert torch.equal(a, c)


def test_three_train_steps_match_reference():
    """Three steps of ``make_train_step`` (peak 1e-3, warm-up 2) from the
    same init on the same ``lm_batches``: ce, lr, grad_norm and every param."""
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10, remat=False)
    j_step = jax.jit(JT.make_train_step(J_CFG, **kw))
    t_step = T.make_train_step(CFG, **kw)
    jp, tp = J_PARAMS, _params()
    jo, to = JT.adamw_init(jp), T.adamw_init(tp)
    it = lm_batches(synthetic_corpus(CFG.vocab_size, 5_000), 4, 32)
    for _ in range(3):
        b = next(it)
        jp, jo, jm = j_step(jp, jo, jax.tree.map(jnp.asarray, b))
        tp, to, tm = t_step(tp, to, b)
        for k in ("ce", "grad_norm"):
            _close(tm[k], jm[k], 1e-5)
        _close(tm["lr"], jm["lr"], 1e-9)
        for _, a, w in _pairs(tp, jp):
            _close(a, w, 1e-5)
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages_bitwise(writer, tmp_path):
    """One package writes params and an AdamW state, the other reads them
    back bitwise, under the same key strings and step."""
    rng = np.random.default_rng(9)
    jp = J_PARAMS
    jo = JT.AdamWState(step=jnp.asarray(5, jnp.int32),
                       mu=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jp),
                       nu=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), a.dtype), jp))
    path = str(tmp_path / "ckpt")
    if writer == "reference":
        JT.save_checkpoint(path, jp, jo, step=5)
        tp, to, step = T.load_checkpoint(path, M.init_params(CFG, device="meta"),
                                         T.adamw_init(_params()), device="cpu")
        for tree_t, tree_j in ((tp, jp), (to, jo)):
            for _, a, w in _pairs(tree_t, tree_j):
                np.testing.assert_array_equal(a.numpy(), w)
                assert a.numpy().dtype == np.asarray(w).dtype
        for _, a, w in _pairs(bridge.params_from_checkpoint(path, CFG, device="cpu"), jp):
            np.testing.assert_array_equal(a.numpy(), w)
    else:
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        to = T.AdamWState(step=torch.tensor(int(jo.step), dtype=torch.int32),
                          mu=bridge.params_from_jax(jax.tree.map(np.asarray, jo.mu), device="cpu"),
                          nu=bridge.params_from_jax(jax.tree.map(np.asarray, jo.nu), device="cpu"))
        T.save_checkpoint(path, tp, to, step=5)
        with np.load(os.path.join(path, "params.npz")) as f:
            assert set(f.files) == set(_flatten_with_paths(jp)[0])
        with np.load(os.path.join(path, "opt.npz")) as f:
            assert set(f.files) == set(_flatten_with_paths(jo)[0])
        rp, ro, step = JT.load_checkpoint(path, J_PARAMS, JT.adamw_init(J_PARAMS))
        for a, w in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves((jp, jo))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
            assert np.asarray(a).dtype == np.asarray(w).dtype
    assert step == 5


def test_bfloat16_checkpoint_matches_reference_bytes(tmp_path):
    """bfloat16 params: the reference stores their raw two bytes (``<V2``);
    the port reads the reference's file back bit for bit and writes the
    same bytes under the same keys."""
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), J_PARAMS)
    JT.save_checkpoint(str(tmp_path / "ref"), jp, step=1)
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    tp = bridge.params_from_checkpoint(str(tmp_path / "ref"), cfg, device="cpu")
    for _, a, w in _pairs(tp, jp):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(), np.asarray(w).view(np.int16))
    T.save_checkpoint(str(tmp_path / "port"), tp, step=1)
    with np.load(tmp_path / "ref" / "params.npz") as want, \
            np.load(tmp_path / "port" / "params.npz") as got:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.dtype("V2")
            assert got[k].tobytes() == want[k].tobytes()


def test_port_training_learns():
    """The reference's ``test_training_learns`` on the port: 30 steps, ce
    falls by more than 0.3."""
    params = M.init_params(CFG, 0, device="cpu")
    opt = T.adamw_init(params)
    step = T.make_train_step(CFG, peak_lr=1e-3, warmup=10, total_steps=200, remat=False)
    it = lm_batches(synthetic_corpus(CFG.vocab_size, 20_000), 8, 64)
    ce = []
    for _ in range(30):
        params, opt, m = step(params, opt, next(it))
        ce.append(float(m["ce"]))
    assert np.isfinite(ce).all() and ce[-1] < ce[0] - 0.3


def _numbers_out(text):
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line) for line in text.strip().splitlines()]


def test_cli_trains_and_its_checkpoint_serves_equal_to_ar(monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced --steps 3
    --ckpt <dir>`` runs, prints the reference CLI's lines, and its
    checkpoint serves a DyTC stream equal to AR."""
    ckpt = str(tmp_path / "port")
    train.main(["--device", "cpu", "--reduced", "--steps", "3", "--ckpt", ckpt])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--steps", "3", "--ckpt",
                                      str(tmp_path / "ref")])
    j_train.main()
    want = capsys.readouterr().out
    assert _numbers_out(out.replace(ckpt, "<ckpt>")) == _numbers_out(
        want.replace(str(tmp_path / "ref"), "<ckpt>"))
    cfg = get_config("vicuna-7b").reduced()
    params = bridge.params_from_checkpoint(ckpt, cfg, device="cpu")
    _, _, step = T.load_checkpoint(ckpt, params, T.adamw_init(params), device="cpu")
    assert step == 3
    prompt = np.tile(np.arange(5, 17, dtype=np.int32), 3)
    streams = []
    for dytc in (False, True):
        eng = SpecEngine(cfg, params, max_len=128, device="cpu")
        eng.start(prompt)
        sched = DyTCScheduler(eng, build_hierarchy(cfg)) if dytc else ARScheduler(eng)
        streams.append(sched.generate(12))
    assert streams[0] == streams[1] and len(streams[0]) == 12


MOE_CFG = dataclasses.replace(CFG, family="moe", moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
J_MOE_CFG = dataclasses.replace(J_CFG, family="moe", moe=JMoEConfig(num_experts=4, top_k=2,
                                                                   d_ff_expert=64))
J_MOE_PARAMS = JM.init_params(J_MOE_CFG, jax.random.PRNGKey(0))


def _moe_params():
    return bridge.params_from_jax(jax.tree.map(np.asarray, J_MOE_PARAMS), device="cpu")


def _moe_forward_train():
    b = _batch()
    want, j_aux = JM.forward_train(J_MOE_CFG, J_MOE_PARAMS, jax.tree.map(jnp.asarray, b),
                                   remat=False)
    got, aux = M.forward_train(MOE_CFG, _moe_params(), b, remat=False)
    _close(got, want, 1e-4)
    _close(aux, j_aux, 1e-6)
    assert float(aux) > 0


def _moe_train_step():
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10, remat=False)
    b = _batch()
    jp, jo, jm = jax.jit(JT.make_train_step(J_MOE_CFG, **kw))(
        J_MOE_PARAMS, JT.adamw_init(J_MOE_PARAMS), jax.tree.map(jnp.asarray, b))
    tp = _moe_params()
    tp, _, tm = T.make_train_step(MOE_CFG, **kw)(tp, T.adamw_init(tp), b)
    for k in ("ce", "moe_aux"):
        _close(tm[k], jm[k], 1e-5)
    # a norm near 10: float32 rounding of its sum of squares is ~1e-6 relative
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for _, a, w in _pairs(tp, jp):
        _close(a, w, 1e-5)


def _moe_port_params():
    params = M.init_params(MOE_CFG, device="cpu")
    logits, aux = M.forward_train(MOE_CFG, params, _batch())
    assert logits.shape == (2, 24, MOE_CFG.padded_vocab) and bool(torch.isfinite(logits).all())
    assert float(aux) > 0


def _moe_loss_fn():
    b = _batch(mask=True)
    want, jm = JT.loss_fn(J_MOE_CFG, J_MOE_PARAMS, jax.tree.map(jnp.asarray, b), remat=False)
    got, tm = T.loss_fn(MOE_CFG, _moe_params(), b)
    _close(got, want, 1e-5)
    for k in ("ce", "moe_aux", "loss"):
        _close(tm[k], jm[k], 1e-5)


MOE_CASES = {
    "forward_train": _moe_forward_train,
    "train_step": _moe_train_step,
    "forward_train, MoE params": _moe_port_params,
    "loss_fn": _moe_loss_fn,
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_config_raises(case):
    """An MoE stack (4 experts, top-2) trains as the reference's does: the
    grouped-capacity dispatch, the aux losses summed into the loss, one
    train step (logits 1e-4; losses and params atol 1e-5, grad_norm rtol
    1e-5); port-drawn
    params give finite logits and a positive aux. (The name is from when
    MoE training raised.)"""
    MOE_CASES[case]()


def test_training_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.load_checkpoint("unused", {}, device="cuda")


@pytest.mark.parametrize("gates", [False, True])
def test_decode_commit_token_matches_reference(gates):
    """Two sequences at different lengths take one token each: logits
    against the reference's, and the committed cache: ``pos`` and every row
    but the new one bitwise, the new row within 1e-5 of the reference's and
    bitwise what ``decode_step`` staged."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    jc = JM.init_cache(J_CFG, 2, 32)
    _, jc = JM.prefill(J_CFG, J_PARAMS, {"tokens": jnp.asarray(prompt)}, jc)
    jc = dict(jc, pos=jnp.asarray([12, 9], jnp.int32))      # second sequence shorter
    tok = np.array([7, 300], np.int32)
    g = np.array([1, 1, 0, 1], np.float32) if gates else None
    want, jc2 = JM.decode_commit_token(J_CFG, J_PARAMS, jc, jnp.asarray(tok),
                                       gates=None if g is None else jnp.asarray(g))
    params = _params()
    tc = bridge.cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    _, staged = M.decode_step(CFG, params, tc, torch.from_numpy(tok[:, None]), gates=g)
    got, tc2 = M.decode_commit_token(CFG, params, tc, torch.from_numpy(tok), gates=g)
    assert tc2 is tc and got.shape == want.shape
    _close(got, want, 1e-4)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    for n in ("k", "v"):
        a, w = tc2["segments"][0][0][n].numpy(), np.asarray(jc2["segments"][0][0][n])
        new = [(b, p) for b, p in enumerate((12, 9))]
        keep = np.ones(a.shape[1:3], bool)
        for b, p in new:
            keep[b, p] = False
            np.testing.assert_allclose(a[:, b, p], w[:, b, p], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(a[:, b, p], staged[0][0][n][:, b, 0].numpy())
        np.testing.assert_array_equal(a[:, keep], w[:, keep])
