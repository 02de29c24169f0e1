"""The port's single-stream baselines and EWIF terms against the JAX
reference's, on the CPU.

The seven static baselines of ``core/cascade.py`` (PLD, SD, VC, HC, VC+HC,
Tree, Tr+VC), at the reference's ``tests/test_lossless.py`` settings over
shared params, give the autoregressive stream (the paper's invariant) and
the reference scheduler's stream, rounds and target calls. The twelve EWIF
terms the baselines and the paper's analysis use equal the reference's on a
grid (relative 1e-12), and ``chain_tree`` / ``DraftTree.siblings`` build
the reference's trees.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import cascade as j_cascade  # noqa: E402
from repro.core import ewif as j_ewif  # noqa: E402
from repro.core import tree as j_tree  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import SpecEngine, cascade, ewif, layer_sparsity, tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
# tests/test_lossless.py's prompt, length and scheduler settings
PROMPT = np.array([5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6, 7], np.int32)
N_TOK = 24
BASELINES = {
    "PLD": lambda m, e, ls4: m.PLDScheduler(e, k=6),
    "SD": lambda m, e, ls4: m.SDScheduler(e, ls4, k=4),
    "VC": lambda m, e, ls4: m.VCScheduler(e, ls4, n=2, k2=5),
    "HC": lambda m, e, ls4: m.HCScheduler(e, ls4, k1=3, k2=4),
    "VC+HC": lambda m, e, ls4: m.VCHCScheduler(e, ls4),
    "Tree": lambda m, e, ls4: m.TreeScheduler(e, ls4, depth=3),
    "Tr+VC": lambda m, e, ls4: m.TreeVCScheduler(e, ls4, depth=3),
}


def _run(name, ref: bool):
    if ref:
        eng = JEngine(J_CFG, J_PARAMS, max_len=256)
        mod, ls4 = j_cascade, j_layer_sparsity(J_CFG, 0.4)
    else:
        eng = SpecEngine(CFG, PARAMS, max_len=256, device="cpu")
        mod, ls4 = cascade, layer_sparsity(CFG, 0.4)
    eng.start(PROMPT)
    sched = mod.ARScheduler(eng) if name == "AR" else BASELINES[name](mod, eng, ls4)
    return sched.generate(N_TOK), eng.stats


@pytest.fixture(scope="module")
def ar_stream():
    out, _ = _run("AR", ref=False)
    j_out, _ = _run("AR", ref=True)
    assert out == j_out
    return out


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_lossless_and_equal_reference(name, ar_stream):
    out, st = _run(name, ref=False)
    j_out, j_st = _run(name, ref=True)
    assert out == ar_stream
    assert out == j_out
    for k in ("rounds", "target_calls", "accepted_tokens", "draft_calls"):
        assert st[k] == j_st[k], k
    if name != "PLD":
        assert st["draft_calls"] > 0


def test_cli_offers_the_reference_schedulers():
    assert sorted(serve.SCHEDULERS) == sorted(j_serve.SCHEDULERS)
    assert serve.MODES == ("chain_fused", "legacy", "tree_fused", "cascade_fused")


# ---------------------------------------------------------------------- EWIF
ALPHAS = (0.0, 0.3, 0.55, 0.8, 0.95, 1.0)
CS = (0.02, 0.1, 0.35)


def _close(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    assert a == pytest.approx(b, rel=1e-12, abs=0.0) or a == b


@pytest.mark.parametrize("fn", ["expected_accepted", "phi_sd", "best_sd",
                                "greedy_step_objective", "simulate_ewif_sd"])
def test_single_draft_terms_equal_reference(fn):
    for a, c in itertools.product(ALPHAS, CS):
        for k in (1, 3, 6):
            if fn == "expected_accepted":
                args = (a, k)
            elif fn == "best_sd":
                args = (a, c, 4 * k)
            elif fn == "simulate_ewif_sd":
                args = (a, c, k, 500, k)
            else:
                args = (a, c, k)
            _close(getattr(ewif, fn)(*args), getattr(j_ewif, fn)(*args))


@pytest.mark.parametrize("fn", ["t_vc", "t_hc", "best_hc", "best_vc", "hc_bound_c_d1"])
def test_cascade_terms_equal_reference(fn):
    for a1, a2, c1, c2 in itertools.product((0.3, 0.7, 0.9), (0.2, 0.6, 0.85), CS, (0.01, 0.05)):
        if fn == "t_vc":
            args = [(a1, a2, c1, c2, n, k) for n in (1, 3) for k in (1, 4)]
        elif fn == "t_hc":
            args = [(a1, a2, c1, c2, k1, k2) for k1 in (1, 3) for k2 in (0, 4)]
        elif fn == "best_hc":
            args = [(a1, a2, c1, c2, 6)]
        elif fn == "best_vc":
            args = [(a1, a2, c1, c2, 3, 5)]
        else:
            args = [(a1, a2, c2, 3, 4, 2)]
        for arg in args:
            _close(getattr(ewif, fn)(*arg), getattr(j_ewif, fn)(*arg))


@pytest.mark.parametrize("fn", ["vc_bound_c_d1_numeric", "hc_bound_c_d1_numeric"])
def test_numeric_bounds_equal_reference(fn):
    for a_t1, a_12, a_t2, c2 in ((0.8, 0.7, 0.6, 0.05), (0.9, 0.5, 0.4, 0.02),
                                 (0.6, 0.9, 0.7, 0.1), (0.3, 0.3, 0.9, 0.01)):
        args = ((a_t1, a_12, a_t2, c2, 3, 5) if fn == "vc_bound_c_d1_numeric"
                else (a_t1, a_t2, c2, 6))
        _close(getattr(ewif, fn)(*args), getattr(j_ewif, fn)(*args))


def test_every_reference_ewif_function_is_ported():
    names = {n for n, v in vars(j_ewif).items()
             if callable(v) and getattr(v, "__module__", "") == j_ewif.__name__}
    assert len(names) == 19
    assert names <= set(vars(ewif))


# ---------------------------------------------------------------------- tree
def test_chain_tree_and_siblings_equal_reference():
    t, jt = tree.chain_tree(7, [3, 4, 5], "LS", 0.5), j_tree.chain_tree(7, [3, 4, 5], "LS", 0.5)
    for mod_t in (t, jt):
        c = mod_t.add_child(1, 9, "PLD", 0.4)
        mod_t.add_child(1, 11, "PLD", 0.3)
        mod_t.add_child(c, 2, "LS", 0.5)
    for attr in ("tokens", "parents", "depth", "config", "p_acc", "children"):
        assert getattr(t, attr) == getattr(jt, attr), attr
    for node in range(len(t)):
        assert t.siblings(node) == jt.siblings(node), node
    assert t.siblings(0) == [] and t.siblings(2) == [4, 5]
    for a, b in zip(t.flatten(), jt.flatten()):
        np.testing.assert_array_equal(a, b)
