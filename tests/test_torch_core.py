"""The port's host-side CAS-Spec core against the reference, on shared inputs.

These modules are numpy/stdlib copies in both packages, so every result is
discrete or a float computed in the same order: the tests ask for equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import dsia as jdsia  # noqa: E402
from repro.core.acceptance import AcceptanceTracker as JAcceptance  # noqa: E402
from repro.core.ewif import best_dytc_k as j_best_dytc_k  # noqa: E402
from repro.core.pld import PromptLookup as JPromptLookup  # noqa: E402
from repro.core.tree import DraftTree as JDraftTree  # noqa: E402
from repro.core.verify import greedy_accept_tree as j_greedy  # noqa: E402
from repro.core.verify import softmax as j_softmax  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import dsia  # noqa: E402
from repro_torch.core.acceptance import AcceptanceTracker  # noqa: E402
from repro_torch.core.ewif import best_dytc_k  # noqa: E402
from repro_torch.core.pld import PromptLookup  # noqa: E402
from repro_torch.core.tree import DraftTree, bucket_for  # noqa: E402
from repro_torch.core.verify import greedy_accept_tree, softmax  # noqa: E402


def _random_trees(seed, n_trees=40):
    rng = np.random.default_rng(seed)
    for _ in range(n_trees):
        root = int(rng.integers(0, 6))
        t, jt = DraftTree(root), JDraftTree(root)
        for _ in range(int(rng.integers(0, 30))):
            parent = int(rng.integers(0, len(t)))
            tok = int(rng.integers(0, 6))
            alpha = float(rng.random())
            assert t.add_child(parent, tok, "cfg", alpha) == jt.add_child(parent, tok, "cfg", alpha)
        yield rng, t, jt


def test_draft_tree_flatten_and_greedy_walk():
    for rng, t, jt in _random_trees(0):
        for a, b in zip(t.flatten(), jt.flatten()):
            np.testing.assert_array_equal(a, b)
        assert t.best_active_leaf() == jt.best_active_leaf()
        argmax = rng.integers(0, 6, size=len(t))
        assert greedy_accept_tree(t, argmax) == j_greedy(jt, argmax)
    assert [bucket_for(n) for n in (1, 8, 9, 32, 33, 128)] == [8, 8, 16, 32, 64, 128]


def test_prompt_lookup_proposals():
    rng = np.random.default_rng(1)
    pl, jpl = PromptLookup(), JPromptLookup()
    for _ in range(200):
        n = int(rng.integers(0, 40))
        ctx = rng.integers(0, 5, size=n).astype(np.int32)
        k = int(rng.integers(1, 9))
        got, conf = pl.propose_with_confidence(ctx, k)
        want, jconf = jpl.propose_with_confidence(ctx, k)
        np.testing.assert_array_equal(got, want)
        assert conf == jconf


def test_best_dytc_k_grid():
    for a in np.linspace(0.0, 1.0, 11):
        for c in (0.01, 0.3, 0.6, 1.0):
            for a_dn, c_dn in ((0.3, 0.01), (0.9, 0.5)):
                for k_max in (1, 5, 8):
                    assert best_dytc_k(a, c, a_dn, c_dn, k_max) == j_best_dytc_k(a, c, a_dn, c_dn, k_max)


@pytest.mark.parametrize("num_layers", [2, 4, 8, 32, 33])
def test_layer_sparsity_and_hierarchies(num_layers):
    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=num_layers)
    jcfg = dataclasses.replace(j_get_config("vicuna-7b"), num_layers=num_layers)
    for s in (0.0, 0.25, 0.4, 0.6, 0.9):
        assert dataclasses.asdict(dsia.layer_sparsity(cfg, s)) == dataclasses.asdict(jdsia.layer_sparsity(jcfg, s))
    for mode in ("scaling", "mixing", "replacing", "early_exit"):
        got = [dataclasses.asdict(s) for s in dsia.build_hierarchy(cfg, mode)]
        assert got == [dataclasses.asdict(s) for s in jdsia.build_hierarchy(jcfg, mode)]


def test_acceptance_tracker_and_softmax():
    rng = np.random.default_rng(2)
    t, jt = AcceptanceTracker(), JAcceptance()
    for name in ("LS0.4", "LS0.6"):
        t.set_prior(name, 0.5)
        jt.set_prior(name, 0.5)
    for _ in range(60):
        name = ("LS0.4", "LS0.6", "PLD")[int(rng.integers(0, 3))]
        ok = bool(rng.random() < 0.6)
        t.observe(name, ok)
        jt.observe(name, ok)
    assert t.snapshot() == jt.snapshot()
    x = rng.standard_normal((3, 50)) * 20
    np.testing.assert_array_equal(softmax(x, 0.7), j_softmax(x, 0.7))
