"""The slice end to end: the port's single-stream CAS-Spec loop against the
JAX ``SpecEngine``, on the CPU in float32.

The paper's invariant holds inside the port (DyTC's greedy stream equals
AR's) and across packages (both equal the reference engine's streams), and
the DyTC rounds accept the same token lists round by round. The engines'
cost trackers observe wall clock, so both are pinned to their DraftSpec
priors here: otherwise the two packages' different speeds would steer DyTC
to different (equally lossless) trees.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core.cascade import ARScheduler as JAR  # noqa: E402
from repro.core.dsia import build_hierarchy as j_build_hierarchy  # noqa: E402
from repro.core.dytc import DyTCScheduler as JDyTC  # noqa: E402
from repro.core.engine import SpecEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import ARScheduler, DyTCScheduler, SpecEngine, build_hierarchy  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
PROMPT = np.array([5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6, 7], np.int32)
N_TOK = 16


def _pin_costs(engine):
    engine.costs.observe = lambda *a, **k: None
    engine.costs.observe_target = lambda *a, **k: None
    return engine


def _run(engine, make_sched):
    """Generate N_TOK tokens; returns (stream, accepted tokens per round)."""
    _pin_costs(engine)
    engine.start(PROMPT)
    sched = make_sched(engine)
    rounds = []
    step = sched.step
    sched.step = lambda: rounds.append(list(step())) or rounds[-1]
    return sched.generate(N_TOK), rounds


@pytest.fixture(scope="module")
def reference():
    ar, _ = _run(JEngine(J_CFG, J_PARAMS, max_len=128), JAR)
    dytc, rounds = _run(JEngine(J_CFG, J_PARAMS, max_len=128),
                        lambda e: JDyTC(e, j_build_hierarchy(J_CFG)))
    return ar, dytc, rounds


@pytest.mark.parametrize("draft_exec", ["slice", "mask"])
def test_dytc_token_identical_to_ar_and_reference(reference, draft_exec):
    j_ar, j_dytc, j_rounds = reference
    assert j_dytc == j_ar
    ar, _ = _run(SpecEngine(CFG, PARAMS, max_len=128, device="cpu"), ARScheduler)
    engine = SpecEngine(CFG, PARAMS, max_len=128, draft_exec=draft_exec, device="cpu")
    dytc, rounds = _run(engine, lambda e: DyTCScheduler(e, build_hierarchy(CFG)))
    assert ar == j_ar
    assert dytc == ar
    assert rounds == j_rounds
    assert engine.stats["rounds"] < N_TOK            # DyTC accepted drafts
