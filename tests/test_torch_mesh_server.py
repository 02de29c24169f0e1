"""The port's batched server on a ``data=2, model=2`` mesh (four ``gloo``
ranks that ``repro_torch.launch.mesh.spawn`` starts on the CPU), in every
mode, against the one-device port and the JAX reference's single-device
server: the reference's ``tests/test_server_sharded.py`` for the port.

Params are tensor-parallel over ``model`` and the four slots sharded two a
data rank; every rank runs the same scheduler. Greedy streams equal the
one-device port's and the reference's in ``chain_fused``, ``legacy``,
``tree_fused`` and ``cascade_fused`` (and paged ``chain_fused`` /
``tree_fused`` against the one-device paged port), and the mesh adds no
round dispatch and no host sync: both equal the one-device server's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=3)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree.map(np.asarray, J_PARAMS)
PARAMS = bridge.params_from_jax(NP_PARAMS, device="cpu")
CASES = list(W.MODES) + ["chain_fused paged", "tree_fused paged"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_server")
    spawn(W.server_rank, 4, ("data=2,model=2", {"params": NP_PARAMS}, str(out)), device="cpu")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _reference_streams(mode):
    kw = dict(max_batch=4, max_len=128, draft_k=4, tree_expansions=3, adaptive=True, min_obs=1)
    if mode != "cascade_fused":
        kw["draft_spec"] = j_layer_sparsity(J_CFG, 0.5)
    srv = JServer(J_CFG, J_PARAMS, mode=mode, **kw)
    for b, p in enumerate(W.prompts(W.SERVE_CFG)):
        srv.add_request(b, p)
    gen = {b: [] for b in range(4)}
    for _ in range(6):
        for b, t in srv.step().items():
            gen[b].extend(int(x) for x in t)
    for b, t in srv.flush().items():
        gen[b].extend(int(x) for x in t)
    return gen


@pytest.mark.parametrize("case", CASES)
def test_mesh_server_matches_one_device(ranks, case):
    mode, _, paged = case.partition(" ")
    want = W.serve_streams(W.SERVE_CFG, PARAMS, mode, "cpu", paged=bool(paged))
    for r in ranks:
        streams, counts = r[case]
        assert streams == want[0]
        assert counts == want[1]             # round dispatches, host syncs, steps
    assert sum(len(v) for v in want[0].values()) >= 4 * 6


@pytest.mark.parametrize("mode", W.MODES)
def test_mesh_server_matches_reference(ranks, mode):
    want = _reference_streams(mode)
    for r in ranks:
        assert r[mode][0] == want
