"""The port's mesh on the CPU: tensor parallelism and context-parallel
decode attention over ``torch.distributed`` (``gloo``), in processes that
``repro_torch.launch.mesh.spawn`` starts, against the unsharded port and the
JAX reference on the same inputs.

At ``model=2`` (two ranks, ``tests/torch_mesh_workers.py::model_rank``):

  - vicuna-7b reduced at 4 layers (policy ``kv``: heads, d_ff and the
    vocabulary over ``model``), params carried from the reference by
    ``bridge.params_from_jax(mesh=)``: prefill, a tree-masked decode, a
    ragged commit and a second decode give logits within 1e-4 of the
    unsharded port's and the reference's;
  - gemma3-1b reduced (policy ``q``: the cache sequence-sharded over
    ``model``): the same calls within 1e-4 of the unsharded port's, and one
    context-parallel ``decode_attention`` (each rank's slice through the
    flash-decode partials, the cross-rank logsumexp combine, then the tree
    merge) within 1e-5 of the one-device call and of the reference's;
  - the int8 bank on shards: a row-parallel weight's int8 rows and column
    scales, the activation's row scales and int8 columns, the int32
    products (summed over the ranks) and the sim path's fake-quantized
    leaves, bitwise equal to the unsharded ones;
  - qwen2-moe and mamba2-130m reduced serve ``chain_fused`` with the
    one-device server's streams, round dispatches and host syncs;
  - the serve CLI over ``--mesh model=2,data=1 --spawn`` prints the
    one-device mesh's summary.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

J_VICUNA = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=4)
J_PARAMS = jax.tree.map(np.asarray, JM.init_params(J_VICUNA, jax.random.PRNGKey(0)))
CASE = W.attention_case()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_model2")
    spawn(W.model_rank, 2, ("data=1,model=2", {"vicuna_params": J_PARAMS,
                                              "attention_case": CASE}, str(out)), device="cpu")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _reference_logits(B=2, S=64, T=5):
    """``torch_mesh_workers.decode_logits`` in the reference."""
    rng = np.random.default_rng(0)
    toks = rng.integers(2, J_VICUNA.vocab_size, (B, 11)).astype(np.int32)
    t2 = rng.integers(2, J_VICUNA.vocab_size, (B, T)).astype(np.int32)
    mask = np.tril(np.ones((T, T), bool))
    cache = JM.init_cache(J_VICUNA, B, S)
    l1, cache = JM.prefill(J_VICUNA, J_PARAMS, {"tokens": toks}, cache)
    l2, st = JM.decode_step(J_VICUNA, J_PARAMS, cache, t2, tree_mask=mask)
    cache = JM.commit_cache(J_VICUNA, cache, st, np.broadcast_to(np.arange(T), (B, T)),
                            np.array([3, T], np.int32))
    l3, _ = JM.decode_step(J_VICUNA, J_PARAMS, cache, t2[:, :2])
    return [np.asarray(x) for x in (l1, l2, l3)]


def test_tensor_parallel_decode_matches_unsharded_and_reference(ranks):
    params = bridge.params_from_jax(J_PARAMS, device="cpu")
    port = W.decode_logits(W.VICUNA, params, "cpu")
    ref = _reference_logits()
    for r in ranks:
        for got, one, want in zip(r["vicuna_logits"], port, ref):
            assert got.shape == one.shape
            np.testing.assert_allclose(got, one, rtol=0, atol=1e-4)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the logits are replicated: every rank gathers the same vocabulary
    for a, b in zip(ranks[0]["vicuna_logits"], ranks[1]["vicuna_logits"]):
        np.testing.assert_array_equal(a, b)


def test_sequence_sharded_gemma3_decode_matches_unsharded(ranks):
    one = W.decode_logits(W.GEMMA, M.init_params(W.GEMMA, 0, device="cpu"), "cpu")
    for got, want in zip(ranks[0]["gemma_logits"], one):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["causal", "window"])
def test_context_parallel_decode_attention(ranks, kind):
    window = 24 if kind == "window" else 0
    one = W.run_attention(CASE, "cpu", kind=kind, window=window)
    want = np.asarray(JA.decode_attention(CASE["q"], CASE["k"], CASE["v"], CASE["pos"], CASE["kn"],
                                          CASE["vn"], CASE["q_pos"], tree_mask=CASE["tm"],
                                          kind=kind, window=window))
    for r in ranks:
        got = r[f"cp_{kind}"]
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("check", ["w_q", "w_scale", "x_q", "x_scale", "int32", "sim"])
def test_int8_bank_on_shards_is_bitwise_unsharded(ranks, check):
    for r in ranks:
        assert r["int8"][check] is True


def test_int8_partial_products_sum_to_the_unsharded_product(ranks):
    for r in ranks:
        assert r["int8"]["product_err"] < 1e-6


@pytest.mark.parametrize("arch", ["moe", "mamba"])
def test_moe_and_mamba_serve_chain_fused_on_the_mesh(ranks, arch):
    cfg = {"moe": W.MOE, "mamba": W.MAMBA}[arch]
    want = W.serve_streams(cfg, M.init_params(cfg, 0, device="cpu"), "chain_fused", "cpu")
    for r in ranks:
        assert r[arch] == want
    assert sum(len(v) for v in want[0].values()) > 4 * 6


def test_serve_cli_over_a_spawned_mesh(capfd):
    argv = ["--device", "cpu", "--reduced", "--mode", "tree_fused", "--batch", "2",
            "--tokens", "6"]
    serve.main(argv + ["--mesh", "model=1,data=1"])
    one = capfd.readouterr().out.strip().splitlines()
    serve.main(argv + ["--mesh", "model=2,data=1", "--spawn"])
    two = capfd.readouterr().out.strip().splitlines()
    assert one[0] == "mesh: {'data': 1, 'model': 1} over 1 devices"
    assert two[0] == "mesh: {'data': 1, 'model': 2} over 2 devices"
    a, b = json.loads(one[-1]), json.loads(two[-1])
    for k in ("wall_s", "device_wait_s", "mesh"):
        a.pop(k), b.pop(k)
    assert a == b and a["delivered_tokens"] == 12
