"""Chunked prefill (``prefill_chunk > 0``) in the port against the JAX
reference, on the CPU in float32.

The port's counterpart of ``tests/test_paged_serving.py``'s chunked-prefill
tests. One ``prefill_chunk_stage`` call after another on a block-paged
cache is held against the reference's: positions, prefill progress and
pending tokens exactly, cache pools within 1e-5 (float32 decodes of four
layers). A chunked server emits the reference chunked server's tokens round
by round, and per slot a prefix of the port's non-chunked server's stream
(chunks change when a prompt's tokens are consumed, not what the model
computes); admission is enqueue-only, so decoding slots keep emitting while
a long prompt is prefilled. Chunked prefill is refused on a dense cache
and in split rounds, and a ``sampling`` argument that is no
``SamplingParams`` is refused (sampled chunked prefill:
``test_torch_sampled_server.py``). On the CPU the stage runs in every
round, masked where no slot prefills; on the card it sits behind a
conditional node (``test_torch_on_card.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.dsia import DraftSpec as JDraftSpec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.dsia import DraftSpec  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402

L = 4
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=L)
CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=L)
J_PARAMS = JM.init_params(J_CFG, jax.random.PRNGKey(0))
PARAMS = bridge.params_from_jax(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
SPEC_KW = dict(name="self_draft", gates=(1,) * L, prior_alpha=0.6, prior_c=0.2)
MAX_LEN, PAGE, CHUNK = 128, 16, 8
_rng = np.random.default_rng(3)
PROMPTS = [np.tile(_rng.integers(2, CFG.vocab_size, size=5), 3).astype(np.int32),
           _rng.integers(2, CFG.vocab_size, size=19).astype(np.int32)]


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def test_prefill_chunk_stage_matches_reference():
    """Slot 0 prefills 19 tokens (three chunks, the last partial), slot 1
    five (one), slot 2 nothing: after each call the same pos, pf_done and
    pending (the safe ctx[pos] while prefilling, the first token after),
    and the same pools."""
    B, lens = 3, (19, 5, 0)
    j_cache = JM.init_cache(J_CFG, B, MAX_LEN, paged=True, page_size=PAGE)
    table = np.random.default_rng(1).permutation(B * MAX_LEN // PAGE).astype(np.int32)
    j_cache["page_table"] = jnp.asarray(table.reshape(B, -1))
    cache = bridge.cache_from_jax(jax.tree.map(np.asarray, j_cache), device="cpu")
    ctx = np.zeros((B, MAX_LEN), np.int32)
    rng = np.random.default_rng(2)
    for b, n in enumerate(lens):
        ctx[b, :n] = rng.integers(2, CFG.vocab_size, size=n)
    state = dict(ctx=ctx, pf_done=np.zeros(B, np.int32), pf_len=np.array(lens, np.int32),
                 pending=np.array([ctx[0, 0], ctx[1, 0], 7], np.int32))
    j_state = {k: jnp.asarray(v) for k, v in state.items()}
    t_state = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    j_stage = jax.jit(functools.partial(jeng.prefill_chunk_stage, J_CFG, chunk=CHUNK))
    for call in range(3):
        j_cache, j_state = j_stage(J_PARAMS, j_cache, j_state)
        engine.prefill_chunk_stage(CFG, PARAMS, cache, t_state, chunk=CHUNK)
        for k in ("pf_done", "pending"):
            np.testing.assert_array_equal(t_state[k].numpy(), np.asarray(j_state[k]),
                                          err_msg=f"call {call}: {k}")
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(j_cache["pos"]))
        for n in ("k_pages", "v_pages"):
            _close(cache["segments"][0][0][n].numpy(), np.asarray(j_cache["segments"][0][0][n]))
    assert list(cache["pos"].numpy()) == list(lens)
    assert t_state["pending"][2] == 7                       # a slot that prefills nothing


def _kwargs(mode, **kw):
    out = dict(mode=mode, max_batch=2, max_len=MAX_LEN, draft_k=4, tree_expansions=3,
               adaptive=True, min_obs=1, paged=True, page_size=PAGE)
    out.update(kw)
    return out


def _port(mode, **kw):
    return BatchedSpecServer(CFG, PARAMS, draft_spec=DraftSpec(**SPEC_KW), device="cpu",
                             **_kwargs(mode, **kw))


def _run(srv, rounds, prompts=PROMPTS):
    for i, p in enumerate(prompts):
        srv.add_request(i, p)
    gen = {i: [] for i in range(len(prompts))}
    per_round = []
    for _ in range(rounds):
        out = srv.step()
        per_round.append(out)
        for b, t in out.items():
            gen[b].extend(t)
    return gen, per_round


@pytest.mark.parametrize("mode", ["chain_fused", "tree_fused"])
def test_chunked_server_matches_reference_and_is_a_prefix(mode):
    """Round by round the reference chunked server's tokens; per slot a
    prefix of the non-chunked server's stream, lagging by the prefill
    rounds."""
    ref_srv = JServer(J_CFG, J_PARAMS, draft_spec=JDraftSpec(**SPEC_KW), telemetry=False,
                      prefill_chunk=CHUNK, **_kwargs(mode))
    port = _port(mode, prefill_chunk=CHUNK)
    j_gen, j_rounds = _run(ref_srv, 8)
    gen, rounds = _run(port, 8)
    assert rounds == j_rounds and gen == j_gen
    # 15 and 19 prompt tokens: slot 0 decodes from round 1 on, slot 1 from round 2
    assert rounds[0] == {} and 0 in rounds[1] and 1 not in rounds[1] and 1 in rounds[2]
    assert port.stats["prefill_rounds"] == 3
    dense, _ = _run(_port(mode), 6)
    for b, stream in dense.items():
        n = min(len(stream), len(gen[b]))
        assert n > 2 and gen[b][:n] == stream[:n], f"slot {b}: chunked stream diverged"
    assert port.dstate["pf_done"].tolist() == [len(p) for p in PROMPTS]


def test_chunked_admission_does_not_block_decoding():
    """Decoding slots keep emitting while a 100-token prompt is prefilled
    (13 rounds), which emits nothing until its prefill is done; releasing
    a slot mid-prefill stops it."""
    srv = _port("chain_fused", prefill_chunk=CHUNK, max_len=256)
    long_prompt = np.random.default_rng(5).integers(2, CFG.vocab_size, size=100).astype(np.int32)
    srv.add_request(0, PROMPTS[0])
    for _ in range(2):
        srv.step()
    srv.add_request(1, long_prompt)
    during = {0: [], 1: []}
    for _ in range(6):
        for b, t in srv.step().items():
            during[b].extend(t)
    assert len(during[0]) >= 6, "the decoding slot stalled during chunked prefill"
    assert during[1] == [], "the long prompt emitted before its prefill finished"
    after = {0: [], 1: []}
    for _ in range(10):
        for b, t in srv.step().items():
            after[b].extend(t)
    assert len(after[1]) > 0, "the long prompt never finished its prefill"
    srv.add_request(1, long_prompt)
    srv.step()
    srv.release(1)
    assert srv.dstate["pf_len"][1] == srv.dstate["pf_done"][1] == 0
    srv.step()
    assert srv.cache["pos"][1] == 0


@pytest.mark.parametrize("kw,err", [
    (dict(paged=False), ValueError),
    (dict(round_mode="split"), ValueError),
    (dict(sampling=object()), TypeError),
], ids=["dense", "split", "sampled"])
def test_chunked_prefill_refusals(kw, err):
    with pytest.raises(err):
        _port("chain_fused", prefill_chunk=CHUNK, **kw)
