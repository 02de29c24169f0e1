"""The port's spec trees, dry run and collective counts against the JAX
reference, with no processes.

``repro_torch.launch.sharding`` must give the reference's trees
(``src/repro/launch/sharding.py``), leaf by leaf with each
``PartitionSpec`` compared as a tuple, for all eleven configs at mesh
shapes (data, model) = (1, 1), (2, 2), (1, 4), (4, 2), (16, 16) and the
two-pod (2, 16, 16); the reference is handed a ``SimpleNamespace`` with the
mesh's ``shape`` and ``axis_names``. The dry run's per-device bytes
(``launch/dryrun.py::_local_bytes`` over ``init_params(device="meta")``)
equal the reference's ``_local_bytes`` over ``jax.eval_shape`` trees within
1e-12 relative, and ``analysis.costs.decode_collectives`` counts one
layer's all-reduces as a hand count does. The model's entry points refuse
params cut for another ``model`` axis than the active mesh's.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.config import get_config as j_get_config  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.serving import telemetry as JTM  # noqa: E402
from repro_torch.analysis import costs  # noqa: E402
from repro_torch.analysis.roofline import NVLINK_BW  # noqa: E402
from repro_torch.config import get_config, list_configs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.serving import telemetry as TM  # noqa: E402

_xla = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS on import)

if _xla is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla

ARCHS = list_configs()
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
    return ref, Mesh(shape, axes, shape_only=True)


def _tuples(tree):
    """The reference's tree with each PartitionSpec as a tuple."""
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_tuples(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def _same(got, want, path="root"):
    """Leaf-by-leaf equality with the failing path named."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: {got} != {want}"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference(arch, mesh):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jm, m = _meshes(mesh)
    B = 8
    _same(SH.param_specs(cfg, m), _tuples(JSH.param_specs(jcfg, jm)), "param_specs")
    for kw in (dict(), dict(global_batch=B), dict(global_batch=3), dict(shard_seq=True),
               dict(ring_window=True), dict(global_batch=B, paged=True)):
        _same(SH.cache_specs(cfg, m, **kw), _tuples(JSH.cache_specs(jcfg, jm, **kw)),
              f"cache_specs {kw}")
    for kw in (dict(), dict(shard_seq=True)):
        _same(SH.staged_specs(cfg, m, **kw), _tuples(JSH.staged_specs(jcfg, jm, **kw)),
              f"staged_specs {kw}")
        assert SH.cache_seq_axes(cfg, m, **kw) == JSH.cache_seq_axes(jcfg, jm, **kw)
        assert SH.seq_shard_count(cfg, m, **kw) == JSH.seq_shard_count(jcfg, jm, **kw)
    for gb in (1, B, 256):
        _same(SH.batch_specs(cfg, m, global_batch=gb),
              _tuples(JSH.batch_specs(jcfg, jm, global_batch=gb)), "batch_specs")
        assert SH.batch_axis(m, gb) == JSH.batch_axis(jm, gb)
        for sampled in (False, True):
            for prefill in (False, True):
                _same(SH.round_state_specs(m, global_batch=gb, sampled=sampled, prefill=prefill),
                      _tuples(JSH.round_state_specs(jm, global_batch=gb, sampled=sampled,
                                                    prefill=prefill)), "round_state_specs")
        for levels in (0, 3):
            _same(SH.telemetry_specs(TM.telemetry_schema(gb, 4, levels), m, global_batch=gb),
                  _tuples(JSH.telemetry_specs(JTM.telemetry_schema(gb, 4, levels), jm,
                                              global_batch=gb)), "telemetry_specs")
    assert SH.attention_policy(cfg, m.shape["model"]) == JSH.attention_policy(jcfg, m.shape["model"])
    assert SH.mamba_policy(cfg, m.shape["model"]) == JSH.mamba_policy(jcfg, m.shape["model"])
    assert SH.dp_size(m) == JSH.dp_size(jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_opt_specs_and_dryrun_bytes_equal_reference(arch, mesh):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jm, m = _meshes(mesh)
    jshape = JD.params_shapes(jcfg)
    pshape = D.params_shapes(cfg)
    jspec = JSH.fsdp_upgrade(JSH.param_specs(jcfg, jm), jshape, jm)
    spec = SH.fsdp_upgrade(SH.param_specs(cfg, m), pshape, m)
    _same(spec, _tuples(jspec), "fsdp_upgrade")
    opt, jopt = SH.opt_specs(spec), _tuples(JSH.opt_specs(jspec))
    assert opt.step == jopt.step
    _same(opt.mu, jopt.mu, "mu")
    _same(opt.nu, jopt.nu, "nu")
    for s, js in ((SH.param_specs(cfg, m), JSH.param_specs(jcfg, jm)), (spec, jspec)):
        got, want = D._local_bytes(pshape, s, m), JD._local_bytes(jshape, js, jm)
        assert abs(got - want) <= 1e-12 * want
    # the spec tree is congruent with the params: a spec no longer than its leaf
    SH.map_specs(lambda sp, t: None if len(sp) <= t.ndim else pytest.fail(str(sp)), spec, pshape)


def test_dryrun_cache_bytes_equal_reference():
    m = Mesh((16, 16), ("data", "model"), shape_only=True)
    jm = types.SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model"))
    for arch in ("vicuna-7b", "gemma3-1b", "jamba-v0.1-52b"):
        jcfg, cfg = j_get_config(arch), get_config(arch)
        for B, S, ring in ((128, 4096, False), (1, 8192, True)):
            jshape = jax.eval_shape(lambda: __import__("repro.models.model", fromlist=["M"])
                                    .init_cache(jcfg, B, S, ring_window=ring))
            shape = D.M.init_cache(cfg, B, S, ring_window=ring, device="meta")
            kw = dict(shard_seq=B == 1, ring_window=ring)
            got = D._local_bytes(shape, SH.cache_specs(cfg, m, **kw), m)
            want = JD._local_bytes(jshape, JSH.cache_specs(jcfg, jm, **kw), jm)
            assert abs(got - want) <= 1e-12 * want


def test_local_shard_cuts_the_rank_slices():
    m = Mesh((2, 2), ("data", "model"), shape_only=True)
    full = {"w": np.arange(4 * 6).reshape(4, 6), "b": np.arange(5)}
    specs = {"w": ("data", "model"), "b": ()}
    got = SH.local_shard(full, specs, m, {"data": 1, "model": 0})
    np.testing.assert_array_equal(got["w"], full["w"][2:4, 0:3])
    np.testing.assert_array_equal(got["b"], full["b"])
    assert SH.local_shape((4, 6), ("data", "model"), m) == (2, 3)
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shape((5, 6), ("data", None), m)


def test_collective_bytes_of_one_layer_match_a_hand_count():
    cfg = get_config("vicuna-7b")             # bfloat16, policy kv at model=2
    B, T, n = 4, 16, 2
    M, d, elt, V = B * T, 4096, 2, cfg.padded_vocab
    ring = 2 * (n - 1) / n
    hand = ring * (M * d * elt            # the embedding's sum
                   + M * V * 4            # the logits' gather (float32)
                   + M * d * elt          # layer 0's wo sum
                   + M * d * elt)         # layer 0's w_down sum
    got = costs.decode_collectives(cfg, B, T, 512, model=n, layers=[0])
    assert got == {"all-reduce": hand}
    assert costs.decode_collectives(cfg, B, T, 512, model=1, layers=[0]) == {"all-reduce": 0.0}
    # gemma3-1b at model=2 (policy q): the query gather and the slices' combine too
    g = get_config("gemma3-1b")
    H, KV, hd = g.num_heads, g.num_kv_heads, g.resolved_head_dim()
    R = H // KV * T
    Mg, dg = B * T, g.d_model
    hand_g = ring * (Mg * dg * 4 + Mg * g.padded_vocab * 4 + Mg * dg * 4 + Mg * H * hd * 4
                     + 2 * B * KV * R * 4 + B * KV * R * hd * 4 + Mg * dg * 4)
    got_g = costs.decode_collectives(g, B, T, 512, model=n, layers=[0], dtype="float32")
    assert got_g["all-reduce"] == pytest.approx(hand_g, rel=1e-15)
    step = costs.decode_step(cfg, B, T, 512, model=n, layers=[0])
    assert step.coll_bytes == got and step.t_collective == hand / NVLINK_BW
    assert costs.decode_step(cfg, B, T, 512, layers=[0]).t_collective == 0.0


@pytest.mark.parametrize("entry", ["prefill", "decode_step"])
@pytest.mark.parametrize("case", ["shards_off_mesh", "whole_on_mesh"])
def test_entry_points_refuse_params_cut_for_another_mesh(case, entry):
    # the active mesh decides the collectives: params cut for a model axis
    # of 2 outside use_mesh, or whole params inside a model=2 mesh, raise
    # instead of returning partial sums and a vocabulary slice
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models import shard_utils as SU

    cfg = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=2, dtype="float32")
    m = Mesh((1, 2), ("data", "model"), shape_only=True)
    whole = M.init_params(cfg, 0, device="cpu")
    params = (SH.local_shard(whole, SH.param_specs(cfg, m), m, {"data": 0, "model": 0})
              if case == "shards_off_mesh" else whole)
    cache = M.init_cache(cfg, 1, 32, device="cpu")
    toks = torch.arange(2, 6)[None]
    with SU.use_mesh(None if case == "shards_off_mesh" else m):
        with pytest.raises(ValueError, match="vocabulary rows"):
            if entry == "prefill":
                M.prefill(cfg, params, {"tokens": toks}, cache)
            else:
                M.decode_step(cfg, params, cache, toks)
    # the same params in their own placement run
    with SU.use_mesh(None):
        M.decode_step(cfg, whole, cache, toks)


def test_train_collective_bytes_of_one_layer_match_a_hand_count():
    """``analysis.costs.train_collective_terms`` for one vicuna-7b layer
    (bfloat16) at data=2, model=2 (policy kv), remat on, by hand: every
    group has two ranks (ring factor 1) but the norm's (data, model) sum
    over four (3/2). The CPU ranks of ``test_torch_train_mesh.py`` hold the
    function to the bytes they pass to ``all_reduce``."""
    import dataclasses

    cfg = dataclasses.replace(get_config("vicuna-7b"), num_layers=1)
    B, S, d, V, F, elt = 8, 16, 4096, 32000, 11008, 2
    M = B // 2 * S
    terms = costs.train_collective_terms(cfg, B, S, data=2, model=2)
    # the embedding's sum, the logits' gather (float32), the head input's
    # gradient; the layer's wo and w_down sums twice (the recompute), its
    # two replicated inputs' gradients once
    assert terms["tp"] == M * d * elt + M * V * 4 + M * d * elt + 2 * 2 * M * d * elt \
        + 2 * M * d * elt
    # every layer leaf is cut over data at min_dim 512: gathered whole over
    # data (its model shard) twice forward and once as the gradient's sum
    layer = (4 * d * 16 * 128 + 3 * d * F // 2 + 2 * d) * elt
    assert terms["fsdp"] == 3 * layer
    # embed and lm_head (vocab 16000 a rank) and final_norm summed over data
    assert terms["grad"] == (2 * V // 2 * d + d) * elt
    # the global ce; the norm's 12-leaf sums over model, data and both
    assert terms["step"] == 4
    assert terms["norm"] == 12 * 4 * (1 + 1 + 1.5)
    assert costs.train_collectives(cfg, B, S, data=2, model=2) == {"all-reduce": sum(terms.values())}
    assert costs.train_collectives(cfg, B, S) == {"all-reduce": 0.0}


@pytest.mark.parametrize("mesh_spec", ["data=1,model=1", "data=2,model=2"])
def test_train_plan_counts_the_moments_float32_leaf_by_leaf(mesh_spec):
    """The dry run's train row for jamba-v0.1-52b (bfloat16, with a float32
    router and float32 Mamba-2 ``A_log``, ``D`` and ``dt_bias``): the
    per-device params and AdamW moments are the bytes ``init_params`` and
    ``adamw_init`` give this rank's shards (``train_specs``), the moments
    at 8 bytes an element whatever type their params take."""
    from repro_torch.config import get_shape
    from repro_torch.models import model as M
    from repro_torch.training import adamw_init

    cfg = get_config("jamba-v0.1-52b")
    mesh = D.shape_mesh(mesh_spec)
    row = D.plan(cfg, get_shape("train_4k"), mesh)
    params = M.init_params(cfg, device="meta", mesh=mesh, specs=SH.train_specs(cfg, mesh))
    opt = adamw_init(params)
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in M.tree_leaves(tree))  # noqa: E731
    assert row["params_bytes"] == nbytes(params)
    assert row["grad_bytes"] == row["params_bytes"]
    assert row["moment_bytes"] == nbytes((opt.mu, opt.nu))
    # the float32 leaves take 8 bytes of moments an element, not 4 x 2
    assert row["moment_bytes"] < 4 * row["params_bytes"]
