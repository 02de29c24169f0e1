"""Sharded training in the port on the CPU: the train step on a ("data",
"model") mesh over ``torch.distributed`` (``gloo``), in processes that
``repro_torch.launch.mesh.spawn`` starts, against the JAX reference's
unsharded step on the same inputs (GSPMD computes the unsharded function).

At ``model=2``, ``data=2`` and ``data=2,model=2`` (the rank bodies are
``tests/torch_mesh_workers.py::train_rank``), params carried from the
reference's ``init_params`` by ``bridge.params_from_jax(specs=)`` and cut by
``launch.sharding.train_specs`` at ``min_dim`` 128 (FSDP over ``data``: at
the reduced widths the reference's 512 cuts nothing), each rank on its
rows of every batch, for vicuna-7b reduced at 4 layers (policy ``kv``),
gemma3-1b reduced (policy ``q``, MQA), qwen2-moe-a2.7b reduced with
``exec_groups`` 1 (groups span the data ranks) and 2 (whole groups a
rank), and mamba2-130m reduced (heads over ``model``):

  - ``loss_fn``'s ce, moe_aux and loss (with a loss mask) within 1e-5 of
    the reference's unsharded ``loss_fn``, on every rank;
  - every gradient leaf (``loss_and_grads``, remat on), each rank's shard,
    within 1e-5 of that shard of ``jax.grad`` of the reference;
  - three ``make_train_step`` steps against the reference's by
    ``test_torch_training.py::test_three_train_steps_match_reference``'s
    rule (ce and grad_norm atol 1e-5, lr atol 1e-9, every param atol
    1e-5); the MoE and Mamba-2 stacks by their one-device tests' rule
    (``test_torch_train_stacks.py``: grad_norm rtol 1e-5, at most one param
    element in 10^4 of a leaf past 1e-5 and none past 3e-3);
  - the bytes one step passed to ``all_reduce`` (``shard_utils.COUNTER``)
    equal ``analysis.costs.train_collectives``' count.

Also: the MoE slot table on the data axes, gathered, bitwise the
unsharded one at ``exec_groups`` 1 and 2; the count of leaves cut over
``data``; a checkpoint written at ``data=2,model=2`` read by the
reference's and the port's one-device ``load_checkpoint``; the train CLI
over ``--mesh data=2,model=2 --spawn``; ``spawn`` without ``device=``
refused where there is no card.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_workers as W  # noqa: E402
from repro import training as JT  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch import training as T  # noqa: E402
from repro_torch.analysis import costs  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import Mesh, parse_mesh_spec, spawn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

MESHES = ("data=1,model=2", "data=2,model=1", "data=2,model=2")
ARCHS = tuple(W.train_cfgs())
STACKS = ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b groups 2", "mamba2-130m")


def _j_cfg(name):
    base = name.split(" ")[0]
    cfg = j_get_config(base).reduced()
    if base == "vicuna-7b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    if name.endswith("groups 2"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, exec_groups=2))
    return cfg


@functools.lru_cache(maxsize=None)
def _j_params(name):
    return JM.init_params(_j_cfg(name), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's unsharded loss, gradients and three train steps."""
    cfg, jp = _j_cfg(name), _j_params(name)
    jb = jax.tree.map(jnp.asarray, W.train_batch(W.train_cfgs()[name]))
    _, loss = JT.loss_fn(cfg, jp, jb, remat=False)
    grads = jax.jit(jax.grad(lambda p: JT.loss_fn(cfg, p, jb, remat=False)[0]))(jp)
    step = jax.jit(JT.make_train_step(cfg, **W.TRAIN_STEP_KW))
    opt, steps = JT.adamw_init(jp), []
    for b in W.step_batches(W.train_cfgs()[name]):
        jp, opt, m = step(jp, opt, jax.tree.map(jnp.asarray, b))
        steps.append({k: float(v) for k, v in m.items()})
    flat = lambda t: {k: np.asarray(v) for k, v in _flatten_with_paths(t)[0].items()}  # noqa: E731
    return ({k: float(v) for k, v in loss.items()}, flat(grads), steps, flat(jp))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Each mesh's ranks: {spec: (mesh, [(coords, record)], out dir)}. The
    three meshes' ranks run at once, the reference's side meanwhile."""
    params = {n: jax.tree.map(np.asarray, _j_params(n)) for n in ARCHS}
    dirs = {s: tmp_path_factory.mktemp(s.replace(",", "_").replace("=", "")) for s in MESHES}
    sizes = {s: parse_mesh_spec(s) for s in MESHES}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as ex:
        runs = [ex.submit(spawn, W.train_rank, int(np.prod(list(sizes[s].values()))),
                          (s, {"params": params}, str(dirs[s])), device="cpu", timeout_s=120)
                for s in MESHES]
        for name in ARCHS:
            _reference(name)
        for run in runs:
            run.result()
    out = {}
    for spec in MESHES:
        shape = tuple(sizes[spec].values())
        ranks = []
        for r in range(int(np.prod(shape))):
            coords = dict(zip(sizes[spec], (int(c) for c in np.unravel_index(r, shape))))
            ranks.append((coords, torch.load(dirs[spec] / f"rank{r}.pt", weights_only=False)))
        out[spec] = (Mesh(shape, tuple(sizes[spec]), shape_only=True), ranks, dirs[spec])
    return out


def _shard(a, spec, mesh, coords):
    return a[SH.local_slices(a.shape, spec, mesh, coords)]


def _specs(name, mesh):
    return SH.specs_by_key(SH.train_specs(W.train_cfgs()[name], mesh, min_dim=W.TRAIN_MIN_DIM))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", MESHES)
def test_loss_fn_matches_reference(meshes, spec, arch):
    want = _reference(arch)[0]
    for _, rec in meshes[spec][1]:
        for k in ("ce", "moe_aux", "loss"):
            assert abs(rec[arch]["loss"][k] - want[k]) <= 1e-5, k
    if "moe" in arch:
        assert want["moe_aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", MESHES)
def test_gradients_match_jax_grad(meshes, spec, arch):
    mesh, ranks, _ = meshes[spec]
    want, specs = _reference(arch)[1], _specs(arch, mesh)
    for coords, rec in ranks:
        got = rec[arch]["grads"]
        assert got.keys() == want.keys()
        for k, g in got.items():
            w = _shard(want[k], specs[k], mesh, coords)
            assert tuple(g.shape) == w.shape, k
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", MESHES)
def test_three_train_steps_match_reference(meshes, spec, arch):
    mesh, ranks, _ = meshes[spec]
    _, _, steps, jp = _reference(arch)
    specs = _specs(arch, mesh)
    for coords, rec in ranks:
        for got, want in zip(rec[arch]["steps"], steps):
            for k in ("ce", "moe_aux"):
                assert abs(got[k] - want[k]) <= 1e-5, k
            assert abs(got["lr"] - want["lr"]) <= 1e-9
            if arch in STACKS:
                assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * abs(want["grad_norm"])
            else:
                assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5
        for k, a in rec[arch]["params"].items():
            d = np.abs(a.numpy() - _shard(jp[k], specs[k], mesh, coords))
            if arch in STACKS:
                assert (d > 1e-5).sum() <= max(1, d.size // 10_000) and d.max() <= 3e-3, k
            else:
                assert d.max() <= 1e-5, k


@pytest.mark.parametrize("spec", MESHES)
def test_counted_collective_bytes_equal_the_bytes_passed(meshes, spec):
    """The bytes ``shard_utils`` counted on every rank as it passed them to
    ``all_reduce`` equal ``analysis.costs.train_collective_terms``' count
    for each variant: one train step (remat off, no loss mask, as the steps
    ran), and one ``loss_and_grads`` (remat on, a loss mask; no norm)."""
    sizes = parse_mesh_spec(spec)
    kw = dict(data=sizes["data"], model=sizes["model"], min_dim=W.TRAIN_MIN_DIM)
    for name, cfg in W.train_cfgs().items():
        step = costs.train_collectives(cfg, 4, 32, remat=False, **kw)["all-reduce"]
        terms = costs.train_collective_terms(cfg, 4, 24, remat=True, loss_mask=True, **kw)
        grads = sum(terms.values()) - terms["norm"]
        assert step > 0 and grads > 0
        for _, rec in meshes[spec][1]:
            assert rec[name]["step_bytes"] == pytest.approx(step, rel=1e-12), name
            assert rec[name]["grad_bytes"] == pytest.approx(grads, rel=1e-12), name


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cuts_layer_leaves_over_data(meshes, arch):
    """At ``min_dim`` 128 the training specs cut layer leaves over ``data``
    (the reference's 512 would cut none at these widths)."""
    cfg = W.train_cfgs()[arch]
    for spec in ("data=2,model=1", "data=2,model=2"):
        mesh = meshes[spec][0]
        n = meshes[spec][1][0][1][arch]["fsdp_leaves"]
        assert n == sum("data" in SH.spec_axes(s) for s in _specs(arch, mesh).values()) > 0
        assert not any("data" in SH.spec_axes(s) for s in SH.specs_by_key(
            SH.train_specs(cfg, mesh)).values())


@pytest.mark.parametrize("groups", [1, 2])
def test_capacity_slots_on_data_are_the_unsharded_table(meshes, groups):
    moe = dataclasses.replace(W.MOE.moe, exec_groups=groups)
    ids = torch.as_tensor(W.capacity_case(moe))
    slot, keep, C = moe_lib.capacity_slots(ids, moe, moe.capacity_factor)
    for spec in ("data=2,model=1", "data=2,model=2"):
        ranks = [rec for coords, rec in meshes[spec][1] if coords["model"] == 0]
        got = [rec["slots"][groups] for rec in ranks]
        assert all(c == C for _, _, c in got)
        assert torch.equal(torch.cat([s for s, _, _ in got]), slot.reshape(-1))
        assert torch.equal(torch.cat([k for _, k, _ in got]), keep.reshape(-1))
    assert not bool(keep.all())          # the capacity drops some pairs


def test_checkpoint_of_the_mesh_reads_in_both_packages(meshes):
    """vicuna trained three steps at data=2,model=2 and saved gathered:
    the reference's ``load_checkpoint`` and the port's one-device one read
    it; it equals the ranks' shards bitwise and the reference's params
    after the same steps within the steps' tolerance."""
    mesh, ranks, d = meshes["data=2,model=2"]
    path = str(d / "ckpt")
    jp0 = _j_params("vicuna-7b")
    rp, ro, step = JT.load_checkpoint(path, jp0, JT.adamw_init(jp0))
    assert step == 3 and int(ro.step) == 3
    ref = {k: np.asarray(v) for k, v in _flatten_with_paths(rp)[0].items()}
    cfg = W.train_cfgs()["vicuna-7b"]
    tp, step = T.load_checkpoint(path, M.init_params(cfg, device="meta"), device="cpu")
    assert step == 3
    port = W.flat(tp)
    specs = _specs("vicuna-7b", mesh)
    want = _reference("vicuna-7b")[3]
    for k, a in port.items():
        np.testing.assert_array_equal(a.numpy(), ref[k])
        assert np.abs(ref[k] - want[k]).max() <= 1e-5, k
        for coords, rec in ranks:
            np.testing.assert_array_equal(rec["vicuna-7b"]["params"][k].numpy(),
                                          _shard(ref[k], specs[k], mesh, coords))
    # load_checkpoint(mesh=) cuts each rank's shards of params and moments
    tree = SH.train_specs(cfg, mesh, min_dim=W.TRAIN_MIN_DIM)
    for coords, rec in ranks:
        mesh.coords = coords
        lp, lo, _ = T.load_checkpoint(path, M.init_params(cfg, device="meta"),
                                      T.adamw_init(M.init_params(cfg, device="meta")),
                                      device="cpu", mesh=mesh, specs=tree)
        for k, a in W.flat(lp).items():
            assert torch.equal(a, rec["vicuna-7b"]["params"][k]), k
        mu = {k: np.asarray(v) for k, v in _flatten_with_paths(ro.mu)[0].items()}
        for k, a in W.flat(lo.mu).items():
            np.testing.assert_array_equal(a.numpy(), _shard(mu[k], specs[k], mesh, coords))


def test_bridge_cuts_params_and_moments_by_the_training_specs():
    """``bridge.params_from_jax(specs=)`` and ``opt_state_from_jax`` give a
    rank's shards of the reference's params and AdamW state, the moments
    cut as their params (``opt_specs``)."""
    from repro_torch import bridge

    cfg = W.train_cfgs()["mamba2-130m"]
    jp = jax.tree.map(np.asarray, _j_params("mamba2-130m"))
    rng = np.random.default_rng(4)
    jo = JT.AdamWState(step=np.asarray(7, np.int32),
                       mu=jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp),
                       nu=jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), jp))
    mesh = Mesh((2, 2), ("data", "model"), shape_only=True)
    mesh.coords = {"data": 1, "model": 0}
    tree = SH.train_specs(cfg, mesh, min_dim=W.TRAIN_MIN_DIM)
    specs = SH.specs_by_key(tree)
    p = bridge.params_from_jax(jp, device="cpu", cfg=cfg, mesh=mesh, specs=tree)
    o = bridge.opt_state_from_jax(jo, device="cpu", cfg=cfg, mesh=mesh, specs=tree)
    assert int(o.step) == 7 and o.step.dtype == torch.int32
    for name, port, ref in (("params", p, jp), ("mu", o.mu, jo.mu), ("nu", o.nu, jo.nu)):
        want = {k: np.asarray(v) for k, v in _flatten_with_paths(ref)[0].items()}
        got = W.flat(port)
        assert got.keys() == want.keys()
        for k, a in got.items():
            np.testing.assert_array_equal(a.numpy(), _shard(want[k], specs[k], mesh, mesh.coords))
    assert sum("data" in SH.spec_axes(s) for s in specs.values()) > 0


def test_train_cli_over_a_spawned_mesh(capfd):
    argv = ["--device", "cpu", "--reduced", "--steps", "3"]
    train.main(argv)
    one = capfd.readouterr().out.strip().splitlines()
    train.main(argv + ["--mesh", "data=2,model=2", "--spawn"])
    four = capfd.readouterr().out.strip().splitlines()
    assert len(one) == len(four) == 4
    assert one[:3] == four[:3] and one[0].startswith("step    0 ce=")


def test_spawn_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(W.nccl_capture_rank, 1, ("unused",))


def test_one_rank_mesh_steps_are_the_one_device_steps(tmp_path):
    """Two train steps on a data=1,model=1 mesh (a gloo group of one in
    this process) bitwise the one-device steps: a one-rank all-reduce is
    the identity, and the step adds no arithmetic of its own."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models import shard_utils as SU

    cfg = W.VICUNA
    batches = W.step_batches(cfg, 2)

    def run(mesh):
        specs = None if mesh is None else SH.train_specs(cfg, mesh, min_dim=W.TRAIN_MIN_DIM)
        p = M.init_params(cfg, 0, device="cpu", mesh=mesh, specs=specs)
        opt, out = T.adamw_init(p), []
        step = T.make_train_step(cfg, **W.TRAIN_STEP_KW)
        with SU.use_mesh(mesh):
            for b in batches:
                p, opt, m = step(p, opt, b)
                out.append({k: float(v) for k, v in m.items()})
        return W.flat(p), out

    init_distributed("gloo", rank=0, world=1, init_method=f"file://{tmp_path}/store")
    try:
        mesh = Mesh((1, 1), ("data", "model"), device="cpu")
        got, got_m = run(mesh)
    finally:
        dist.destroy_process_group()
    want, want_m = run(None)
    assert got_m == want_m
    for k, a in want.items():
        assert torch.equal(got[k], a), k
