"""The ranks of the port's mesh tests: JAX-free bodies that run in the
processes ``repro_torch.launch.mesh.spawn`` starts (``gloo``), each saving
its results with ``torch.save`` for the test process to read.

Used by ``tests/test_torch_mesh.py``, ``tests/test_torch_mesh_server.py``
(on the CPU) and the ``cuda``-marked cases of ``tests/test_torch_on_card.py``
(two ranks sharing the card), so it imports neither JAX nor the reference.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.core import layer_sparsity
from repro_torch.core.engine import fake_quant_int8
from repro_torch.kernels.int8_matmul import quantize_rows
from repro_torch.kernels.ops import prequantize, quantized_matmul
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, parse_mesh_spec
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models import shard_utils as SU
from repro_torch.serving import BatchedSpecServer

VICUNA = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
SERVE_CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=3)
GEMMA = get_config("gemma3-1b").reduced()
MOE = get_config("qwen2-moe-a2.7b").reduced()
MAMBA = get_config("mamba2-130m").reduced()
MODES = ("chain_fused", "legacy", "tree_fused", "cascade_fused")


def mesh_of(spec: str, device) -> Mesh:
    sizes = parse_mesh_spec(spec)
    return Mesh(tuple(sizes.values()), tuple(sizes), device=device)


def prompts(cfg, lengths=(8, 12, 6, 10), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


# ------------------------------------------------------------------ model
def decode_logits(cfg, params, device, mesh=None, B=2, S=64, T=5):
    """Prefill 11 tokens a slot, decode T under a chain mask, commit a
    ragged prefix and decode 2 more: the three calls' logits (numpy)."""
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, 11)), device=device)
    t2 = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, T)), device=device)
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=device))
    with SU.use_mesh(mesh):
        cache = M.init_cache(cfg, B, S, device=device, mesh=mesh)
        l1, _ = M.prefill(cfg, params, {"tokens": toks}, cache)
        l2, st = M.decode_step(cfg, params, cache, t2, tree_mask=mask)
        M.commit_cache(cfg, cache, st, torch.arange(T, device=device)[None].expand(B, T),
                       torch.tensor([3, T][:B], device=device))
        l3, _ = M.decode_step(cfg, params, cache, t2[:, :2])
    return [x.float().cpu().numpy() for x in (l1, l2, l3)]


def attention_case(B=2, T=5, S=64, H=4, KV=1, hd=64, seed=1):
    """One decode_attention's inputs (numpy): a 5-node tree over committed
    prefixes of 37 and 50 slots, some of them in each half of the cache."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tm = np.tril(np.ones((T, T), bool))
    tm[3, 2] = tm[4, 2] = tm[4, 3] = False
    pos = np.array([37, 50][:B], np.int32)
    return dict(q=f(B, T, H, hd), k=f(B, S, KV, hd), v=f(B, S, KV, hd), pos=pos,
                kn=f(B, T, KV, hd), vn=f(B, T, KV, hd),
                q_pos=(pos[:, None] + np.array([0, 1, 1, 2, 2])[None, :T]).astype(np.int32),
                tm=tm)


def run_attention(case, device, mesh=None, seq_axes=None, kind="causal", window=0):
    """``decode_attention`` of ``case``; on a mesh with ``seq_axes`` this
    rank holds its sequence slice of the cache."""
    t = {k: torch.as_tensor(v, device=device) for k, v in case.items()}
    k, v = t["k"], t["v"]
    n, i = 1, 0
    with SU.use_mesh(mesh):
        if mesh is not None and seq_axes:
            n, i = mesh.axis_size(seq_axes), mesh.index(seq_axes)
        S = k.shape[1] // n
        out = attn.decode_attention(t["q"], k[:, i * S:(i + 1) * S], v[:, i * S:(i + 1) * S],
                                    t["pos"], t["kn"], t["vn"], t["q_pos"], tree_mask=t["tm"],
                                    kind=kind, window=window, seq_axes=seq_axes)
    return out.cpu().numpy()


def int8_checks(mesh, device, seed=2):
    """The int8 bank's numbers on shards against the unsharded ones: a
    row-parallel weight's int8 rows and column scales, the activation's
    row scales and int8 columns, the int32 products (their sum over the
    ranks), the float partial products, and the sim path's fake-quantized
    leaves. Returns {name: bool or float}."""
    rng = np.random.default_rng(seed)
    K, N, Mrows = 512, 256, 6
    w = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32), device=device)
    x = torch.as_tensor(rng.standard_normal((Mrows, K)).astype(np.float32), device=device)
    n, i = mesh.shape["model"], mesh.index("model")
    Kl = K // n
    rows = slice(i * Kl, (i + 1) * Kl)
    full_w = prequantize(w)
    full_xq, full_xs = quantize_rows(x)
    with SU.use_mesh(mesh):
        shard_w = prequantize(w[rows].contiguous(), k_axes="model")
        xq, xs = quantize_rows(x[:, rows].contiguous(), lambda a: SU.all_max(a, "model"))
        part = quantized_matmul(x[:, rows].contiguous(), shard_w, k_axes="model")
        summed = SU.all_sum(part.clone())
        i32 = SU.all_sum(xq.int().cpu() @ shard_w.w_q.int().cpu())
        sim_full = fake_quant_int8(M.init_params(VICUNA, 0, device=device))
        params = M.init_params(VICUNA, 0, device=device, mesh=mesh)
        sim_local = fake_quant_int8(params, cfg=VICUNA)
    want_local = SH.local_shard(sim_full, SH.param_specs(VICUNA, mesh), mesh)
    sim_equal = all(torch.equal(a, b) for a, b in zip(M.tree_leaves(sim_local),
                                                      M.tree_leaves(want_local)))
    full = quantized_matmul(x, full_w)
    return {
        "w_q": torch.equal(shard_w.w_q, full_w.w_q[rows]),
        "w_scale": torch.equal(shard_w.ws, full_w.ws),
        "x_q": torch.equal(xq, full_xq[:, rows]),
        "x_scale": torch.equal(xs, full_xs),
        "int32": torch.equal(i32, full_xq.int().cpu() @ full_w.w_q.int().cpu()),
        "product_err": float((summed - full).abs().max() / full.abs().max()),
        "sim": sim_equal,
    }


def serve_streams(cfg, params, mode, device, mesh=None, *, paged=False, rounds=6, B=4,
                  round_mode="auto"):
    """Admit four prompts, run ``rounds`` rounds and flush: (streams per
    slot, round dispatches, host syncs, steps). The split rounds' cost
    trackers stay at their priors (they observe the wall clock, which
    would make two runs plan different budgets and routes)."""
    kw = dict(max_batch=B, max_len=128, draft_k=4, tree_expansions=3, adaptive=True,
              min_obs=1, device=device, round_mode=round_mode)
    if paged:
        kw.update(paged=True, page_size=16)
    if mode != "cascade_fused":
        kw["draft_spec"] = layer_sparsity(cfg, 0.5)
    srv = BatchedSpecServer(cfg, params, mode=mode, mesh=mesh, **kw)
    srv.costs.observe = lambda *a, **k: None
    srv.costs.observe_target = lambda *a, **k: None
    for b, p in enumerate(prompts(cfg)[:B]):
        srv.add_request(b, p)
    gen = {b: [] for b in range(B)}
    for _ in range(rounds):
        for b, t in srv.step().items():
            gen[b].extend(t)
    for b, t in srv.flush().items():
        gen[b].extend(t)
    s = srv.stats
    return gen, (s["round_dispatches"], s["host_syncs"], s["steps"])


# ------------------------------------------------------------ rank bodies
def model_rank(rank, world, spec, inputs, out_dir):
    """Every model-level check of one rank of ``spec`` (CPU, gloo)."""
    os.nice(10)          # yield the cores to the suite's timing-sensitive tests
    mesh = mesh_of(spec, "cpu")
    res = {}
    vic = bridge.params_from_jax(inputs["vicuna_params"], device="cpu", cfg=VICUNA, mesh=mesh)
    gem = M.init_params(GEMMA, 0, device="cpu", mesh=mesh)
    res["vicuna_logits"] = decode_logits(VICUNA, vic, "cpu", mesh)
    res["gemma_logits"] = decode_logits(GEMMA, gem, "cpu", mesh)
    case = inputs["attention_case"]
    res["cp_causal"] = run_attention(case, "cpu", mesh, ("model",))
    res["cp_window"] = run_attention(case, "cpu", mesh, ("model",), kind="window", window=24)
    res["int8"] = int8_checks(mesh, "cpu")
    for name, cfg in (("moe", MOE), ("mamba", MAMBA)):
        p = M.init_params(cfg, 0, device="cpu", mesh=mesh)
        res[name] = serve_streams(cfg, p, "chain_fused", "cpu", mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def server_rank(rank, world, spec, inputs, out_dir):
    """Every mode of the batched server on one rank of ``spec``, dense, and
    ``tree_fused`` / ``chain_fused`` paged (CPU, gloo)."""
    os.nice(10)          # yield the cores to the suite's timing-sensitive tests
    mesh = mesh_of(spec, "cpu")
    params = bridge.params_from_jax(inputs["params"], device="cpu", cfg=SERVE_CFG, mesh=mesh)
    res = {m: serve_streams(SERVE_CFG, params, m, "cpu", mesh) for m in MODES}
    for m in ("chain_fused", "tree_fused"):
        res[m + " paged"] = serve_streams(SERVE_CFG, params, m, "cpu", mesh, paged=True)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def card_rank(rank, world, spec, inputs, out_dir):
    """Two ranks sharing the card over gloo: vicuna's decode_step logits and
    the context-parallel decode_attention (kernels #1 and #2)."""
    dev = torch.device("cuda", 0)
    mesh = mesh_of(spec, dev)
    params = M.init_params(VICUNA, 0, device=dev, mesh=mesh)
    res = {"logits": decode_logits(VICUNA, params, dev, mesh),
           "cp": run_attention(inputs["attention_case"], dev, mesh, ("model",))}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def nccl_capture_rank(rank, world, out_dir):
    """A one-rank NCCL group: an all_reduce captured in a CUDA graph
    between a copy and a scale, replayed after its input changed."""
    import torch.distributed as dist

    a = torch.arange(8, dtype=torch.float32, device="cuda")
    b = torch.zeros(8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        b.copy_(a)
        dist.all_reduce(b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        b.copy_(a)
        dist.all_reduce(b)
        b.mul_(2)
    a.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    torch.save(b.cpu(), os.path.join(out_dir, "replayed.pt"))


# ---------------------------------------------------------------- training
TRAIN_MIN_DIM = 128      # fsdp_upgrade's min_dim at the reduced widths (d 256)
TRAIN_STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10, remat=False)


def train_cfgs():
    """The training variants of the mesh tests: name -> port config."""
    moe2 = dataclasses.replace(MOE, moe=dataclasses.replace(MOE.moe, exec_groups=2))
    return {"vicuna-7b": VICUNA, "gemma3-1b": GEMMA, "qwen2-moe-a2.7b": MOE,
            "qwen2-moe-a2.7b groups 2": moe2, "mamba2-130m": MAMBA}


def train_batch(cfg, B=4, S=24, seed=3):
    """The loss and gradient checks' batch: tokens and a loss mask."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
            "loss_mask": (rng.random((B, S - 1)) < 0.6).astype(np.int32)}


def step_batches(cfg, n=3):
    from repro_torch.data import lm_batches, synthetic_corpus

    it = lm_batches(synthetic_corpus(cfg.vocab_size, 5_000), 4, 32)
    return [next(it) for _ in range(n)]


def rows_of(batch, mesh):
    """This rank's rows of a global batch (the data axes' share)."""
    D, i = mesh.axis_size(SU.DATA_AXES), mesh.index(SU.DATA_AXES)
    return {k: v[i * len(v) // D:(i + 1) * len(v) // D] for k, v in batch.items()}


def flat(tree) -> dict:
    """{checkpoint key: leaf} of a tree."""
    from repro_torch.training.checkpoint import map_with_path

    out = {}
    map_with_path(lambda k, t: out.__setitem__(k, t), tree)
    return out


def capacity_case(moe, N=24, seed=5):
    """Top-k expert ids (N, K) for the slot-table check, skewed to the
    first expert so that its pairs overflow the capacity."""
    rng = np.random.default_rng(seed)
    p = np.full(moe.num_experts, 1.0)
    p[0] = 3.0 * moe.num_experts
    return np.stack([rng.choice(moe.num_experts, moe.top_k, replace=False, p=p / p.sum())
                     for _ in range(N)])


def train_rank(rank, world, spec, inputs, out_dir):
    """Every training check of one rank of ``spec`` (CPU, gloo): per
    variant the loss, the gradients (remat on) and three train steps on
    this rank's rows and shards (``train_specs`` at ``TRAIN_MIN_DIM``),
    the bytes the step passed to ``all_reduce``; the capacity slot table
    on the data axes; at data=2,model=2 a checkpoint of the trained
    vicuna."""
    from repro_torch import training as T
    from repro_torch.models import moe as moe_lib
    from repro_torch.training.train_step import loss_and_grads

    os.nice(10)          # yield the cores to the suite's timing-sensitive tests
    mesh = mesh_of(spec, "cpu")
    res = {}
    for name, cfg in train_cfgs().items():
        specs = SH.train_specs(cfg, mesh, min_dim=TRAIN_MIN_DIM)
        jp = inputs["params"][name]
        r = {"fsdp_leaves": sum("data" in SH.spec_axes(s)
                                for s in SH.specs_by_key(specs).values())}
        with SU.use_mesh(mesh):
            p = bridge.params_from_jax(jp, device="cpu", cfg=cfg, mesh=mesh, specs=specs)
            SU.reset_counter()
            _, met, grads = loss_and_grads(cfg, p, rows_of(train_batch(cfg), mesh), remat=True)
            r["grad_bytes"] = SU.COUNTER["bytes"]
            r["loss"] = {k: float(v) for k, v in met.items()}
            r["grads"] = dict(zip(flat(p), grads))
            step = T.make_train_step(cfg, **TRAIN_STEP_KW)
            opt = T.adamw_init(p)
            r["steps"] = []
            for i, b in enumerate(step_batches(cfg)):
                SU.reset_counter()
                p, opt, m = step(p, opt, rows_of(b, mesh))
                if i == 0:
                    r["step_bytes"] = SU.COUNTER["bytes"]
                r["steps"].append({k: float(v) for k, v in m.items()})
            r["params"] = flat(p)
            if name == "vicuna-7b" and spec == "data=2,model=2":
                T.save_checkpoint(os.path.join(out_dir, "ckpt"), p, opt, step=3, mesh=mesh,
                                  cfg=cfg)
        res[name] = r
    ids = capacity_case(MOE.moe)
    res["slots"] = {}
    for groups in (1, 2):
        moe = dataclasses.replace(MOE.moe, exec_groups=groups)
        with SU.use_mesh(mesh):
            local = torch.as_tensor(rows_of({"ids": ids}, mesh)["ids"])
            slot, keep, C = moe_lib.capacity_slots(local, moe, moe.capacity_factor, over_data=True)
        res["slots"][groups] = (slot.reshape(-1), keep.reshape(-1), C)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def card_train_rank(rank, world, spec, out_dir):
    """Two ranks sharing the card over gloo: two train steps of vicuna
    (reduced, 4 layers, FSDP at ``TRAIN_MIN_DIM``) on this rank's rows (the
    second applies an update: the warm-up gives step 0 a learning rate of
    0); the metrics of each step, the params and the moments."""
    from repro_torch import training as T

    dev = torch.device("cuda", 0)
    mesh = mesh_of(spec, dev)
    specs = SH.train_specs(VICUNA, mesh, min_dim=TRAIN_MIN_DIM)
    metrics = []
    with SU.use_mesh(mesh):
        p = M.init_params(VICUNA, 0, device=dev, mesh=mesh, specs=specs)
        opt = T.adamw_init(p)
        step = T.make_train_step(VICUNA, **TRAIN_STEP_KW)
        for b in step_batches(VICUNA, 2):
            b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            p, opt, m = step(p, opt, rows_of(b, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"metrics": metrics, "specs": specs,
                "leaves": {k: v.cpu() for k, v in flat({"p": p, "mu": opt.mu, "nu": opt.nu}).items()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
