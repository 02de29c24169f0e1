"""The port's analysis layer (``repro_torch.analysis``, the latency
predictors of ``repro_torch.core.latency``) against the JAX reference's, on
the CPU.

Roofline: bottleneck selection and feature units at the H100's constants;
the port's terms times its constants equal the reference's terms times the
reference's (the same seconds of work, whatever the chip); the bounds the
four TPU kernels' counterparts had in ``chip_smoke.py``'s kernels line
before it counted through ``analysis.costs`` come out of it to 1e-12. BLR:
on the same 200 seeded observations the port's weights and predictions
equal the reference's within 1e-12 (both float64 numpy). Costs:
``model_flops_per_step`` equals the reference's for all eleven configs and
every kind; the counted
parameter bytes equal what ``init_params(device="meta")`` allocates at full
width; the traffic rule equals ``launch/dryrun.py::_analytic_traffic``; the
GEMM FLOPs of a 4-layer reduced vicuna ``decode_step`` equal
``FlopCounterMode``'s ``mm`` count exactly; a bfloat16 head counts each
byte once, at the bfloat16 peak. Contracts: every assertion passes on a
good node list and raises ``ContractViolation`` on a bad one (a copy of
the cache by memcpy nodes, kept or dropped, among them);
split and cascade servers, and a single-round server without a captured
graph (the CPU), raise; the reference's single-round ``tree_fused`` server
compiles one executable a round, and the port's launches one graph. Lint:
one bad and one good fixture a rule, a waiver without a reason, the port's
tree lints clean.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.analysis.contracts import server_round_contracts as j_round_contracts  # noqa: E402
from repro.analysis.report import model_flops_per_step as j_model_flops  # noqa: E402
from repro.config import get_config as j_get_config  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.dsia import layer_sparsity as j_layer_sparsity  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import BatchedSpecServer as JServer  # noqa: E402
from repro_torch.analysis import costs as C  # noqa: E402
from repro_torch.analysis import contracts as K  # noqa: E402
from repro_torch.analysis import lint as L  # noqa: E402
from repro_torch.analysis import roofline as R  # noqa: E402
from repro_torch.config import get_config, list_configs  # noqa: E402
from repro_torch.core import latency  # noqa: E402
from repro_torch.core.dsia import layer_sparsity  # noqa: E402
from repro_torch.kernels.graph_cond import GraphNode, parse_walk  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import BatchedSpecServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ roofline
def test_roofline_bottleneck_selection():
    r = R.RooflineReport("x", flops=989e12, bytes_hbm=1.0, coll_bytes={}, dtype="bfloat16")
    assert r.bottleneck == "compute" and r.t_compute == pytest.approx(1.0)
    r32 = R.RooflineReport("x32", flops=67e12, bytes_hbm=1.0, coll_bytes={}, dtype="float32")
    assert r32.bottleneck == "compute" and r32.t_compute == pytest.approx(1.0)
    r2 = R.RooflineReport("y", flops=1.0, bytes_hbm=3.35e12, coll_bytes={})
    assert r2.bottleneck == "memory" and r2.t_memory == pytest.approx(1.0)
    r3 = R.RooflineReport("z", flops=1.0, bytes_hbm=1.0, coll_bytes={"all-reduce": int(450e9)})
    assert r3.bottleneck == "collective" and r3.t_collective == pytest.approx(1.0)
    assert r2.t_bound == pytest.approx(1.0) and r2.share(2000.0) == pytest.approx(0.5)
    assert set(r.to_dict()) >= {"flops", "bytes_hbm", "coll_bytes", "peak_memory", "bytes_analytic",
                                "t_compute", "t_memory", "t_collective", "bottleneck"}


def test_roofline_features_units():
    f = latency.roofline_features(989e12, 3.35e12, 450e9)
    assert f == [1.0, pytest.approx(1.0), pytest.approx(1.0), pytest.approx(1.0)]
    assert latency.roofline_features(67e12, 0, 0, dtype="float32")[1] == pytest.approx(1.0)
    assert latency.roofline_features(1979e12, 0, 0, dtype="int8")[1] == pytest.approx(1.0)
    assert latency.roofline_features(495e12, 0, 0, dtype=torch.float32)[1] == pytest.approx(
        495 / 67)


@pytest.mark.parametrize("work", [(1e12, 2e9, 0.0), (3e9, 5e11, 4e8), (7e14, 1e6, 9e10)])
def test_roofline_terms_times_constants_equal_the_reference(work):
    """Each term is seconds of work at one chip's rate: times that rate it
    is the work itself, the same for the port's H100 and the reference's
    TPU v5e."""
    ours = np.array(latency.roofline_features(*work)) * [1, 989e12, R.HBM_BW, R.NVLINK_BW]
    ref = np.array(jlat.roofline_features(*work)) * [1, jlat.PEAK_FLOPS, jlat.HBM_BW, jlat.ICI_BW]
    np.testing.assert_allclose(ours, ref, rtol=1e-12)
    assert latency.roofline_latency(*work) == pytest.approx(max(ours[1:] / [989e12, R.HBM_BW,
                                                                          R.NVLINK_BW]))


def test_bound_ms_and_the_kernels_bounds():
    """``RooflineReport.bound_ms`` picks the larger term; the four TPU kernels' bounds as
    ``chip_smoke.py``'s kernels line printed them before it counted
    through ``analysis.costs`` (float32): flash decode merge
    at S=160, tree attention at T=32, W8A8 at M=32 and the paged merge at
    T=16 over 4 pages of 64 with 544 live rows."""
    assert R.RooflineReport.of("b", 1.0, 3.35e9, "float32").bound_ms() == (pytest.approx(1.0),
                                                                           "bytes")
    assert R.RooflineReport.of("o", 989e9, 1.0, "bfloat16").bound_ms() == (pytest.approx(1.0),
                                                                           "operations")
    cases = [
        (C.flash_decode(1, 32, 32, 128, 160, "float32", merge=True), 0.0020372250746268656),
        (C.tree_attention(1, 32, 32, 32, 128, "float32"), 0.0006287665671641791),
        (C.int8_matmul(32, 4096, 11008), 0.013932245970149254),
        (C.flash_decode(4, 32, 16, 128, 256, "float32", live=544, merge=True, pages=4),
         0.006266364179104478),
    ]
    for cost, ms in cases:
        got, by = cost.bound_ms()
        assert by == "bytes" and got == pytest.approx(ms, rel=1e-12), cost.name


def test_analyze_call_on_the_cpu():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    rep = R.analyze_call("mm", torch.matmul, a, b, dtype="float32", device="cpu")
    assert rep.peak_memory is None and rep.flops == rep.flops_counted == 2 * 8 * 16 * 4
    assert rep.bytes_hbm == 4 * (8 * 16 + 16 * 4 + 8 * 4) and rep.bottleneck == "memory"


# ----------------------------------------------------------------------- BLR
def test_blr_equals_the_reference():
    rng = np.random.default_rng(0)
    w_true = np.array([0.5, 2.0, 1.0, 3.0])
    ours = latency.BayesianLinearLatency(dim=4, noise=1e-4)
    ref = jlat.BayesianLinearLatency(dim=4, noise=1e-4)
    for _ in range(200):
        x = np.concatenate([[1.0], rng.random(3)])
        t = float(w_true @ x) + rng.normal(0, 1e-3)
        ours.observe(x, t)
        ref.observe(x, t)
    np.testing.assert_allclose(ours.weights, ref.weights, rtol=0, atol=1e-12)
    assert np.allclose(ours.weights, w_true, atol=0.05)
    for q in ([1.0, 0.5, 0.5, 0.5], [1.0, 0.1, 0.9, 0.0]):
        (m1, v1), (m2, v2) = ours.predict_with_var(q), ref.predict_with_var(q)
        assert abs(m1 - m2) <= 1e-12 and abs(v1 - v2) <= 1e-12 and v1 > 0


# --------------------------------------------------------------------- costs
@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_model_flops_and_param_bytes(arch):
    """MODEL_FLOPS as the reference's for every kind, and the parameter
    bytes as ``init_params`` allocates them at full width (meta tensors)."""
    assert sorted(list_configs()) == sorted(j_get_config(a).name for a in list_configs())
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32), ("decode", 32768, 128),
                             ("decode", 512, 4)):
        assert C.model_flops_per_step(arch, kind, seq, batch) == j_model_flops(arch, kind, seq,
                                                                               batch)
    assert C.param_count(get_config(arch)) == j_get_config(arch).param_count()
    cfg = get_config(arch)
    meta = M.init_params(cfg, device="meta")
    assert C.param_bytes(cfg) == sum(t.numel() * t.element_size() for t in M.tree_leaves(meta))


def test_traffic_rule_equals_the_reference():
    jax.devices()                       # the backend is up: dryrun's XLA_FLAGS change nothing
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _analytic_traffic
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for kind in ("decode", "prefill", "train"):
        for p, c, a in ((13.5e9, 2.1e9, 0.3e9), (1.0, 0.0, 7.0), (4.4e10, 8e8, 1e6)):
            assert C.analytic_traffic(kind, p, c, a) == _analytic_traffic(kind, p, c, a)


def test_decode_step_gemm_flops_equal_the_flop_counter():
    """The weight GEMMs and the unembedding of ``costs.decode_step`` are the
    ``mm`` FLOPs ``FlopCounterMode`` counts in one ``decode_step`` on the
    CPU (4 layers of reduced vicuna-7b, B=2, T=3 over 20 committed slots)."""
    cfg = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
    params = M.init_params(cfg, 0, device="cpu")
    cache = M.init_cache(cfg, 2, 64, device="cpu")
    cache["pos"].fill_(20)
    tokens = torch.tensor([[5, 6, 7], [8, 9, 10]])
    _, counted = C.count_flops(M.decode_step, cfg, params, cache, tokens)
    gemms = sum(g.flops for i in range(cfg.num_layers) for g in C.layer_gemms(cfg, i, 6))
    assert counted["mm"] == gemms + C.unembed(cfg, 6).flops
    step = C.decode_step(cfg, 2, 3, 20)
    assert step.flops == gemms + C.unembed(cfg, 6).flops + 4 * cfg.resolved_head_dim() * \
        cfg.num_heads * cfg.num_layers * (3 * 2 * 20 + 2 * 6)
    # half the layers (slice exec) reads half the layers' weights
    half = C.decode_step(cfg, 2, 3, 20, layers=[0, 2])
    assert half.flops < step.flops and half.bytes_hbm < step.bytes_hbm


@pytest.mark.parametrize("call", ["prefill", "forward_train"])
def test_prefill_and_train_gemm_flops_equal_the_flop_counter(call):
    """The weight GEMMs and the head of ``costs.prefill`` (the last
    position's logits) and ``costs.forward_train`` (every position's) are
    the ``mm`` FLOPs ``FlopCounterMode`` counts in one call on the CPU (4
    layers of reduced vicuna-7b, B=2, S=12)."""
    cfg = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=4)
    params = M.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.arange(24).reshape(2, 12) % cfg.vocab_size}
    if call == "prefill":
        _, counted = C.count_flops(M.prefill, cfg, params, batch, M.init_cache(cfg, 2, 16,
                                                                                 device="cpu"))
        head = C.unembed(cfg, 2)
    else:
        _, counted = C.count_flops(M.forward_train, cfg, params, batch, remat=False)
        head = C.unembed(cfg, 24)
    gemms = sum(g.flops for i in range(cfg.num_layers) for g in C.layer_gemms(cfg, i, 24))
    cost = getattr(C, call)(cfg, 2, 12)
    assert counted["mm"] == gemms + head.flops
    assert cost.flops == gemms + head.flops + 4 * cfg.resolved_head_dim() * cfg.num_heads * \
        cfg.num_layers * 2 * (12 * 13 // 2)


def test_layer_costs_at_vicuna_width():
    """One vicuna-7b layer holds 202.4 M matmul parameters, 809.5 MB in
    float32; a float32 GEMM turns operations-bound near M = 40, bfloat16
    near M = 295; the head is counted as the function needs it (its
    float32 upcast is the implementation's)."""
    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="float32")
    gem = C.layer_gemms(cfg, 0, 1)
    assert [g.name for g in gem] == ["q", "k", "v", "o", "gate", "up", "down"]
    assert sum(g.flops for g in gem) / 2 == 202_375_168
    assert C.layer_param_bytes(cfg, 0) == 4 * 202_375_168 + 2 * 4 * 4096
    for dt, lo, hi in (("float32", 40, 64), ("bfloat16", 300, 400)):
        assert C.gemm("up", lo, 4096, 11008, dt).bound_by == "bytes"
        assert C.gemm("up", hi, 4096, 11008, dt).bound_by == "operations"
    w = cfg.d_model * cfg.padded_vocab
    assert C.unembed(cfg, 1).bytes_hbm == 4 * w + 4 * 4096 + 4 * 32000
    bf = C.unembed(dataclasses.replace(cfg, dtype="bfloat16"), 1)
    assert bf.bytes_hbm == 2 * w + 2 * 4096 + 4 * 32000 and bf.dtype == "bfloat16"
    w8 = C.layer_gemms(cfg, 0, 4, quantize="int8")[4]
    assert w8.dtype == "int8" and w8.bytes_hbm == 4 * 4 * 4096 + 4 * 4096 * 11008 + 4 * 4 * 11008
    bank = C.gemm("up", 4, 4096, 11008, "float32", quantize="int8", prequantized=True)
    assert bank.bytes_hbm == 4 * 4 * 4096 + 4096 * 11008 + 4 * 11008 + 4 * 4 * 11008


@pytest.mark.parametrize("M", [1, 16, 128])
def test_bfloat16_unembed_counts_each_byte_once(M):
    """A bfloat16 head over M rows moves d*V*2 + M*d*2 + M*V*4 bytes (the
    head and x read once, the float32 logits written once) and runs its
    products at the bfloat16 peak; a whole bfloat16 ``decode_step`` holds
    that head, not its float32 upcast."""
    cfg = dataclasses.replace(get_config("vicuna-7b"), dtype="bfloat16")
    d, V = cfg.d_model, cfg.padded_vocab
    head = C.unembed(cfg, M)
    assert head.bytes_hbm == d * V * 2 + M * d * 2 + M * V * 4
    assert head.dtype == "bfloat16" and head.t_compute == pytest.approx(2 * M * d * V / 989e12)
    one = dataclasses.replace(cfg, num_layers=1)
    step = C.decode_step(one, 1, M, 0)
    layer = C.layer_param_bytes(one, 0) + 2 * M * one.num_kv_heads * one.resolved_head_dim() * 2
    assert step.bytes_hbm == M * (4 + d * 2) + layer + 2 * M * d * 2 + head.bytes_hbm


# ----------------------------------------------------------------- contracts
SET_COND = "(anonymous namespace)::set_cond(unsigned long long, void const*, int)"
SPLIT = "void (anonymous namespace)::split_kernel<float, 128, 16>(float const*)"
COMBINE = "void (anonymous namespace)::combine_kernel(float const*)"
TREE = "void (anonymous namespace)::tree_kernel<float, 128>(float const*)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32"
SEGMENTS = (("prologue", False), ("draft", True), ("tail", False))
LAUNCHES = {"prologue": {"flash_decode": 0, "tree_attention": 0, "set_cond": 0},
            "draft": {"flash_decode": 1, "tree_attention": 1, "set_cond": 0},
            "tail": {"flash_decode": 1, "tree_attention": 1, "set_cond": 0}}


def _nodes(tail_extra=(), prologue_extra=(), draft_gated=True):
    n = [GraphNode(0, 0, False, "child", ""), GraphNode(0, 1, False, "kernel", ELEM),
         GraphNode(0, 1, False, "memcpy", "DtoD")] + [GraphNode(0, 1, False, *e)
                                                       for e in prologue_extra]
    if draft_gated:
        n += [GraphNode(1, 0, False, "kernel", SET_COND),
              GraphNode(2, 0, False, "conditional", ""), GraphNode(2, 1, True, "child", "")]
        at, depth = 2, 2
    else:
        n += [GraphNode(1, 0, False, "child", "")]
        at, depth = 1, 1
    n += [GraphNode(at, depth, draft_gated, "kernel", x) for x in (GEMM, SPLIT, COMBINE, TREE)]
    t = at + 1
    n += [GraphNode(t, 0, False, "child", "")] + [
        GraphNode(t, 1, False, "kernel", x) for x in (GEMM, TREE, SPLIT, COMBINE, ELEM)]
    n += [GraphNode(t, 1, False, *e) for e in tail_extra]
    return tuple(n)


def _contract(nodes, segments=SEGMENTS):
    return K.GraphContract("round", nodes, segments)


def _all(con):
    return (con.assert_no_host_callbacks().assert_no_host_transfers().assert_gated()
            .assert_segment_launches(LAUNCHES).assert_no_collectives())


def test_contract_holds_on_a_good_graph():
    con = _all(_contract(_nodes()))
    assert con.n_if == 1 and con.unresolved == 0
    assert con.kernel_counts() == {"flash_decode": 2, "tree_attention": 2, "combine": 2,
                                   "set_cond": 1}
    assert con.node_counts == {"kernel": 11, "memcpy": 1}
    assert con.summary()["if"] == 1


@pytest.mark.parametrize("case", ["host", "dtoh", "htod", "ungated", "extra_kernel", "no_combine",
                                  "nccl", "top_level"])
def test_contract_violations_raise(case):
    nodes, segments = _nodes(), SEGMENTS
    if case == "host":
        nodes = _nodes(tail_extra=[("host", "")])
    elif case == "dtoh":
        nodes = _nodes(tail_extra=[("memcpy", "DtoH")])
    elif case == "htod":
        nodes = _nodes(prologue_extra=[("memcpy", "HtoD")])
    elif case == "ungated":
        nodes = _nodes(draft_gated=False)
    elif case == "extra_kernel":
        nodes = _nodes(tail_extra=[("kernel", TREE)])
    elif case == "no_combine":
        nodes = tuple(n for n in _nodes() if not (n.top == 3 and n.name == COMBINE))
    elif case == "nccl":
        nodes = _nodes(tail_extra=[("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(int)")])
    elif case == "top_level":
        nodes = _nodes() + (GraphNode(4, 0, False, "kernel", ELEM),)
    with pytest.raises(K.ContractViolation):
        _all(_contract(nodes, segments))


def test_donation_contract():
    """Storage unchanged since the capture, and what the capture left live
    in the pool below the cache's bytes; the server records (address,
    bytes) of every cache and ``dstate`` tensor."""
    ptrs = {"cache['k']": (1000, 512), "cache['pos']": (4000, 8), "dstate['live']": (2000, 2)}
    K.assert_donated(ptrs, dict(ptrs), live_bytes=0)
    K.assert_donated(ptrs, dict(ptrs), live_bytes=519)
    K.assert_donated(ptrs, dict(ptrs))
    with pytest.raises(K.ContractViolation, match="dstate"):
        K.assert_donated(ptrs, {**ptrs, "dstate['live']": (3000, 2)})
    with pytest.raises(K.ContractViolation, match="second copy"):
        K.assert_donated(ptrs, dict(ptrs), live_bytes=520)
    srv = _port_server("tree_fused", round_mode="single")
    got = srv.state_ptrs()
    assert sum(n for k, (_, n) in got.items() if k.startswith("cache")) == C.tensor_bytes(srv.cache)
    assert got["dstate['live']"] == (srv.dstate["live"].data_ptr(), srv.dstate["live"].nbytes)
    assert srv.graph_live_bytes == 0 and srv.segment_pool_bytes == {}


@pytest.mark.parametrize("case", ["clean", "kept", "dropped", "within", "half"])
def test_cache_copy_contract(case):
    """The round's memcpy nodes may read the cache a little and write into
    it, but copying as many bytes as it holds out of it (a second copy,
    kept or dropped within the round) raises."""
    cache = [(1 << 20, 4096), (2 << 20, 4096)]
    small = [("memcpy", "DtoD", 1 << 20, 9 << 20, 64), ("memcpy", "DtoD", 9 << 20, 2 << 20, 4096)]
    whole = [("memcpy", "DtoD", lo, (9 << 20) + lo, n) for lo, n in cache]
    extra = {"clean": small, "kept": small + whole, "dropped": whole,
             "within": [("memcpy", "DtoD", 1 << 20, 2 << 20, 4096)] * 2,
             "half": whole[:1]}[case]
    con = _contract(_nodes(tail_extra=extra))
    _all(con)
    if case in ("kept", "dropped"):
        assert con.cache_copy_bytes(cache) >= 8192
        with pytest.raises(K.ContractViolation, match="second copy"):
            con.assert_no_cache_copy(cache)
    else:
        assert con.cache_copy_bytes(cache) == {"clean": 64, "within": 0, "half": 4096}[case]
        con.assert_no_cache_copy(cache)


def test_telemetry_transparency():
    off = {"round": _contract(_nodes())}
    on = {"round": _contract(_nodes(tail_extra=[("kernel", ELEM)] * 14 + [("memset", "")]))}
    assert K.assert_telemetry_transparent(off, on) == {"kernel": 14, "memset": 1}
    bad = [
        {"round": _contract(_nodes(prologue_extra=[("kernel", ELEM)]))},     # outside the tail
        {"round": _contract(_nodes(tail_extra=[("host", "")]))},             # a host node
        {"round": _contract(_nodes(tail_extra=[("kernel", TREE)]))},         # a hand kernel
        {"other": _contract(_nodes())},                                       # the graph set
        {"round": _contract(_nodes(draft_gated=False),
                            (("prologue", False), ("draft", False), ("tail", False)))},
    ]
    for b in bad:
        with pytest.raises(K.ContractViolation):
            K.assert_telemetry_transparent(off, b)
    with pytest.raises(K.ContractViolation):                                 # tail nodes gone
        K.assert_telemetry_transparent(on, off)


def test_each_grouped_kernel_has_its_launch_count():
    """The float32 SIMT kernel of ``csrc/moe_grouped.cu`` is a
    ``moe_grouped`` node of a round and the bfloat16 tensor-core kernel a
    ``moe_grouped_bf16`` one, the keys their wrapper counts them under."""
    from repro_torch.kernels import launch_counts

    names = ("void (anonymous namespace)::grouped_kernel<float, 2, 1>(float const*)",
             "void (anonymous namespace)::grouped_wgmma_kernel<2, 1>(CUtensorMap_st)",
             "_ZN12_GLOBAL__N_120grouped_wgmma_kernelILi2ELi1EEEv14CUtensorMap_st")
    keys = [K.HAND_KERNELS[K.hand_kernel(n)] for n in names]
    assert keys == ["moe_grouped", "moe_grouped_bf16", "moe_grouped_bf16"]
    assert set(keys) <= set(launch_counts())


def test_kernel_names_and_walk_records():
    assert K.kernel_base(SPLIT) == "(anonymous namespace)::split_kernel"
    assert [K.hand_kernel(x) for x in (SPLIT, COMBINE, TREE, SET_COND, ELEM, GEMM)] == [
        "split_kernel", "combine_kernel", "tree_kernel", "set_cond", None, None]
    assert K.hand_kernel("_ZN12_GLOBAL__N_118paged_split_kernelIfLi128ELi16EEEvPKT_") == (
        "paged_split_kernel")
    assert K.hand_kernel("void at::native::(anonymous namespace)::split_kernel<int>(int)") is None
    text = (f"0\t0\t0\tchild\t0\t0\t0\t\n0\t1\t0\tkernel\t0\t0\t0\t{SPLIT}\n"
            "0\t1\t0\tmemcpy\t4096\t8192\t256\tDtoD\n1\t0\t0\tkernel\t0\t0\t0\t<unresolved>\n")
    nodes = parse_walk(text)
    assert nodes[1] == GraphNode(0, 1, False, "kernel", SPLIT)
    assert nodes[2] == GraphNode(0, 1, False, "memcpy", "DtoD", 4096, 8192, 256)
    assert K.GraphContract("g", tuple(nodes)).unresolved == 1


CFG = dataclasses.replace(get_config("vicuna-7b").reduced(), num_layers=2)
J_CFG = dataclasses.replace(j_get_config("vicuna-7b").reduced(), num_layers=2)


def _port_server(mode, **kw):
    params = M.init_params(CFG, 0, device="cpu")
    args = dict(max_batch=2, max_len=64, draft_k=3, tree_expansions=3, adaptive=False,
                device="cpu")
    if mode != "cascade_fused":
        args["draft_spec"] = layer_sparsity(CFG, 0.5)
    args.update(kw)
    return BatchedSpecServer(CFG, params, mode=mode, **args)


@pytest.mark.parametrize("mode,kw", [("chain_fused", {"round_mode": "split"}),
                                     ("legacy", {}), ("cascade_fused", {})])
def test_split_rounds_have_no_round_graph(mode, kw):
    srv = _port_server(mode, **kw)
    for fn in (K.round_graphs, K.server_round_contracts):
        with pytest.raises(ValueError, match="no captured round graph"):
            fn(srv)


def test_one_graph_a_single_round_as_the_reference_compiles_one_executable():
    """The reference's single-round ``tree_fused`` server compiles one
    executable a round; the port's launches one graph (its segments in
    plan order, the draft gated). On the CPU the round runs eagerly, so
    there is no graph to walk: the contracts raise."""
    j_params = JM.init_params(J_CFG, jax.random.PRNGKey(0))
    j_srv = JServer(J_CFG, j_params, mode="tree_fused", max_batch=2, max_len=64, draft_k=3,
                    tree_expansions=3, adaptive=False, round_mode="single",
                    draft_spec=j_layer_sparsity(J_CFG, 0.5))
    srv = _port_server("tree_fused", round_mode="single")
    graphs = K.round_graphs(srv)
    assert len(j_round_contracts(j_srv)) == len(graphs) == 1
    assert graphs["round"] == (("prologue", False), ("draft", True), ("tail", False))
    with pytest.raises(ValueError, match="no captured round"):
        K.server_round_contracts(srv)


# ---------------------------------------------------------------------- lint
LINT_CASES = {
    "PORT001": ('''
def chain_tail(x):
    return helper(x)

def helper(x):
    return x.sum().item()
''', '''
def chain_tail(x):
    return helper(x)

def helper(x):
    return x.sum()

def host_only(x):
    return x.item()
'''),
    "PORT002": ('''
class Server:
    def _seg_tail(self, mid):
        self.cache["k"].add_(1)

    def step(self):
        self.cache = fresh()
''', '''
class Server:
    def _seg_tail(self, mid):
        self.cache["k"].add_(1)
        self.ring_at += 1

    def step(self):
        self.cache["k"].copy_(fresh())
        self.ring_at += 1
        self.other = 3
'''),
    "PORT003": ('''
import torch

def run(fn, n):
    for _ in range(n):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
''', '''
import torch

def _capture(fn):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g
'''),
    "PORT004": ('''
import time
import random
import torch

def tree_draft(x):
    print("drafting")
    if torch.any(x > 0):
        x = x + random.random() + time.perf_counter()
    return x
''', '''
import torch

def tree_draft(x):
    return torch.where(x > 0, x + 1, x)

def report(x):
    print(x)
'''),
    "PORT005": ('''
import time
import torch

def timed(a, b):
    t0 = time.perf_counter()
    c = torch.matmul(a, b)
    dt = time.perf_counter() - t0
    stamp = time.time()
    return c, dt, stamp
''', '''
import time
import torch

def timed(a, b):
    t0 = time.perf_counter()
    c = torch.matmul(a, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return c, dt
'''),
}


@pytest.mark.parametrize("rule", sorted(LINT_CASES))
def test_lint_rule_bad_and_good(rule):
    bad, good = LINT_CASES[rule]
    found = L.run_sources({"src/pkg/bad.py": bad})
    assert found and {f.rule for f in found} == {rule}, [f.render() for f in found]
    assert L.run_sources({"src/pkg/good.py": good}) == []


def test_lint_waivers():
    bad = LINT_CASES["PORT001"][0].replace(
        "x.sum().item()", "x.sum().item()  # port: noqa-PORT001: read once at build")
    assert L.run_sources({"src/pkg/w.py": bad}) == []
    bare = LINT_CASES["PORT001"][0].replace("x.sum().item()", "x.sum().item()  # port: noqa-PORT001")
    assert [f.rule for f in L.run_sources({"src/pkg/w.py": bare})] == ["PORT000", "PORT001"]
    other = LINT_CASES["PORT001"][0].replace("x.sum().item()",
                                              "x.sum().item()  # port: noqa-PORT004: wrong rule")
    assert [f.rule for f in L.run_sources({"src/pkg/w.py": other})] == ["PORT001"]


def test_the_port_lints_clean():
    found = L.run_paths([os.path.join(REPO, "src", "repro_torch")])
    assert found == [], "\n".join(f.render() for f in found)
    assert L.main([os.path.join(REPO, "src", "repro_torch")]) == 0
