"""The plain reference against the program at tiny sizes on the CPU, the
harness's weights in the program's layout, and the fp8 control."""
import numpy as np
import pytest
import torch

import _tiny  # noqa: F401
from ptb import judge, spec, weights
from reference import model as ref

ARCHS = [_tiny.MOE, _tiny.DENSE]


def _params(arch, seed=0):
    cfg = _tiny.tiny_config(arch)
    return cfg, weights.make(cfg, torch.device("cpu"), seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_is_the_programs(arch):
    from repro_torch.models.model import init_params
    from ptb.harness import program_config

    cfg, params = _params(arch)
    want = init_params(program_config(cfg), device="meta")

    def shapes(t, prefix=()):
        if isinstance(t, dict):
            return {k: v for key in t for k, v in shapes(t[key], prefix + (key,)).items()}
        if isinstance(t, list):
            return {k: v for i, x in enumerate(t) for k, v in shapes(x, prefix + (i,)).items()}
        return {prefix: (tuple(t.shape), t.dtype)}
    assert shapes(params) == shapes(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_equals_the_programs_prefill(arch):
    """The last position's logits of prefixes of a 40-token sequence
    against the program's float32 serving prefill (dropless experts)."""
    from repro_torch.models import model as M
    from ptb.harness import program_config

    cfg, params = _params(arch)
    mc = program_config(cfg)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg["vocab_size"], 40).tolist()
    got = ref.logits(params, cfg, [seq], [0])[0]
    for n in (1, 9, 23, 40):
        cache = M.init_cache(mc, 1, 64, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            want, _ = M.prefill(mc, params, {"tokens": torch.tensor([seq[:n]])}, cache)
        want = want[0, :cfg["vocab_size"]]
        assert torch.allclose(got[n - 1], want, atol=2e-5, rtol=1e-5), (got[n - 1] - want).abs().max()


def test_first_rows_select_the_served_predictions():
    cfg, params = _params(_tiny.DENSE)
    seq = list(range(1, 30))
    full = ref.logits(params, cfg, [seq], [0])[0]
    tail = ref.logits(params, cfg, [seq], [20])[0]
    assert torch.allclose(full[20:], tail)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_control_fails_where_float32_passes(arch):
    """The control at a size a test run holds: the reference in float8 puts
    first tokens whose gap under the float32 reference is far above what
    the float32 program's served tokens read (0 to rounding)."""
    cfg, params = _params(arch)
    rng = np.random.default_rng(1)
    reqs = []
    for i in range(3):
        prompt = rng.integers(0, cfg["vocab_size"], 24).tolist()
        seq = ref.logits(params, cfg, [prompt], [len(prompt) - 1])[0]
        served = [int(seq[0].argmax())]
        for _ in range(11):
            lg = ref.logits(params, cfg, [prompt + served], [len(prompt) + len(served) - 1])[0]
            served.append(int(lg[-1].argmax()))
        reqs.append({"index": i, "prompt": prompt, "served": served, "max_new": 12})
    out = judge.compare(params, cfg, reqs, sides=("served", "control", "witness"))
    assert out["served_gap"] == 0.0
    assert out["control_gap"] > 1e-2
    # the bfloat16 witness rounds less than the control
    assert out["witness_mean_gap"] <= out["control_mean_gap"]


def test_sample_holds_the_longest_and_depends_on_the_seed():
    reqs = [{"index": i, "served": [0] * n} for i, n in enumerate([5, 50, 7, 9, 11, 13, 8])]
    a = judge.sample(reqs, 1, min_tokens=70)
    assert a[0]["index"] == 1 and sum(len(r["served"]) for r in a) >= 70
    draws = {tuple(r["index"] for r in judge.sample(reqs, s, min_tokens=60)) for s in range(8)}
    assert len(draws) > 1
    assert judge.sample([], 3) == []


def _teacher_window(cfg, n_req=3, prompt_len=32, new=40, seed=10):
    """A finished window of requests whose served tokens are drawn at
    random: the context at which the control's first choices are judged."""
    from ptb import measures

    rng = np.random.default_rng(seed)
    V = cfg["vocab_size"]
    reqs = [{"index": i, "prompt": rng.integers(0, V, prompt_len).tolist(),
             "served": rng.integers(0, V, new).tolist(), "max_new": new, "rounds": new,
             "arrivals": [(1.0 + 0.01 * k, k + 1) for k in range(new)], "due": 0.0,
             "admitted_at": 0.5, "prompt_len": prompt_len} for i in range(n_req)]
    return measures.Window(cfg=cfg, mix={}, w0=0.0, w1=10.0, requests=reqs, spans=[],
                           c0={}, c1={}, t_c0=0.0, t_c1=10.0, setup_s=0.0)


@pytest.mark.parametrize("name", sorted({w["config"] for w in spec.benchmark()["workloads"]}))
def test_control_through_the_check_is_not_correct(name):
    """The fp8 control put in the program's place and judged by the
    harness's own comparison at the configuration's committed limits comes
    out not correct. Full depth, widths cut so that a test run holds it
    (fp8 rounding's gaps grow with depth: at 4 layers they stay under the
    limits); the float32 program's own tokens read 0
    (``test_fp8_control_fails_where_float32_passes``)."""
    from ptb import harness

    real = spec.load_json(spec.config_file(name))
    cfg = dict(real, d_model=128, num_heads=2, head_dim=64,
               num_kv_heads=min(2, real["num_kv_heads"]), d_ff=64, vocab_size=2048)
    if "moe" in cfg:
        cfg["moe"] = dict(cfg["moe"], d_ff_expert=64, d_ff_shared=256)
    params = weights.make(cfg, torch.device("cpu"), cfg["weight_seed"])
    v = harness.check(params, cfg, _teacher_window(cfg), seed=7, sides=("control",))
    ctl = v["by_side"]["control"]
    assert ctl["correct"] is False
    failed = [k for k, c in ctl["checks"].items() if c["value"] > c["limit"]]
    assert failed and set(failed) <= set(cfg["limits"])
