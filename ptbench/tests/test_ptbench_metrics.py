"""The end-to-end and per-layer arithmetic on a synthetic window whose
answers are worked out by hand."""
import pytest

import _tiny  # noqa: F401
from ptb import measures, spec
from ptb.harness import load_reader
from ptb.stats import percentile, spread

CFG = spec.load_json(spec.config_file(_tiny.MOE))


def _window(**kw):
    # window [10, 20]; request A: budget 4, deliveries at 9 (1), 11 (2),
    # 12 (3), 14 (6: overshoot past 4, counted at 4), 15 (8, after its
    # last); request B: budget 10, deliveries at 13 (2), 19 (5), 21 (7).
    reqs = [
        {"index": 0, "prompt_len": 100, "max_new": 4, "due": 8.5, "admitted_at": 8.8,
         "arrivals": [(9.0, 1), (11.0, 2), (12.0, 3), (14.0, 6), (15.0, 8)], "rounds": 4,
         "served": [1, 2, 3, 4]},
        {"index": 1, "prompt_len": 50, "max_new": 10, "due": 12.0, "admitted_at": 12.5,
         "arrivals": [(13.0, 2), (19.0, 5), (21.0, 7)], "rounds": 3, "served": None},
    ]
    base = dict(cfg=CFG, mix={}, w0=10.0, w1=20.0, requests=reqs,
                spans=[("drain", 12.5, 12.6), ("admit", 12.6, 12.9), ("dispatch", 13.0, 13.1)],
                c0={"steps": 100, "draft_rounds": 40, "graph_replays": 100, "host_syncs": 100,
                    "ring_accepted": 500.0, "ring_rounds": 400.0},
                c1={"steps": 150, "draft_rounds": 60, "graph_replays": 150, "host_syncs": 150,
                    "ring_accepted": 620.0, "ring_rounds": 480.0},
                t_c0=10.0, t_c1=20.5, setup_s=33.0,
                profile={"busy_s": 2.25, "window_s": 3.0})
    base.update(kw)
    return measures.Window(**base)


def test_gaps_and_tokens_by_hand():
    w = _window()
    gaps, toks = measures.window_gaps(w)
    # A: (11,12) 1 token, (12,14) 1 token (3 -> 4, capped); B: (13,19) 3 tokens
    assert sorted(zip(gaps, toks)) == [(1.0, 1), (2.0, 1), (6.0, 3)]
    # in-window tokens: A 2 (at 11), 3, 4; B 1-2 (at 13), 3-5 (at 19)
    assert measures.window_tokens(w) == 3 + 5


def test_end_to_end_readers_by_hand():
    w = _window()
    assert load_reader("tpot_ms")(w) == pytest.approx(1000.0 * 9.0 / 5)
    # p95 of (1, 2, 6): rank 0.95 * 2 = 1.9 -> 2 + 0.9 * 4 = 5.6 s
    assert load_reader("itl_p95_ms")(w) == pytest.approx(5600.0)
    assert load_reader("output_tokens_per_s")(w) == pytest.approx(8 / 10.0)
    assert load_reader("setup_s")(w) == 33.0


def test_per_layer_readers_by_hand():
    w = _window()
    # B is the only request first served in the window: 13 - 12
    assert load_reader("ttft_p90_ms.chat")(w) == pytest.approx(1000.0)
    # one admission (B, at 12.5); drain + admit 0.1 + 0.3 s
    assert load_reader("admit_ms.chat")(w) == pytest.approx(400.0)
    # A finished at 14 (in the window): (14 - 9) / 3
    assert load_reader("tpot_p90_ms.chat")(w) == pytest.approx(5000.0 / 3)
    # (20.5 - 10 - 0.4) s over 50 rounds
    assert load_reader("round_ms.chat")(w) == pytest.approx(1000.0 * 10.1 / 50)
    assert load_reader("tokens_per_slot_round.docs")(w) == pytest.approx(120 / 80)
    assert load_reader("draft_round_share.chat")(w) == pytest.approx(40.0)
    assert load_reader("device_idle_share.docs")(w) == pytest.approx(25.0)
    assert load_reader("device_idle_share.chat")(_window(profile=None)) is None


def test_step_mfu_counts_delivered_tokens_and_admitted_prompts():
    from ptb import counts

    w = _window()
    want = (counts.generated_flops(CFG, 100, 2, 4) + counts.generated_flops(CFG, 50, 1, 5)
            + counts.prefill_flops(CFG, 50))
    assert measures.target_flops(w) == pytest.approx(want)
    # token 2 of A is the decode of token 1 at position 100
    assert counts.generated_flops(CFG, 100, 2, 2) == counts.decode_token_flops(CFG, 100)
    assert load_reader("step_mfu.chat")(w) == pytest.approx(100.0 * want / 10.0 / 989e12)


def test_order_statistics():
    assert percentile([], 95) is None
    assert percentile([3.0], 95) == 3.0
    assert percentile(range(101), 90) == pytest.approx(90.0)
    # statistics.quantiles' exclusive quartiles of 1..8: 2.25 and 6.75, median 4.5
    assert spread(range(1, 9)) == pytest.approx(4.5 / 4.5)


def test_every_benchmark_metric_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.metric_file(m["name"]).exists(), m["name"]
        assert callable(load_reader(m["name"]))
