"""The frozen counting copy, pinned to numbers worked out by hand for the
two configurations, and held to the program's ``analysis/costs.py`` (which
it was copied from) at the cells' sizes."""
import pytest

import _tiny  # noqa: F401
from ptb import counts, peaks, spec

# qwen2-moe-a2.7b, one token through one layer:
#   attention 2 (2048 * 16 * 128 * 4)                      =  33,554,432
#   router 2 * 2048 * 60                                   =     245,760
#   experts 2 * 3 * 4 * 2048 * 1408                        =  69,206,016
#   shared 2 * 3 * 2048 * 5632, its gate 2 * 2048          =  69,210,112
#   the head over 152,064 padded ids: 2 * 2048 * 152,064   = 622,854,144
# internlm2-20b:
#   attention 2 (6144 * 6144 * 2 + 6144 * 1024 * 2)        = 176,160,768
#   MLP 2 * 3 * 6144 * 16384                               = 603,979,776
#   the head over 92,672 padded ids: 2 * 6144 * 92,672     = 1,138,753,536
HAND = {
    "qwen2-moe-a2.7b": dict(layer=172_216_320, head=622_854_144, layers=24, heads=16,
                            params=14_315_636_736, active=2_689_026_048),
    "internlm2-20b": dict(layer=780_140_544, head=1_138_753_536, layers=48, heads=48,
                          params=19_861_149_696, active=19_861_149_696),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_counts_by_hand(name):
    cfg, h = spec.load_json(spec.config_file(name)), HAND[name]
    assert counts.layer_weight_flops(cfg) == h["layer"]
    assert counts.unembed_flops(cfg) == h["head"]
    att = 4 * 128 * h["heads"] * h["layers"]       # one (row, key) pair in every layer
    assert counts.decode_token_flops(cfg, 0) == h["layers"] * h["layer"] + h["head"] + att
    assert counts.decode_token_flops(cfg, 999) == h["layers"] * h["layer"] + h["head"] + 1000 * att
    assert counts.prefill_flops(cfg, 4) == 4 * h["layers"] * h["layer"] + 10 * att + h["head"]
    assert counts.param_count(cfg) == h["params"]
    assert counts.active_param_count(cfg) == h["active"]


@pytest.mark.parametrize("name", sorted(HAND))
@pytest.mark.parametrize("S", [1, 37, 2048])
def test_counts_equal_the_programs(name, S):
    from repro_torch.analysis import costs
    from ptb.harness import program_config

    cfg = spec.load_json(spec.config_file(name))
    mc = program_config(cfg)
    assert counts.decode_token_flops(cfg, S) == costs.decode_step(mc, 1, 1, S).flops
    assert counts.prefill_flops(cfg, S) == costs.prefill(mc, 1, S).flops
    assert counts.param_count(cfg) == costs.param_count(mc)
    assert counts.active_param_count(cfg) == costs.active_param_count(mc)


def test_peaks_equal_the_programs():
    from repro_torch.analysis import roofline

    assert peaks.HBM_BYTES_PER_S == roofline.HBM_BW
    for k, v in roofline.PEAK_FLOPS.items():
        assert peaks.FLOPS_PER_S[k] == v
