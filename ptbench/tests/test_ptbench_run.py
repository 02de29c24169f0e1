"""A whole run of the harness on the CPU at a tiny size, the chip's look
skipped: correct on the sound program, not correct with the timed path
broken underneath (a token altered where it is produced, a step that
leaves the state unchanged, half of the batch left out; the cells take
one chip, so no exchange between chips can be left out). Also the import
check and the device trace's arithmetic."""
import subprocess
import sys

import pytest

import _tiny
from ptb import devtrace, faults, harness, isolation

sys.path.insert(0, str(_tiny.BENCH))
import run as bench_run  # noqa: E402


@pytest.mark.parametrize("arch,kind", [(_tiny.MOE, "chat"), (_tiny.DENSE, "docs")])
def test_sound_run_is_correct(arch, kind):
    out = bench_run.run(_tiny.tiny_cell(arch, kind), seed=2**31 + 3, seconds=1.0, trace=False,
                        device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    names = {"chat": {"tpot_ms", "itl_p95_ms", "setup_s"},
             "docs": {"output_tokens_per_s", "setup_s"}}[kind]
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def _break(fault: str, monkeypatch) -> None:
    """Every server the harness builds from here on steps broken."""
    build = harness.CellRun.build

    def broken_build(self):
        build(self)
        faults.plant(self, fault)
    monkeypatch.setattr(harness.CellRun, "build", broken_build)


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    _break(fault, monkeypatch)
    out = bench_run.run(_tiny.tiny_cell(_tiny.MOE, "chat"), seed=5, seconds=1.0, trace=False,
                        device="cpu")
    assert out["correct"] is False


def test_traced_run_reads_its_per_layer_metrics():
    out = bench_run.run(_tiny.tiny_cell(_tiny.DENSE, "chat"), seed=8, seconds=1.0, trace=True,
                        device="cpu")
    got = set(out["metrics"])
    # no device trace on the CPU: the device's reading is left out, not 0
    assert "device_idle_share.chat" not in got
    assert {"round_ms.chat", "tokens_per_slot_round.chat", "draft_round_share.chat",
            "step_mfu.chat", "admit_ms.chat", "ttft_p90_ms.chat"} <= got


def test_top_level_names_are_compared_whole():
    assert isolation.is_forbidden("repro") and isolation.is_forbidden("repro.models.model")
    assert isolation.is_forbidden("jax.numpy") and isolation.is_forbidden("jaxlib")
    assert not isolation.is_forbidden("repro_torch") and not isolation.is_forbidden("reprox")


def test_benchmark_process_loads_no_jax_and_no_jax_package():
    """Everything a run imports, in a fresh process: no forbidden top-level
    name, and an import of one is refused."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from ptb import isolation; isolation.install()\n"
        "import run, control, sweep\n"
        "from ptb import harness, judge, measures, devtrace, weights, counts\n"
        "from reference import model\n"
        "import repro_torch.serving, repro_torch.core.dsia, repro_torch.models.model\n"
        "assert isolation.loaded() == [], isolation.loaded()\n"
        "try:\n    import jax\nexcept ImportError:\n    pass\n"
        "else:\n    raise SystemExit('jax imported')\n"
        "try:\n    import repro\nexcept ImportError:\n    print('ok')\n"
    ) % (str(_tiny.BENCH), str(_tiny.BENCH.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_harness_sources_import_nothing_of_jax_or_the_reference_package():
    import ast

    for path in _tiny.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert not isolation.is_forbidden(n), (path, n)
                if path.parent.name == "reference":
                    assert not n.startswith("repro_torch"), (path, n)


def test_device_trace_reduction_by_hand():
    ms = 1_000_000
    ev = [("device", "gemm", 10 * ms, 30 * ms), ("device", "gemm", 25 * ms, 40 * ms),
          ("device", "attn", 60 * ms, 70 * ms), ("device", "late", 95 * ms, 120 * ms),
          ("host", "admit", 41 * ms, 59 * ms), ("host", "dispatch", 0, 9 * ms),
          ("host", "route", 69 * ms, 72 * ms)]
    out = devtrace.reduce(ev, ["admit", "dispatch", "route"], 0.125)
    # busy: [10, 40] + [60, 70] + [95, 120] = 65 ms
    assert out["busy_s"] == pytest.approx(0.065) and out["window_s"] == 0.125
    assert out["device_ops"][0] == ["gemm", pytest.approx(0.035)]
    # gaps between the first and the last operation: [40, 60] admit, [70, 95]
    # route overlaps 2 ms of it and wins over no span
    assert out["idle_gaps"] == [["route", pytest.approx(0.025)], ["admit", pytest.approx(0.02)]]
    assert devtrace.reduce([e for e in ev if e[0] == "host"], ["admit"], 0.1) is None


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = bench_run.run(_tiny.tiny_cell(_tiny.MOE, "docs"), seed=4, seconds=1.0, trace=True,
                        device="cuda")
    assert out["correct"] and out["device"]["busy_s"] > 0
