"""CPU checks of the span readers (``metrics/*`` reading
``harness.spans``): each returns a number from a stand-in run whose
program timer is a CUDA timer holding samples, and ``None`` on the CPU,
with no samples, or for a program that keeps no timer."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import runner  # noqa: E402

READERS = ("trial_rule_ms.fleet", "trial_carry_ms.fleet",
           "call_load_clone_ms.fleet", "graph_capture_s.fleet")


def reader(name):
    return runner.load_module(BENCH / "metrics" / f"{name}.py",
                              "t_spans_" + name.replace(".", "_"))


def stand_in(samples: bool, device: str = "cuda"):
    """A run whose system's ``meta["timer"]`` is the program's
    ``PhaseTimer``, its device set to ``device``, holding two calls' spans
    and counters where ``samples``."""
    from repro_torch.obs.timing import PhaseTimer
    timer = PhaseTimer("cpu")
    if samples:
        for _ in range(2):
            timer.count("scan.calls")
            for name in ("scan.load", "scan.replays", "scan.clones",
                         "trial.emulation", "trial.rule", "trial.carry",
                         "graph.capture"):
                with timer.span(name):
                    pass
    timer.device = torch.device(device)
    return SimpleNamespace(system=SimpleNamespace(meta={"timer": timer}))


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_reads_a_cuda_timer(name):
    run = stand_in(True)
    v = reader(name).read(run)
    assert isinstance(v, float) and v >= 0.0
    s = run.system.meta["timer"].summary()
    want = {"trial_rule_ms.fleet": s["trial.rule"]["mean_us"] * 1e-3,
            "trial_carry_ms.fleet": s["trial.carry"]["mean_us"] * 1e-3,
            "call_load_clone_ms.fleet": (s["scan.load"]["total_us"]
                                         + s["scan.clones"]["total_us"])
            * 1e-3 / 2,
            "graph_capture_s.fleet": s["graph.capture"]["total_us"] * 1e-6}
    assert v == pytest.approx(want[name])


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_reads_nothing_where_nothing_was_timed(name):
    read = reader(name).read
    assert read(stand_in(True, "cpu")) is None
    assert read(stand_in(False)) is None
    no_timer = SimpleNamespace(system=SimpleNamespace(meta={}))
    assert read(no_timer) is None
