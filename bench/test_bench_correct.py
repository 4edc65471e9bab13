"""CPU checks of how the benchmark decides ``correct``, at a size a test
run holds: the port agrees with the plain reference on small copies of
the fleet cell, the control (the reference in a lower precision in the
program's place) fails the comparison, and a run whose timed path is
broken underneath comes out not correct, once for each fault a cell can
have. Every run here goes through the harness as ``bench/run.py`` does,
without its look for a card."""
from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import control  # noqa: E402
from harness import runner  # noqa: E402

CELL = "s5-fleet256"
# two small copies of the cell: experiments of two calls, so that a
# continuing call is sampled beside an experiment's first; and experiments
# of one call, every sampled call a first
VARIANTS = ("continuing", "fresh")
FAULTS = ("state_unchanged", "half_the_batch", "answer_altered")


def small(variant: str):
    """``(config overrides, mix overrides)`` of a small copy of the cell:
    a 32 x 32 chip of 16 inputs and T = 32, two instances, six trials a
    call. The ``continuing`` copy makes an experiment of two calls and
    samples its first call and a continuing one among the first four; the
    ``fresh`` copy makes every call an experiment and samples two."""
    cfg = json.loads((BENCH / "configs" / "bss2-s5-fullwidth.json")
                     .read_text())
    cfg["chip"].update(n_rows=32, n_cols=32, n_neurons=32)
    cfg["experiment"].update(n_inputs=16, n_neurons=32, pattern_size=5,
                             trial_steps=32)
    limits = dict(cols_diverged_pct=0.0, unexplained_cols=0)
    per_experiment, fresh, continuing = ((2, 1, 1) if variant == "continuing"
                                         else (1, 2, 0))
    return ({k: cfg[k] for k in ("chip", "experiment")},
            dict(instances=2, trials_per_call=6,
                 calls_per_experiment=per_experiment, draw_pool_calls=2,
                 trace_calls=1,
                 check=dict(sample_below=4, fresh_calls=fresh,
                            continuing_calls=continuing, limits=limits)))


def run(variant: str, seed: int = 4_000_000_007, seconds: float = 2.0,
        trace: bool = False):
    co, mo = small(variant)
    return runner.run_cell(ROOT, CELL, seed, seconds, trace,
                           time.perf_counter(), device="cpu",
                           require_chip=False, config_overrides=co,
                           mix_overrides=copy.deepcopy(mo))


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_port_agrees_with_the_reference(variant):
    res = run(variant)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    e2e = {m["name"] for m in runner.metrics_of(
        runner.load_json(ROOT / "BENCHMARK.json"), CELL, "end_to_end")}
    assert set(res["metrics"]) == e2e


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_traced_run_is_judged_the_same(variant):
    res = run(variant, trace=True)
    assert res["correct"], res["checks"]
    # the CPU's profiler does not trace a card: every device reader finds
    # nothing to read and leaves its metric out
    assert res["metrics"] == {}


@pytest.mark.parametrize("variant", VARIANTS)
def test_the_lower_precision_control_fails(variant):
    co, mo = small(variant)
    lines = list(control.readings(ROOT, CELL, [11, 12, 13], ["bf16"],
                                  "cpu", co, mo))
    for line in lines:
        assert all(v == 0 for v in line["program"].values()), line
    assert all(line["bf16"]["cols_diverged_pct"] > 10.0 for line in lines), \
        lines


def _fleet_fault(monkeypatch, fault):
    from repro_torch.core import hybrid
    if fault == "state_unchanged":
        monkeypatch.setattr(hybrid.TrialLoop, "_assign",
                            lambda self, new: None)
        return
    real = hybrid.TrialLoop.__init__

    def init(self, trial, state, stims, draws):
        def broken(st, stim, events, xi):
            if fault == "half_the_batch":
                # the second half of the fleet gets the first half's inputs
                h = events.shape[1] // 2
                events = torch.cat([events[:, :h], events[:, :h]], 1)
                xi = torch.cat([xi[:h], xi[:h]], 0)
                return trial(st, stim, events, xi)
            new, m = trial(st, stim, events, xi)
            m = dict(m, rates=m["rates"].clone())
            m["rates"][0, 0] += 1.0         # one answer altered
            return new, m
        real(self, broken, state, stims, draws)
    monkeypatch.setattr(hybrid.TrialLoop, "__init__", init)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, variant, fault):
    _fleet_fault(monkeypatch, fault)
    res = run(variant)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_the_sampled_calls_come_from_the_seed():
    co, mo = small("continuing")
    mo["check"].update(sample_below=20, fresh_calls=2, continuing_calls=3)
    config = json.loads((BENCH / "configs" / "bss2-s5-fullwidth.json")
                        .read_text())
    config.update(co)
    module = runner.load_module(BENCH / "configs" / "bss2-s5-fullwidth.py",
                                "t_fleet_config")
    torch_ = runner.prepare_torch(ROOT)

    mix = json.loads((BENCH / "mixes" / f"{CELL}.json").read_text())
    mix.update(mo)

    def sample(seed):
        ctx = SimpleNamespace(torch=torch_, device=torch_.device("cpu"),
                              seed=seed, config=config, mix=mix)
        return module.setup(ctx).sample
    a = sample(2 ** 31 + 5)
    assert a == sample(2 ** 31 + 5) and len(a) == 5
    assert all(0 <= k < 20 for k in a)
    # two experiments' first calls (every second call), three continuing
    assert sum(k % 2 == 0 for k in a) == 2
    assert any(sample(s) != a for s in (7, 8, 9))
