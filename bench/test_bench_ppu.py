"""CPU checks of the ``bss2-s5-ppu-program`` configuration and its cell
``s5-fleet256-ppuvm``: the port's vm rule (``rule_impl="vm"``, the
PPU-VM program ``signed_dw_program``) agrees with the plain reference
``reference/bss2_fleet_ppu.py`` at a small size, its eager trials and its
``scanned_training`` alike; the frozen ``ppuvm_exec`` work count is the
port's; the harness reads the new configuration, mix and metrics as it
reads the others; and the cell's comparison passes the port, fails the
lower-precision controls and fails a program that is wrong."""
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
from harness import ppu_work, runner  # noqa: E402
from reference.bss2_fleet import weight_rows  # noqa: E402
from reference.bss2_fleet_ppu import FleetPPU, splat  # noqa: E402

CELL = "s5-fleet256-ppuvm"
CONFIG = "bss2-s5-ppu-program"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LIMITS = ("cols_diverged_pct", "unexplained_cols", "dw_q88_lanes_wrong",
          "weight_code_lanes_wrong")


def config():
    return json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())


def small(variant: str = "continuing", instances: int = 2,
          n_cols: int = 32):
    """``(config overrides, mix overrides)`` of a small copy of the cell:
    a chip of 16 inputs (32 rows) x ``n_cols`` columns at T = 32, six
    trials a call; ``continuing``: experiments of two calls, the first
    call and a continuing one sampled; ``fresh``: every call an
    experiment, two sampled. Every limit 0."""
    cfg = config()
    cfg["chip"].update(n_rows=32, n_cols=n_cols, n_neurons=n_cols)
    cfg["experiment"].update(n_inputs=16, n_neurons=n_cols, pattern_size=5,
                             trial_steps=32)
    per_experiment, fresh, continuing = ((2, 1, 1) if variant == "continuing"
                                         else (1, 2, 0))
    return ({k: cfg[k] for k in ("chip", "experiment")},
            dict(instances=instances, trials_per_call=6,
                 calls_per_experiment=per_experiment, draw_pool_calls=2,
                 trace_calls=1,
                 check=dict(sample_below=4, fresh_calls=fresh,
                            continuing_calls=continuing,
                            limits={k: 0 for k in LIMITS})))


def run(variant: str, seed: int = 4_000_000_035, trace: bool = False):
    co, mo = small(variant)
    return runner.run_cell(ROOT, CELL, seed, 2.0, trace, time.perf_counter(),
                           device="cpu", require_chip=False,
                           config_overrides=co,
                           mix_overrides=copy.deepcopy(mo))


def system(seed: int, instances: int = 4, n_cols: int = 64):
    """The cell's system at a small size on the CPU, set up as a run sets
    it up (its instance and draws from ``seed``)."""
    co, mo = small(instances=instances, n_cols=n_cols)
    cfg = dict(config(), **co)
    mix = json.loads((BENCH / "mixes" / f"{CELL}.json").read_text())
    mix.update(mo)
    module = runner.load_module(BENCH / "configs" / f"{CONFIG}.py",
                                "t_ppu_config")
    torch_ = runner.prepare_torch(ROOT)
    ctx = SimpleNamespace(torch=torch_, device=torch_.device("cpu"),
                          seed=seed, config=cfg, mix=mix)
    return module.setup(ctx)


@pytest.mark.parametrize("mode", ["scanned", "eager"])
def test_the_vm_rule_agrees_with_the_reference(mode):
    """4 instances of a 32 x 64 chip at T = 32, six trials from the
    reference's initial state: the Q8.8 dw that the port's program leaves
    in register 0 (excitatory rows) and the 6-bit weight codes of every
    trial and of the stored array equal the reference's exactly (integer
    arithmetic on equal inputs); the signed weights within 1e-4 (float32
    sums of the same terms in the same order, so equal in practice; a dw
    off by one Q8.8 step, 2^-8, fails it). The emulation's inputs to the
    rule (rate counters, rewards, eligibilities) are equal, so every
    synapse is compared."""
    sys_ = system(3_500_000_035)
    ppu = sys_.meta["ppu"]
    readouts = []
    real = ppu.run_program

    def run_program(state, words, **kw):
        new, regs = real(state, words, **kw)
        readouts.append(regs[0][..., 0::2, :].to(torch.int64))
        return new, regs
    ppu.run_program = run_program
    ref = FleetPPU(sys_.cfg, sys_.inst)
    start = ref.init_state()
    ev, xi = sys_.pool[0]
    draws = sys_.hybrid.Draws(events=ev, xi=xi)
    run_fn = (sys_.scanned if mode == "scanned"
              else sys_.meta["train"])
    st, hist = run_fn(sys_.init(), sys_.stims, draws)
    seen = []
    fin = ref.run({k: v.clone() for k, v in start.items()}, sys_.stims, ev,
                  xi, each=lambda i, m: seen.append(m))
    # the scanned mode's loop captures nothing on the CPU: one trial a body
    assert len(readouts) == len(seen) == len(sys_.stims)
    for i, m in enumerate(seen):
        for key in ("rates", "reward", "mean_reward", "elig"):
            assert torch.equal(hist[key][i], m[key]), (i, key)
        assert torch.equal(readouts[i], m["dw_q88"]), i
        assert torch.equal(weight_rows(hist["w"][i]), weight_rows(m["w"])), i
        torch.testing.assert_close(hist["w"][i], m["w"], rtol=0, atol=1e-4)
    assert torch.equal(st.core.syn.weights, fin["weights"])
    assert any(bool((m["dw_q88"] != 0).any()) for m in seen)


def test_the_references_constants_are_the_programs():
    """The immediates the reference works out (VSPLAT's rounding of the
    configuration's constants) are the words the port assembles."""
    from repro_torch.ppuvm import isa, programs
    from reference.bss2_fleet_ppu import eta_gain
    exp = config()["experiment"]
    words = programs.signed_dw_program(eta=exp["eta"],
                                       eta_homeo=exp["eta_homeo"],
                                       fire_thresh=exp["fire_thresh"])
    assert len(words) == ppu_work.SIGNED_DW_WORDS
    splats = [isa.decode(int(w))[5] for w in words
              if isa.decode(int(w))[0] == isa.SPLAT]
    assert splats == [splat(eta_gain(exp["eta"], 255)),
                      splat(exp["fire_thresh"]), splat(1.0),
                      splat(exp["eta_homeo"])]


def test_frozen_ppu_work_equals_the_ports():
    """``harness.ppu_work`` is ``ppuvm_exec``'s ``work()`` at the cell's
    shape: 256 instances of [256, 512] lanes, 19 words, the two CADC
    planes, two modulator slots, int8 weights (45 bytes a lane)."""
    from repro_torch.kernels.ppuvm_exec import ops
    N, R, C = 256, 256, 512
    mine = ppu_work.ppuvm_exec(N, R, C, 19, 2, 2)
    w = ops.work(N, R, C, 19, 2, 2, 1)
    assert mine == (w.flops, w.bytes)
    assert (w.bytes - N * C * 4 * 3 - 4 * 19) / (N * R * C) == 45
    assert ppu_work.ppuvm_exec(2, 4, 8, 7, 3, 1, 4) == (
        ops.work(2, 4, 8, 7, 3, 1, 4).flops,
        ops.work(2, 4, 8, 7, 3, 1, 4).bytes)


def test_the_harness_reads_the_new_entries():
    """The configuration file names itself, its source and an empty
    ``reduced`` as the ``configs`` entry does, holds
    ``bss2-s5-fullwidth``'s chip and experiment whole and states its rule;
    the cell runs on one card with its mix; it reports the two end-to-end
    metrics and ``setup_s``, and just the two per-layer metrics that list
    it, whose readers load; the older cell reports none of them."""
    cell, conf = runner.lookup(SPEC, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == CELL
    cfg = config()
    assert (cfg["name"], cfg["source"], cfg["reduced"]) == (
        conf["name"], conf["source"], conf["reduced"]) == (
        CONFIG, conf["source"], [])
    full = json.loads((BENCH / "configs" / "bss2-s5-fullwidth.json")
                      .read_text())
    assert cfg["chip"] == full["chip"]
    assert cfg["experiment"] == full["experiment"]
    assert cfg["rule"] == "ppuvm signed_dw_program (19 words, Q8.8)"
    mix = json.loads((BENCH / "mixes" / f"{CELL}.json").read_text())
    assert set(mix["check"]["limits"]) == set(LIMITS)
    e2e = {m["name"] for m in runner.metrics_of(SPEC, CELL, "end_to_end")}
    assert e2e == {"instance_trials_per_s", "scan_call_ms_p95", "setup_s"}
    layer = {m["name"] for m in runner.metrics_of(SPEC, CELL, "per_layer")}
    assert layer == {"ppu_program_ms.vm", "ppuvm_exec_roofline.vm"}
    old = {m["name"] for m in runner.metrics_of(SPEC, "s5-fleet256",
                                                "per_layer")}
    assert not old & layer
    for name in layer:
        mod = runner.load_module(BENCH / "metrics" / f"{name}.py",
                                 "t_ppu_" + name.replace(".", "_"))
        assert callable(mod.read)


def _reader(name):
    return runner.load_module(BENCH / "metrics" / f"{name}.py",
                              "t_ppu_" + name.replace(".", "_"))


def test_the_program_span_reader():
    """``ppu_program_ms.vm`` is the mean of ``trial.ppu_program`` in ms on
    a CUDA timer; nothing on the CPU's timer or from a program that does
    not split that region off (the python rule's, or the parent's)."""
    from repro_torch.obs.timing import PhaseTimer
    read = _reader("ppu_program_ms.vm").read

    def stand_in(names, device="cuda"):
        timer = PhaseTimer("cpu")
        for _ in range(2):
            for name in names:
                with timer.span(name):
                    pass
        timer.device = torch.device(device)
        return SimpleNamespace(system=SimpleNamespace(meta={"timer": timer}))
    run_ = stand_in(("trial.emulation", "trial.ppu_program", "trial.rule"))
    s = run_.system.meta["timer"].summary()
    assert read(run_) == pytest.approx(s["trial.ppu_program"]["mean_us"]
                                       * 1e-3)
    assert read(stand_in(("trial.ppu_program",), "cpu")) is None
    assert read(stand_in(("trial.emulation", "trial.rule"))) is None


def test_the_roofline_reader():
    """``ppuvm_exec_roofline.vm`` from a stand-in traced slice: the
    counted programs' roofline time over the kernel's traced time; nothing
    where the program counted no program (a program without the
    ``ppu.*`` counters) or the trace holds no ``ppuvm_exec``."""
    from harness import kernel_work, peaks
    read = _reader("ppuvm_exec_roofline.vm").read
    sys_ = system(3_500_000_036, instances=2, n_cols=32)
    work = ppu_work.ppuvm_exec(2, 32, 32, 19, 2, 2)
    secs = 1e-3
    summary = dict(ops={"void (anonymous namespace)::ppuvm_exec_kernel<"
                        "true, false, signed char>(int)": [secs, 60]},
                   busy_s=1.0, window_s=1.0, gaps={})
    counted = dict(programs=60, instructions=60 * work[0], n_post=0.0)
    run_ = SimpleNamespace(system=sys_, peaks=peaks.peaks_for("H100"),
                           trace=dict(calls=[0, 1], summary=summary,
                                      counted=counted))
    want = 100.0 * kernel_work.roofline_s(60 * work[0], 60 * work[1],
                                          run_.peaks) / secs
    assert read(run_) == pytest.approx(want)
    run_.trace["counted"] = dict(programs=0, instructions=0, n_post=0.0)
    assert read(run_) is None
    run_.trace["counted"] = counted
    summary["ops"] = {"corr_kernel": [secs, 60]}
    assert read(run_) is None


def test_a_traced_call_counts_its_programs():
    """Over the traced calls the system reads from the program's counters
    a program a trial and the program's words over every lane, as
    ``harness.ppu_work`` counts one run's operations."""
    sys_ = system(3_500_000_037, instances=2, n_cols=32)
    sys_.warmup()
    sys_.call(0)
    sys_.trace_begin()
    sys_.call(1)
    sys_.call(2)
    counted = sys_.trace_end()
    assert counted["programs"] == 2 * sys_.n
    assert counted["instructions"] == 2 * sys_.n * ppu_work.ppuvm_exec(
        2, 32, 32, 19, 2, 2)[0]


@pytest.mark.parametrize("variant", ["continuing", "fresh"])
def test_the_port_passes_the_cells_comparison(variant):
    res = run(variant)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["checks"]) == set(LIMITS)
    assert all(c["value"] == 0 for c in res["checks"].values())
    traced = run(variant, trace=True)
    assert traced["correct"] and traced["metrics"] == {}


def test_the_lower_precision_controls_fail():
    """TF32 or bfloat16 operands in the reference's product, put in the
    program's place, fail ``cols_diverged_pct`` at limit 0 on every seed
    (bfloat16 on most columns); the exact readings stay 0 (the controls
    run the same integer rule)."""
    co, mo = small("continuing")
    lines = list(control.readings(ROOT, CELL, [11, 12, 13], ["tf32", "bf16"],
                                  "cpu", co, mo))
    for line in lines:
        assert all(v == 0 for v in line["program"].values()), line
        assert line["tf32"]["cols_diverged_pct"] > 0, line
        assert line["bf16"]["cols_diverged_pct"] > 10.0, line


@pytest.mark.parametrize("fault", ["python_rule", "constant_off"])
def test_a_wrong_program_is_not_correct(monkeypatch, fault):
    """The python rule (float dw, no Q8.8 rounding) in the program's
    place, or a program whose homeostatic constant is one Q8.8 step off:
    the cell's comparison counts wrong dw lanes and fails."""
    from repro_torch.core import hybrid
    from repro_torch.ppuvm import programs
    if fault == "python_rule":
        real = hybrid.make_experiment

        def make(*a, **kw):
            return real(*a, **dict(kw, rule_impl="python"))
        monkeypatch.setattr(hybrid, "make_experiment", make)
    else:
        real = programs.signed_dw_program

        def program(**kw):
            return real(**dict(kw, eta_homeo=kw["eta_homeo"] + 1 / 256))
        monkeypatch.setattr(programs, "signed_dw_program", program)
    res = run("continuing")
    assert not res["correct"], res["checks"]
    assert res["checks"]["dw_q88_lanes_wrong"]["value"] > 0, res["checks"]
