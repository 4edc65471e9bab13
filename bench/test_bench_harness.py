"""CPU checks of the benchmark's harness: that ``BENCHMARK.json`` keeps
its contract and names only files that are there, that nothing under
``bench/`` imports JAX or the JAX package, that the frozen kernel work
counts are the port's ``work()`` at full activity, the trace reduction,
and that a run without a card prints no result."""
from __future__ import annotations

import ast
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import kernel_work, runner, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_every_cell_reports_what_it_must():
    confs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        e2e = runner.metrics_of(SPEC, w["name"], "end_to_end")
        layer = runner.metrics_of(SPEC, w["name"], "per_layer")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])


def test_harness_finds_every_file_by_name():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert path.with_suffix(".py").is_file()
    for w in SPEC["workloads"]:
        mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert mix["check"]["limits"]
        assert "trace_calls" in mix
    for m in SPEC["per_layer"]:
        mod = runner.load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "t_" + m["name"].replace(".", "_"))
        assert callable(mod.read)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_no_jax_and_no_jax_package_under_bench():
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert top not in runner.FORBIDDEN, (path, mod)
            if path.parent.name == "reference":
                assert top != "repro_torch", (path, mod)


def test_the_loaded_module_check_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in runner.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert runner.forbidden_modules() == ["jaxlib", "repro"]


def test_frozen_work_counts_equal_the_ports():
    from repro_torch.kernels.corr import ops as corr
    from repro_torch.kernels.neuron_scan import ops as neuron
    from repro_torch.kernels.stp_scan import ops as stp
    from repro_torch.kernels.synray import ops as synray
    from repro_torch.kernels.synray_sparse import ops as sparse
    T, N, R, C = 128, 256, 128, 512

    def same(mine, theirs):
        assert mine == (theirs.flops, theirs.bytes)
    # at full activity: every (step, row) carries an event, every
    # synapse's accumulators move every step
    same(kernel_work.synray(T, N, R, C, T * N * R), synray.work(T, N, R, C))
    n_rec = 96
    w = sparse.work_window(T, N, R, C, n_rec, n_rec)
    assert kernel_work.synray_sparse(T, N, R, C, N * n_rec) == (
        w.flops, w.bytes)
    same(kernel_work.neuron_scan(T, N, C), neuron.work(T, N, C))
    same(kernel_work.corr(T, N, 2 * R, C, T * N * 2 * R, T * N * C),
         corr.work(T, N, 2 * R, C))
    same(kernel_work.stp_scan(T, N, 2 * R), stp.work(T, N, 2 * R, True))


def test_model_flops_are_the_references():
    from repro_torch.core import hybrid
    src = inspect.getsource(hybrid.trace_bss2_cell)
    assert "(2 * cfg.n_rows * cfg.n_cols + 40 * cfg.n_cols" in src
    assert "+ 4 * cfg.n_rows * cfg.n_cols) * 128" in src
    assert kernel_work.s5_model_flops(256, 512, 128) == (
        (2 * 256 * 512 + 40 * 512 + 4 * 256 * 512) * 128)


def test_every_kernel_of_the_port_has_a_family():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    found = set()
    for path in csrc.glob("*.cu"):
        found |= set(re.findall(r"__global__ void (?:__launch_bounds__"
                                r"\([^)]*\)\s*)?(\w+)\(", path.read_text()))
    found = {k for k in found if "floor" not in k}
    assert found and found <= set(kernel_work.FAMILIES)
    assert kernel_work.family(
        "void (anonymous namespace)::gated_kernel<true>((anonymous "
        "namespace)::Args)") == "synray_sparse"
    assert kernel_work.family("void at::native::elementwise_kernel<128, 4"
                              ">(int, float)") is None


def test_trace_summary_busy_window_and_gaps():
    ev = [dict(ph="X", cat="kernel", name="void k1(int)", ts=10, dur=5),
          dict(ph="X", cat="kernel", name="k2", ts=12, dur=6),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=30, dur=10),
          dict(ph="X", cat="user_annotation", name="host work", ts=0,
               dur=40),
          dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=20,
               dur=4),
          dict(ph="X", cat="Trace", name="PyTorch Profiler", ts=0, dur=99)]
    s = trace.summarise({"traceEvents": ev})
    assert s["window_s"] == pytest.approx(40e-6)
    assert s["busy_s"] == pytest.approx(18e-6)
    assert s["ops"]["k1"] == [pytest.approx(5e-6), 1]
    # gaps 0-10, 18-30, named by the innermost host event at their middle
    assert s["gaps"]["host work"] == pytest.approx(10e-6)
    assert s["gaps"]["cudaGraphLaunch"] == pytest.approx(12e-6)
    assert trace.top({"a": [1.0, 2], "b": [3.0, 1]}, 1) == [["b", 3.0]]


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    cell = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_same_seed_makes_the_same_inputs():
    import torch
    from harness import traffic
    cfg = json.loads((BENCH / "configs" / "bss2-s5-fullwidth.json")
                     .read_text())
    chip, exp = cfg["chip"], dict(cfg["experiment"], trial_steps=16)

    def make(seed):
        gen = traffic.generator(seed, torch.device("cpu"))
        inst = traffic.instance(gen, chip, (2,), 2 * exp["n_inputs"],
                                exp["n_neurons"])
        ev, xi = traffic.s5_draws(gen, exp, traffic.stimuli(3, [1, 2, 0]),
                                  (2,))
        return inst["weight_gain"], ev, xi
    big = 2 ** 31 + 12_345
    a, b, c = make(big), make(big), make(big + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert set(a[1].unique().tolist()) <= {0.0, 1.0}


def test_main_prints_the_result_last_and_refuses_jax(monkeypatch, capsys):
    res = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
           "device": {}, "kernel_roofline_shares": {"corr": 50.0},
           "checks": {"x": {"value": 0.0, "limit": 0}}}
    args = ["--workload", "w", "--seed", "1", "--seconds", "1",
            "--trace", "1"]
    monkeypatch.setattr(runner, "run_cell", lambda *a, **k: dict(res))
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])
    assert runner.main(args, 0.0, ROOT) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0] == 'kernel_roofline_shares {"corr": 50.0}'
    last = json.loads(lines[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert err.strip().splitlines()[-1] == "check x = 0.0 (limit 0)"
    monkeypatch.setattr(runner, "forbidden_modules", lambda: ["jax"])
    assert runner.main(args, 0.0, ROOT) == 2
    assert capsys.readouterr().out == ""
