"""Structured run reports: counters + timings + config + provenance.

The commissioning workflow the follow-on paper describes ("From Clean
Room to Machine Room") starts every debugging session from a run report:
what ran, on which commit and device, what the health counters said,
where the time went (``repro/obs/report.py``). ``build_report`` merges
those sections into one JSON-able dict; ``to_markdown`` renders it for
humans; ``write_report`` persists both.
``examples/torch_telemetry_report.py`` emits one.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD commit of the repo containing ``cwd`` (default: this file)."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return None


def host_header() -> dict:
    """Provenance header: commit, PyTorch version, the CUDA device's name
    (``None`` without a card) and the AnnCore backend "auto" picks there
    (reports travel across machines)."""
    import torch
    card = torch.cuda.is_available()
    return dict(git_sha=git_sha(), torch_version=torch.__version__,
                cuda_device=torch.cuda.get_device_name(0) if card else None,
                anncore_backend="blocked" if card else "fused")


def jsonable(x):
    """Best-effort conversion of numpy/torch scalars and containers."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return repr(x)


def _config_section(config) -> Optional[dict]:
    """Dataclass / NamedTuple / dict config -> JSON-able dict."""
    if config is None:
        return None
    import dataclasses
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return jsonable(dataclasses.asdict(config))
    if hasattr(config, "_asdict"):
        return jsonable(config._asdict())
    if isinstance(config, dict):
        return jsonable(config)
    return {"repr": repr(config)}


def build_report(label: str, telemetry: Optional[dict] = None,
                 timings: Optional[dict] = None,
                 cache: Optional[dict] = None,
                 config=None, extra: Optional[dict] = None) -> dict:
    """Merge one run's observability sections into a report dict.

    ``telemetry``: ``repro_torch.obs.trace.summary`` output; ``timings``:
    ``PhaseTimer.summary`` output; ``cache``: specializer-cache stats (a
    dict with hits / misses / evictions / size / max_size; the port has
    no such cache, ROADMAP.md); ``config``: any dataclass/NamedTuple/dict.
    Health warnings (overflow fallbacks, saturation, eviction storms)
    are derived here so every emitter surfaces them uniformly.
    """
    from repro_torch.obs.timing import eviction_storm

    report = dict(label=label,
                  timestamp=time.strftime("%Y-%m-%dT%H:%M:%S"),
                  **host_header())
    warnings = []
    if telemetry is not None:
        report["telemetry"] = jsonable(telemetry)
        if telemetry.get("overflow_fallbacks", 0) > 0:
            warnings.append(
                f"{telemetry['overflow_fallbacks']} sparse-gate capacity "
                f"overflow(s) fell back to dense (census max "
                f"{telemetry.get('census_events_max')} events) — raise "
                "sparse_max_events/sparse_threshold to keep the sparse "
                "path")
        if telemetry.get("vm_sat_hits", 0) > 0:
            warnings.append(
                f"{telemetry['vm_sat_hits']} PPU-VM register lanes ended "
                "on the Q8.8 saturation rails (0x7FFF/0x8000) — the rule "
                "clips; rescale its operands if unintended")
    if timings is not None:
        report["timings"] = jsonable(timings)
    if cache is not None:
        report["specialize_cache"] = jsonable(cache)
        if eviction_storm(cache):
            warnings.append(
                f"specializer-cache eviction storm: {cache['misses']} "
                f"misses exceed the LRU capacity ({cache['max_size']}) "
                "within this run")
    if config is not None:
        report["config"] = _config_section(config)
    if extra:
        report["extra"] = jsonable(extra)
    report["warnings"] = warnings
    return report


def to_markdown(report: dict) -> str:
    """Human-readable rendering of ``build_report`` output."""
    lines = [f"# Run report — {report.get('label', '?')}", ""]
    lines.append(f"- timestamp: `{report.get('timestamp')}`")
    lines.append(f"- git: `{report.get('git_sha')}`")
    lines.append(f"- torch `{report.get('torch_version')}`, device "
                 f"`{report.get('cuda_device')}` "
                 f"(anncore `{report.get('anncore_backend')}`)")
    for w in report.get("warnings", []):
        lines.append(f"- **WARNING**: {w}")
    tele = report.get("telemetry")
    if tele:
        lines += ["", "## Counters", "", "| counter | value |",
                  "|---|---|"]
        hist_keys = ("dw_hist", "dw_hist_edges")
        for k, v in tele.items():
            if k not in hist_keys:
                lines.append(f"| {k} | {v} |")
        if "dw_hist" in tele:
            edges = tele.get("dw_hist_edges", [])
            labels = (["<%g" % edges[0]]
                      + ["≥%g" % e for e in edges]) if edges else []
            pairs = ", ".join(f"{l}:{n}" for l, n in
                              zip(labels, tele["dw_hist"]) if n)
            lines.append(f"| dw_hist (\\|dw\\| LSBs) | {pairs or '0'} |")
    tim = report.get("timings")
    if tim:
        lines += ["", "## Phase timings", "",
                  "| phase | mean us | best us | calls |", "|---|---|---|---|"]
        for name, s in tim.items():
            lines.append(f"| {name} | {s['mean_us']:.1f} | "
                         f"{s['best_us']:.1f} | {s['count']} |")
    cache = report.get("specialize_cache")
    if cache:
        lines += ["", "## Specializer cache", "",
                  "| hits | misses | evictions | size/cap |", "|---|---|---|---|"]
        lines.append(f"| {cache.get('hits')} | {cache.get('misses')} | "
                     f"{cache.get('evictions')} | {cache.get('size')}/"
                     f"{cache.get('max_size')} |")
    cfgs = report.get("config")
    if cfgs:
        lines += ["", "## Config", "", "```json",
                  json.dumps(cfgs, indent=1, default=repr), "```"]
    extra = report.get("extra")
    if extra:
        lines += ["", "## Extra", "", "```json",
                  json.dumps(extra, indent=1, default=repr), "```"]
    return "\n".join(lines) + "\n"


def write_report(report: dict, json_path: str,
                 md_path: Optional[str] = None) -> dict:
    """Persist the report (JSON always; markdown beside it unless given).
    Returns ``{"json": path, "md": path}``."""
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(report, f, indent=1, default=repr)
    if md_path is None:
        md_path = os.path.splitext(json_path)[0] + ".md"
    with open(md_path, "w") as f:
        f.write(to_markdown(report))
    return dict(json=json_path, md=md_path)
