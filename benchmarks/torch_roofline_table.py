"""Render the port's roofline table from its dry-run results JSON.

    PYTHONPATH=src python benchmarks/torch_roofline_table.py [FILE]

The counterpart of ``benchmarks/roofline_table.py`` for
``results/torch_dryrun.json`` (``python -m repro_torch.launch.dryrun
--all --mesh both --include-bss2``). MODEL_FLOPS-based metrics are
re-derived with the current config code and the port's H100 ``HW``
(``HW.peak_flops_bf16``). Every row is a full-depth count on its mesh, so
multi-pod rows are roofline rows too (the reference's multi-pod rows are
costed through a scan and only prove the sharding). ``fits`` says
whether ``arg_bytes + temp_bytes`` fit in ``HW.hbm_bytes``.
"""
import json
import sys
from pathlib import Path

RESULTS = Path(__file__).resolve().parent.parent / "results" / \
    "torch_dryrun.json"


def _recompute(r):
    """Re-derive MODEL_FLOPS-based metrics with the current config code
    (the BSS-2 cell keeps its own MODEL_FLOPS)."""
    from repro_torch.analysis.roofline import model_flops_for
    from repro_torch.config import HW, SHAPES, get_arch
    r = dict(r)
    if r["arch"] != "bss2":
        r["model_flops_global"] = model_flops_for(get_arch(r["arch"]),
                                                  SHAPES[r["shape"]])
    mf = r["model_flops_global"]
    r["useful_flops_ratio"] = mf / max(r["flops_per_dev"] * r["n_devices"],
                                       1.0)
    r["mfu"] = mf / (r["n_devices"] * HW.peak_flops_bf16 * max(
        r["t_compute"], r["t_memory"], r["t_collective"]))
    return r


def fmt_row(r):
    if r["status"] == "SKIP":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP — "
                f"{r['reason']} | | | | | | |")
    if r["status"] != "OK":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | FAIL "
                f"| | | | | | |")
    r = _recompute(r)
    return ("| {arch} | {shape} | {mesh} | {tc:.2e} | {tm:.2e} | {tcoll:.2e} "
            "| {bn} | {ratio:.3f} | {mfu:.2%} | {fits} |").format(
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"], tc=r["t_compute"],
        tm=r["t_memory"], tcoll=r["t_collective"], bn=r["bottleneck"],
        ratio=r["useful_flops_ratio"], mfu=r["mfu"],
        fits="yes" if r["fits_hbm"] else
        f"no ({(r['arg_bytes'] + r['temp_bytes']) / 1e9:.0f} GB)")


def run(path=RESULTS):
    path = Path(path)
    if not path.exists():
        print(f"(no dry-run results at {path} — run "
              "repro_torch.launch.dryrun)")
        return dict(name="torch_roofline", cells=0)
    recs = json.loads(path.read_text())
    print("| arch | shape | mesh | t_compute(s) | t_memory(s) | t_coll(s) "
          "| bottleneck | 6ND/recorded | MFU@roofline | fits 80 GB |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    order = sorted(recs.values(), key=lambda r: (r["mesh"], r["arch"],
                                                 r["shape"]))
    for r in order:
        print(fmt_row(r))
    n_ok = sum(1 for r in recs.values() if r["status"] == "OK")
    print(f"\n{n_ok} OK / {len(recs)} cells")
    return dict(name="torch_roofline", cells=n_ok)


if __name__ == "__main__":
    run(*sys.argv[1:])
