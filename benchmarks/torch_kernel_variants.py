"""Time variants of the port's CUDA kernels on a card.

    python3 benchmarks/torch_kernel_variants.py [--json FILE] [--kernel K]

A variant is a kernel source of ``src/repro_torch/csrc`` with some of its
``constexpr int`` constants changed (block shape, chunk length) or one of
the edits of ``EDITS`` made (``stp_scan``'s index type and clamp body).
Each is built with the port's own nvcc flags into a library of its own
under ``build/variants/``, run through the port's wrapper on the main
path's shapes, held against the plain version (bit for bit;
``synray_sparse``, which sums in another order, within 1e-4; a timing aid
of ``AIDS``, which is not the kernel's function, is not held) and timed as
``chip_smoke.py`` times a kernel (median of CUDA-event timings behind a
device-side sleep). The first variant of each kernel is the source as it
is. Compare variants only within one run: the card's clocks and power
limit differ between calls (the card's name and limit are printed).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# kernel -> constants to change; {} is the source as it is
VARIANTS = {
    "neuron_scan": [{}, {"TC": 32}, {"TC": 32, "THREADS": 64}, {"TC": 16}],
    "ppuvm_exec": [{}, {"TY": 8}, {"TY": 2}, {"TX": 16, "TY": 8},
                   {"TX": 64, "TY": 2}, {"K": 8}],
    "synray_sparse": [{}, {"CW": 1}, {"CW": 1, "NW": 8, "UPW": 16},
                      {"NW": 8, "UPW": 16}, {"UPW": 4}],
    "stp_scan": [{}, {"NS": 2}, {"NS": 3}, {"MAX_THREADS": 128},
                 {"MAX_THREADS": 64}, {"Idx": "int"}, {"clamp": "select"},
                 {"clamp": "no_nan_rule"}, {"clamp": "no_clamp"}],
}
# edits other than a constexpr int: key -> (pattern whose group 1 is
# kept, the text that replaces the rest for a value); the clamp bodies
# are PyTorch's NaN rule as a select (the earlier form), the clamp
# without the NaN rule and no clamp at all
CLAMP_BODIES = {"select": "isnan(v) ? v : fminf(fmaxf(v, lo), hi);",
                "no_nan_rule": "fminf(fmaxf(v, lo), hi);",
                "no_clamp": "v;"}
EDITS = {
    "Idx": (r"()using Idx = [\w ]+;", lambda v: f"using Idx = {v};"),
    "clamp": (r"(float clamp_like_torch\(float v, float lo,\s*"
              r"float hi\) \{\n)\s*return [^;]*;",
              lambda v: "  return " + CLAMP_BODIES[v]),
}
# timing aids: variants that are not the kernel's function
AIDS = ({"clamp": "no_nan_rule"}, {"clamp": "no_clamp"})
LAUNCHERS = {"neuron_scan": ("neuron_scan_launch",
                             "neuron_scan_floor_launch"),
             "ppuvm_exec": ("ppuvm_exec_launch",),
             "synray_sparse": ("synray_sparse_window_launch",),
             "stp_scan": ("stp_scan_launch", "stp_scan_floor_launch")}


def variant_source(name: str, consts: dict) -> str:
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{name}.cu").read_text()
    for const, value in consts.items():
        if const in EDITS:
            pattern, edit = EDITS[const]
            text, n = re.subn(pattern,
                              lambda m: m.group(1) + edit(value), text)
        else:
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
        if n != 1:
            raise ValueError(f"{name}.cu has no {const} to change")
    return text


def build_variant(name: str, consts: dict) -> ctypes.CDLL:
    """Compile one variant with the port's flags; load it with the port's
    ctypes signatures."""
    from repro_torch.kernels import _build
    text = variant_source(name, consts)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    out_dir = REPO / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}_{tag}.cu", out_dir / f"{name}_{tag}.so"
    if not lib.exists():
        src.write_text(text)
        done = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.COMMON,
                               *_build.PER_SOURCE[f"{name}.cu"], "-shared",
                               str(src), "-o", str(lib)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {consts}:\n"
                               + done.stderr[-2000:])
    handle = ctypes.CDLL(str(lib))
    for fn in LAUNCHERS[name]:
        f = getattr(handle, fn)
        f.argtypes = _build.ARGTYPES[fn]
        f.restype = ctypes.c_int
    return handle


def neuron_case():
    """Phase 2's neuron_scan window: 16 x 512 columns, T = 128, a drive
    that fires."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core import adex
    from repro_torch.kernels.neuron_scan import ops
    from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
    rng = np.random.default_rng(0)
    T, N, C = 128, 16, 512
    params, decays = chip_smoke._instance_params((N,), 256, C, seed=1)

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).cuda()
    ie = dev((rng.random((T, N, C)) < 0.1) * rng.uniform(0, 600, (T, N, C)))
    ii = dev((rng.random((T, N, C)) < 0.05) * rng.uniform(0, 100, (T, N, C)))
    s0 = adex.init_state((N, C), params)
    rc0 = torch.zeros((N, C), device="cuda")
    packed = ops.pack_params(params, decays, (N, C))
    kw = dict(dt=0.2, decays=decays, packed_params=packed)
    want = neuron_window_ref(s0, rc0, ie, ii, params, use_adex=True, dt=0.2,
                             decays=decays)

    def run():
        return ops.neuron_window(s0, rc0, ie, ii, params, use_adex=True, **kw)

    def check(got):
        return all(torch.equal(a, b) for a, b in zip(
            (*got[0], got[1], got[2][0]), (*want[0], want[1], want[2][0])))
    extra = {"chain_floor": lambda: ops.chain_floor_probe(
        s0, rc0, ie, ii, params, **kw)}
    return {"window": (run, check)}, extra


def vm_cases():
    """Phase 6's shipped programs at [16, 256, 512] on int8 weights."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_ppuvm as vmc
    from repro_torch.kernels.ppuvm_exec import ops
    from repro_torch.kernels.ppuvm_exec.ref import run_program_ref
    ops_np = vmc.prefixed_operands(np.random.RandomState(11), (16, 256, 512))
    ops_np["weights"] = ops_np["weights"].astype(np.int8)
    cases = {}
    for name, o in (("signed_dw", dict(ops_np, noise=None)),
                    ("rstdp", dict(ops_np, mod=ops_np["mod"][:1])),
                    ("no_words", dict(ops_np, noise=None))):
        # no_words: the loads and stores alone, the kernel's memory floor
        words = torch.as_tensor(vmc.shipped_programs().get(name, []),
                                dtype=torch.int32, device="cuda")
        args = tuple(None if o.get(k) is None else torch.from_numpy(
            np.ascontiguousarray(o[k])).cuda() for k in (
                "weights", "qc", "qa", "rates", "mod", "noise"))
        want = run_program_ref(words, *args)

        def run(words=words, args=args):
            return ops.run_program(words, *args)

        def check(got, want=want):
            return all(torch.equal(a, b) for a, b in zip(got, want))
        cases[name] = (run, check)
    return cases, {}


def sparse_cases():
    """Phase 2's no-stimulus Dale half (16 instances, T = 128, 128 rows
    read in place from the [T, 16, 256] planes, 512 columns), the window
    form against its plain version on the card: gated (behind the
    census's flag, as the route runs it; the census is taken once, with
    the port's own library) and ordered (no flag, as sparse="always"
    runs it)."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core import events
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.synray_sparse import ops
    from repro_torch.kernels.synray_sparse.ref import sparse_window_ref
    rng = np.random.default_rng(0)
    T, N, R, C = 128, 16, 256, 512

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()
    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))[:, 0::2]
    st = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))[:, 0::2]
    ev = dev((rng.random((T, N, R)) < chip_smoke.BG_PROB).astype(np.float32)
             * rng.uniform(0.2, 1.2, (T, N, R)).astype(np.float32))[..., 0::2]
    ea = dev(np.broadcast_to(rng.integers(0, 4, (N, R), dtype=np.int8),
                             (T, N, R)))[..., 0::2]
    kw = dict(max_events=chip_smoke.MAX_EVENTS, k_cap=chip_smoke.K_CAP)
    recs = events.regroup_window(ev.permute(1, 0, 2), ea.permute(1, 0, 2),
                                 kw["max_events"], kw["k_cap"])
    want = sparse_window_ref(*recs, w, st).permute(1, 0, 2)
    flag = census_ops.census(ev, kw["max_events"], kw["k_cap"])

    def gated():
        return ops.sparse_current_window(ev, ea, w, st, flag=flag, **kw)

    def ordered():
        return ops.sparse_current_window(ev, ea, w, st, **kw)

    def check(got):
        return bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
    return {"gated": (gated, check), "ordered": (ordered, check)}, {}


def stp_cases():
    """Phase 2's stp_scan windows: the main path's [T=128, 16, 256] and the
    closed loop's [T=256, 32], at the §5 background rate; at the main
    shape also the census form (both Dale halves' censuses at the
    const_addr capacities of 512 columns), and the chain floor of each
    (with the scan's block: ``MAX_THREADS`` does not change it)."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core import stp, synapse
    from repro_torch.kernels.stp_scan import ops
    from repro_torch.kernels.stp_scan.ref import (stp_scan_census_ref,
                                                  stp_scan_ref)
    rng = np.random.default_rng(0)
    kw = dict(u=0.2, recovery=stp.recovery_factor(20.0, 0.2))
    cases, extra = {}, {}
    for name, shape in (("main", (128, 16, 256)), ("loop", (256, 32))):
        sp = torch.from_numpy((rng.random(shape) < chip_smoke.BG_PROB
                               ).astype(np.float32)).cuda()
        r0 = torch.from_numpy(rng.random(shape[1:]).astype(np.float32)).cuda()
        sc = torch.from_numpy(rng.normal(1.0, 0.25, shape[1:]).astype(
            np.float32)).cuda()
        want = stp_scan_ref(r0, sp, sc, **kw)

        def run(r0=r0, sp=sp, sc=sc):
            return ops.stp_scan(r0, sp, sc, **kw)

        def check(got, want=want):
            return all(torch.equal(a, b) for a, b in zip(got, want))
        cases[name] = (run, check)
        extra[f"{name}_floor"] = (lambda r0=r0, sp=sp, sc=sc:
                                  ops.chain_floor_probe(r0, sp, sc, **kw))
        if name != "main":
            continue
        R = shape[-1]
        caps = tuple(synapse.route_plan(shape[0], len(range(h, R, 2)), 512,
                                        const_addr=True)[1:] for h in (0, 1))
        want_c = stp_scan_census_ref(r0, sp, sc, caps=caps, **kw)

        def run_c(r0=r0, sp=sp, sc=sc):
            return ops.stp_scan(r0, sp, sc, caps=caps, **kw)

        def check_c(got):
            return all(torch.equal(a, b) for a, b in zip(got, want_c))
        cases["main_census"] = (run_c, check_c)
    return cases, extra


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the rows to this file")
    ap.add_argument("--kernel", action="append", choices=sorted(VARIANTS),
                    help="only this kernel's variants (repeatable)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rows = []
    makers = {"neuron_scan": neuron_case, "ppuvm_exec": vm_cases,
              "synray_sparse": sparse_cases, "stp_scan": stp_cases}
    for name in args.kernel or makers:
        cases, extra = makers[name]()
        for consts in VARIANTS[name]:
            _build._lib = build_variant(name, consts)
            row = dict(kernel=name, consts=consts)
            for case, (run, check) in cases.items():
                if consts not in AIDS and not check(run()):
                    raise AssertionError(f"{name} {consts} {case}: differs "
                                         "from the plain version")
                row[f"{case}_ms"] = chip_smoke.time_ms(run, 25)
            for case, fn in extra.items():
                row[f"{case}_ms"] = chip_smoke.time_ms(fn, 25)
            rows.append(row)
            print(json.dumps(row), flush=True)
    _build._lib = None
    if args.json:
        Path(args.json).write_text(json.dumps(dict(device=smi, rows=rows),
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
