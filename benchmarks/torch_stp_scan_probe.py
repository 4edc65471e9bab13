"""The port's STP scan against another source of it on a card, at the
geometries the emulation gives it.

    python3 benchmarks/torch_stp_scan_probe.py --old FILE [--sweep]
                                               [--sass DIR] [--json FILE]

``--old`` names another ``stp_scan.cu`` whose launcher is the one the
kernel had before its census form, ``stp_scan_launch(r0, spikes, scale,
eff, r_out, T, N, R, st, sn, sr, cn, cr, u, recovery, eff_max, r_max,
stream)`` (for example the source as ``git show
<commit>:src/repro_torch/csrc/stp_scan.cu`` gives it); it is built alone
with the port's flags into ``build/probe/``.

At the main path's [T=128, 16, 256], path F's K = 2 [T=128, 2, 490] and
K = 1 [T=128, 1, 968] (one chip's rows), the closed loop's [T=256, 32],
and one instance of 490 rows (a step stride that is not a multiple of 4
floats: one float a copy) beside one of 488 (spikes at the §5
background rate with pattern bursts), the rows are:

- ``census_form``: the port's scan in its census form (both Dale halves
  at the gate's capacities of 512 columns), which these paths launch;
- ``old_composed``: what it replaced, the other source's scan then the
  census kernel on each half;
- ``scan`` and ``old``: each source's scan without the census;
- ``floor``: the port's chain floor (``chain_floor_probe``: the same
  recurrence and stores with each lane's first 8 spikes in registers).

Each is held to the plain version first (bit for bit; the censuses equal;
the floor on the spikes it reuses), then all are timed in turns as
``chip_smoke.py`` times a kernel (median of CUDA-event timings behind a
device-side sleep): four rounds, the order reversed every other round;
each row's median over the rounds is printed with the rounds.

With ``--sweep``, one warp's worth of rows (R = 32, no prefix) at T = 32
to 1024: the floor and both scans, each fitted to a + b T (least
squares): b is a step's cost on the chain, a what a launch costs whatever
its length. With ``--sass``: each library's ``cuobjdump -sass`` of its STP
functions and the ``-Xptxas -v`` reports written into DIR, and each
function's instructions counted by opcode. Compare numbers only within one
run: the card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
_VP, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_longlong)
OLD_ARGTYPES = [_VP] * 5 + [_I] * 3 + [_LL] * 5 + [_F] * 4 + [_VP]
# name -> (T, prefix, R)
SHAPES = {"main": (128, (16,), 256), "path_f_k2": (128, (2,), 490),
          "path_f_k1": (128, (), 968), "loop": (256, (), 32),
          "rows_490": (128, (), 490), "rows_488": (128, (), 488)}


def build_old(path: Path):
    """Compile another stp_scan.cu alone with the port's flags; returns
    (library, -Xptxas -v report, library path)."""
    from repro_torch.kernels import _build
    out_dir = REPO / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "old_stp_scan.so"
    done = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.COMMON,
                           *_build.PER_SOURCE["stp_scan.cu"], "-shared",
                           str(path), "-o", str(lib)], capture_output=True,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{done.stderr[-2000:]}")
    handle = ctypes.CDLL(str(lib))
    handle.stp_scan_launch.argtypes = OLD_ARGTYPES
    handle.stp_scan_launch.restype = ctypes.c_int
    return handle, done.stdout + done.stderr, lib


def old_scan(handle, r0, sp, sc, u, recovery):
    """The other source's kernel on the port's operands."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.stp_scan import ops
    (T, N, R), args, eff, r_out = ops._operands(r0, sp, sc, "old stp_scan")
    err = handle.stp_scan_launch(
        *args, float(u), float(recovery), ops.EFF_MAX, ops.R_MAX,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "old stp_scan")
    return eff.reshape(T, *r0.shape), r_out.reshape(r0.shape)


def sass(lib: Path, out_dir: Path, tag: str) -> dict:
    """cuobjdump -sass of the library's STP functions, written to DIR;
    returns {function: {opcode: count}}."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, counts, name = {}, {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "stp" in m.group(1) else None
            if name:
                funcs[name], counts[name] = [], collections.Counter()
            continue
        if name is None:
            continue
        funcs[name].append(line)
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m:
            counts[name][m.group(1).split(".")[0]] += 1
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.sass").write_text("\n".join(
        f"Function : {f}\n" + "\n".join(lines) for f, lines in funcs.items()))
    return {f: dict(c.most_common()) for f, c in counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="another stp_scan.cu to time")
    ap.add_argument("--sass", type=Path, help="write SASS and reports here")
    ap.add_argument("--json", help="also write the rows to this file")
    ap.add_argument("--sweep", action="store_true",
                    help="also fit one warp's times over T = 32..1024")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_stp_scan_probe.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core import stp, synapse
    from repro_torch.kernels import _build
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.stp_scan import ops
    from repro_torch.kernels.stp_scan.ref import (stp_scan_census_ref,
                                                  stp_scan_ref)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib_path = _build.build()
    _build.lib()
    old = build_old(args.old)
    kw = dict(u=0.2, recovery=stp.recovery_factor(20.0, 0.2))
    rng = np.random.default_rng(0)

    def bits(x):
        return x.contiguous().view(torch.int32)

    def same(got, want):
        return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    rows = {}
    for name, (T, prefix, R) in SHAPES.items():
        sp = rng.random((T, *prefix, R)) < chip_smoke.BG_PROB
        k = R // 6
        sp[::16, ..., :k] |= rng.random(sp[::16, ..., :k].shape) < 0.8
        sp = torch.from_numpy(sp.astype(np.float32)).cuda()
        r0 = torch.from_numpy(rng.random((*prefix, R)).astype(
            np.float32)).cuda()
        sc = torch.from_numpy(rng.normal(1.0, 0.25, (*prefix, R)).astype(
            np.float32)).cuda()
        want = stp_scan_ref(r0, sp, sc, **kw)
        sp8 = sp[torch.arange(T, device=sp.device) % 8]
        want8 = stp_scan_ref(r0, sp8, sc, **kw)
        caps = tuple(synapse.route_plan(T, len(range(h, R, 2)), 512,
                                        const_addr=True, sparse="always")[1:]
                     for h in (0, 1))
        want_c = stp_scan_census_ref(r0, sp, sc, caps=caps, **kw)

        def old_composed():
            eff, r_T = old_scan(old[0], r0, sp, sc, **kw)
            return (eff, r_T, *(census_ops.census(eff[..., h::2], *caps[h])
                                for h in (0, 1)))
        fns = {
            "census_form": (lambda: ops.stp_scan(r0, sp, sc, caps=caps,
                                                 **kw), want_c),
            "old_composed": (old_composed, want_c),
            "scan": (lambda: ops.stp_scan(r0, sp, sc, **kw), want),
            "old": (lambda: old_scan(old[0], r0, sp, sc, **kw), want),
            "floor": (lambda: ops.chain_floor_probe(r0, sp, sc, **kw),
                      want8)}
        for label, (fn, w) in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not same(got, w):
                raise AssertionError(f"{name} {label}: differs from the "
                                     "plain version")
        times = {label: [] for label in fns}
        for i in range(4):
            order = list(fns) if i % 2 == 0 else list(fns)[::-1]
            for label in order:
                times[label].append(chip_smoke.time_ms(fns[label][0], 25))
        rows[name] = {label: dict(ms=float(np.median(v)), rounds=v)
                      for label, v in times.items()}
        print(f"{name} [T={T}, {prefix}, R={R}]: " + "; ".join(
            f"{label} {r['ms']:.4f} ms [" + ", ".join(
                f"{t:.4f}" for t in r["rounds"]) + "]"
            for label, r in rows[name].items()), flush=True)
    report = {"device": smi, "rows": rows}
    if args.sweep:
        Ts = (32, 64, 128, 256, 512, 1024)
        sweep = {}
        for T in Ts:
            sp = torch.from_numpy((rng.random((T, 32)) < chip_smoke.BG_PROB
                                   ).astype(np.float32)).cuda()
            r0 = torch.from_numpy(rng.random(32).astype(np.float32)).cuda()
            sc = torch.from_numpy(rng.normal(1.0, 0.25, 32).astype(
                np.float32)).cuda()
            fns = {"floor": lambda: ops.chain_floor_probe(r0, sp, sc, **kw),
                   "scan": lambda: ops.stp_scan(r0, sp, sc, **kw),
                   "old": lambda: old_scan(old[0], r0, sp, sc, **kw)}
            for label, fn in fns.items():
                sweep.setdefault(label, []).append(
                    chip_smoke.time_ms(fn, 25))
        fit = {}
        for label, ms in sweep.items():
            b, a = np.polyfit(np.asarray(Ts, float), np.asarray(ms), 1)
            fit[label] = dict(ms=ms, a_ms=float(a), b_ns=float(b * 1e6))
            print(f"sweep {label} at R=32, T={list(Ts)}: "
                  + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms; fit {a:.4f} ms + {b * 1e6:.2f} ns a step",
                  flush=True)
        report["sweep"] = fit
    if args.sass:
        report["sass"] = {"port": sass(lib_path, args.sass, "port"),
                          "old": sass(old[2], args.sass, "old")}
        (args.sass / "ptxas_port.txt").write_text(
            _build.BUILD_LOG.get("stp_scan.cu", ""))
        (args.sass / "ptxas_old.txt").write_text(old[1])
        for tag, funcs in report["sass"].items():
            for fn, c in funcs.items():
                print(f"sass {tag} {fn}: {sum(c.values())} instructions: "
                      + ", ".join(f"{k} {v}" for k, v in c.items()))
        for tag, log in (("port", _build.BUILD_LOG.get("stp_scan.cu", "")),
                         ("old", old[1])):
            for line in log.splitlines():
                if "registers" in line or "stack" in line:
                    print(f"ptxas {tag}: {line.strip()}")
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
