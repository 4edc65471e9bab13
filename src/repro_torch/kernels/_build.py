"""Build and load the CUDA kernels of ``repro_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at the first CUDA launch (never at import), one ``nvcc`` per source, all
started together, then one link. The library lands in ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags, so
a changed source is rebuilt and an unchanged one is reused. Each source's
compiler output (``-Xptxas -v``: registers, stack frame, spills) is kept
in ``BUILD_LOG`` and in a file beside the library, so a reused library
still reports it.

A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# -fmad=false: no contraction of a multiply and an add into one FMA, so
# the kernel rounds after every operation like PyTorch's eager kernels do
# and matches their results bit for bit. synray and synray_sparse
# accumulate with explicit fmaf (the same chain, so the two routes agree
# bit for bit) and keep the default flags, as does census (integers only).
PER_SOURCE = {
    "synray.cu": [],
    "synray_sparse.cu": [],
    "census.cu": [],
    "neuron_scan.cu": ["-fmad=false"],
    "corr.cu": ["-fmad=false"],
    "ppu_update.cu": ["-fmad=false"],
    "ppuvm_exec.cu": [],
    "stp_scan.cu": ["-fmad=false"],
}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
ARGTYPES = {
    # ev, ea, w, addr, out, flag, N, B, R, C,
    # ev strides (n, b, r), ea strides (n, b, r), w strides (n, r),
    # addr strides (n, r), out strides (n, b), const_addr, stream
    "synray_launch": [_VP] * 6 + [_I] * 4 + [_LL] * 12 + [_I, _VP],
    # ie, ii, state_in[6], params, spikes, state_out[6], v_rec, N, T, C,
    # dt, use_adex, stream
    "neuron_scan_launch": [_VP] * 7 + [_I] * 3 + [_F, _I, _VP],
    # the chain-floor probe: ie, ii, state_in[6], params, spikes,
    # state_out[6], N, T, C, dt, stream
    "neuron_scan_floor_launch": [_VP] * 6 + [_I] * 3 + [_F, _VP],
    # pre, post, tp0, tq0, ac0, aa0, ac, aa, tp, tq, N, T, R, C, lam, sat,
    # stream
    "corr_launch": [_VP] * 10 + [_I] * 4 + [_F, _F, _VP],
    # rows, addr, eff, w, addr_store, out, flag, N, T, K, R, C, record
    # instance stride, w strides (n, r), addr_store strides (n, r),
    # out strides (n, t), stream
    "synray_sparse_launch": [_VP] * 7 + [_I] * 5 + [_LL] * 7 + [_VP],
    # ev, ea, w, addr_store, out, flag, N, T, R, C, ev strides (t, n, r),
    # ea strides (t, n, r), w strides (n, r), addr_store strides (n, r),
    # out strides (n, t), max_events, k_cap, stream
    "synray_sparse_window_launch": [_VP] * 6 + [_I] * 4 + [_LL] * 12
                                   + [_I, _I, _VP],
    # ev, T, N, R, ev strides (t, n, r), max_events, k_cap, part, ticket,
    # out, routes, stream
    "census_launch": [_VP] + [_I] * 3 + [_LL] * 3 + [_I] * 2 + [_VP] * 5,
    # w, a_causal, a_acausal, offset, gain, mod, xi, CADC fault a, lo, hi
    # (or three nulls), w_out, elig, N, R, C, eta, cadc_scale, 1/cadc_max,
    # cadc_max, wmax, stream
    "ppu_update_launch": [_VP] * 12 + [_I] * 3 + [_F] * 5 + [_VP],
    # words, n_words, w, w_bytes, qc, qa, rates, mod, n_mod, noise, w_out,
    # regs, N, R, C, stream
    "ppuvm_exec_launch": [_VP, _I, _VP, _I] + [_VP] * 4 + [_I]
                         + [_VP] * 3 + [_I] * 3 + [_VP],
    # r0, spikes, scale, eff, r_out, T, N, R, spike strides (t, n, r),
    # scale strides (n, r), u, recovery, eff_max, r_max, census (or null),
    # max_events and k_cap of each Dale half, part, counts, ticket, routes,
    # stream
    "stp_scan_launch": [_VP] * 5 + [_I] * 3 + [_LL] * 5 + [_F] * 4 + [_VP]
                       + [_I] * 4 + [_VP] * 5,
    # the chain-floor probe: r0, spikes, scale, eff, r_out, T, N, R, spike
    # strides, scale strides, u, recovery, eff_max, r_max, threads, stream
    "stp_scan_floor_launch": [_VP] * 5 + [_I] * 3 + [_LL] * 5 + [_F] * 4
                             + [_I, _VP],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(PER_SOURCE):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(PER_SOURCE[name]).encode())
    h.update(" ".join(ARCH + COMMON).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the library; returns
    its path. Reuses a library whose hash matches the sources."""
    out = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    log_path = out.with_suffix(".log.json")
    if out.exists() and log_path.exists():
        BUILD_LOG.update(json.loads(log_path.read_text()))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for name, flags in PER_SOURCE.items():
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *ARCH, *COMMON, *flags, "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs[name] = (obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (obj, p) in procs.items():
            log, _ = p.communicate()
            BUILD_LOG[name] = log
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *(str(o) for o, _ in procs.values())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        log_path.write_text(json.dumps(BUILD_LOG))
        os.replace(tmp_lib, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for fn, argtypes in ARGTYPES.items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
