#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the CUDA kernels built from ``src/repro_torch/csrc`` (timed).
2. Each kernel against its plain PyTorch version on the card, at the
   main-path shapes (16 instances of the full 256 x 512 chip, T = 128),
   inputs from a numpy seed: ``neuron_scan`` and ``corr`` bit-equal,
   ``synray`` within rtol = atol = 1e-4 (it sums rows with FMAs in another
   order than the plain version's product). Times are medians of CUDA-event
   timings; ``bound_ms`` is the larger of bytes over 3.35 TB/s and
   operations over 67 TFLOP/s (float32, outside the tensor cores).
3. The main path: the §5 experiment at full width (``BSS2``, 128 inputs x
   512 neurons, 16 instances, 128 steps, ``backend="blocked"``,
   ``sparse_mode="never"``) for 6 trials. The launch counts must rise by
   exactly 2 (synray), 1 (neuron_scan) and 1 (corr) per trial; the state
   must be finite with whole-number rate counters; the first trial, rerun
   on the CPU from the same state and draws, must agree with the card
   (spikes equal up to flips at threshold, see ``phase_main_path``).
4. The §5 closed loop at the default 32 x 16 geometry on the card: 450
   trials, the port's own generator, seed 0; both populations' trailing
   median reward must exceed 0.75.

Exits non-zero without a card, outside a checkout, or when any phase
fails; the last line is the JSON device record.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MEM_BW = 3.35e12        # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
SRC = {
    "synray": ("src/repro_torch/csrc/synray.cu",
               "src/repro/kernels/synray/kernel.py:48"),
    "neuron_scan": ("src/repro_torch/csrc/neuron_scan.cu",
                    "src/repro/kernels/neuron_scan/kernel.py:96"),
    "corr": ("src/repro_torch/csrc/corr.cu",
             "src/repro/kernels/corr/kernel.py:56"),
}


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    t_b, t_o = n_bytes / MEM_BW, n_ops / FP32_PEAK
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def time_ms(fn, reps):
    """Median of CUDA-event timings of ``fn`` (after one warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(REPO)}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    return smi


def _instance_params(prefix, rows, cols, seed):
    import dataclasses
    import torch
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core import adex
    from repro_torch.verif.mismatch import sample_instance
    cfg = dataclasses.replace(BSS2, n_rows=rows, n_cols=cols)
    inst = sample_instance(cfg, torch.Generator().manual_seed(seed),
                           prefix, device="cuda")
    params = inst["neuron_params"]
    return params, adex.decay_factors(params, cfg.dt)


def phase_kernels():
    """Each kernel against its plain version at the main-path shapes."""
    import numpy as np
    import torch
    from repro_torch.core import adex
    from repro_torch.kernels.corr import ops as corr_ops
    from repro_torch.kernels.corr.ref import correlation_window_ref
    from repro_torch.kernels.neuron_scan import ops as neuron_ops
    from repro_torch.kernels.neuron_scan.ref import neuron_window_ref
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray.ref import synaptic_current_ref

    rng = np.random.default_rng(0)
    N, T, R, C = 16, 128, 256, 512
    cuda = torch.device("cuda")

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    rows = {}

    # synray: one Dale half (every other row of the [N, R, C] store, read
    # in place) against the full event window of that half
    w = dev(rng.integers(0, 64, (N, R, C), dtype=np.int8))
    st = dev(rng.integers(0, 4, (N, R, C), dtype=np.int8))
    ev_full = dev((rng.random((T, N, R)) < 0.05).astype(np.float32)
                  * rng.uniform(0.2, 1.2, (T, N, R)).astype(np.float32))
    ea_row = rng.integers(0, 4, (N, R), dtype=np.int8)
    ea_full = dev(np.broadcast_to(ea_row, (T, N, R)))   # const_addr form
    w_h, st_h = w[:, 0::2, :], st[:, 0::2, :]
    ev, ea = ev_full[..., 0::2], ea_full[..., 0::2]
    got = synray_ops.synaptic_current(ev, ea, w_h, st_h)
    want = synaptic_current_ref(ev, ea, w_h, st_h)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    err = float((got - want).abs().max())
    match = (st_h == dev(ea_row[:, 0::2]).unsqueeze(-1))
    w_eff = (w_h.float() * match.float())                 # [N, R/2, C]
    ev_n = ev.permute(1, 0, 2).contiguous()               # [N, T, R/2]
    lib_ms = time_ms(lambda: torch.bmm(ev_n, w_eff), 25)
    nz = (ev != 0).float()                                # [T, N, R/2]
    n_fma = float(torch.einsum("tnr,nr->", nz, match.float().sum(-1)))
    Rh = R // 2
    n_bytes = T * N * Rh * 5 + 2 * N * Rh * C + T * N * C * 4
    b_ms, b_by = bound_ms(n_bytes, 2 * n_fma)
    rows["synray"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        ms=time_ms(lambda: synray_ops.synaptic_current(ev, ea, w_h, st_h),
                   25),
        plain_ms=time_ms(lambda: synaptic_current_ref(ev, ea, w_h, st_h),
                         5))

    # neuron_scan: a drive that makes the neurons fire
    params, decays = _instance_params((N,), R, C, seed=1)
    ie = dev((rng.random((T, N, C)) < 0.1).astype(np.float32)
             * rng.uniform(0, 600, (T, N, C)).astype(np.float32))
    ii = dev((rng.random((T, N, C)) < 0.05).astype(np.float32)
             * rng.uniform(0, 100, (T, N, C)).astype(np.float32))
    s0 = adex.init_state((N, C), params)
    rc0 = torch.zeros((N, C), device=cuda)
    kw = dict(dt=0.2, use_adex=True, decays=decays)
    g_state, g_rc, g_recs = neuron_ops.neuron_window(s0, rc0, ie, ii,
                                                     params, **kw)
    p_state, p_rc, p_recs = neuron_window_ref(s0, rc0, ie, ii, params,
                                              **kw)
    torch.cuda.synchronize()
    n_spk = float(g_recs[0].sum())
    if n_spk == 0:
        raise AssertionError("neuron_scan: the test drive elicited no spike")
    for name, a, b in zip(("spikes", "rate_counters", *g_state._fields),
                          (g_recs[0], g_rc, *g_state),
                          (p_recs[0], p_rc, *p_state)):
        if not torch.equal(a, b):
            raise AssertionError(f"neuron_scan: {name} differs from the "
                                 f"plain version (max |diff| "
                                 f"{float((a - b).abs().max())})")
    n_bytes = (2 * T * N * C + 6 * N * C + 12 * N * C + T * N * C
               + 6 * N * C) * 4
    b_ms, b_by = bound_ms(n_bytes, 30 * T * N * C)   # ~30 flops a step
    rows["neuron_scan"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=time_ms(lambda: neuron_ops.neuron_window(s0, rc0, ie, ii, params,
                                                    **kw), 25),
        plain_ms=time_ms(lambda: neuron_window_ref(s0, rc0, ie, ii, params,
                                                   **kw), 3))
    log(f"    neuron_scan test drive: {n_spk:.0f} spikes")

    # corr: accumulators spread over [0, sat] so the clamp is exercised
    pre = dev((rng.random((T, N, R)) < 0.05).astype(np.float32))
    post = dev((rng.random((T, N, C)) < 0.05).astype(np.float32))
    tp0 = dev(rng.random((N, R), dtype=np.float32))
    tq0 = dev(rng.random((N, C), dtype=np.float32))
    ac0 = dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32))
    aa0 = dev(rng.uniform(0, 1023, (N, R, C)).astype(np.float32))
    lam = float(np.exp(-0.2 / 5.0))
    got = corr_ops.correlation_window(pre, post, tp0, tq0, ac0, aa0, lam=lam)
    want = correlation_window_ref(pre, post, tp0, tq0, ac0, aa0, lam=lam)
    torch.cuda.synchronize()
    for name, a, b in zip(("a_causal", "a_acausal", "tp", "tq"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"corr: {name} differs from the plain "
                                 f"version (max |diff| "
                                 f"{float((a - b).abs().max())})")
    # operations this data needs: a post spike updates a column of a_c
    # and a pre spike a row of a_a (multiply, add, min each)
    n_ops = 3 * (float(post.sum()) * R + float(pre.sum()) * C)
    n_bytes = (T * N * (R + C) + 2 * N * (R + C) + 4 * N * R * C) * 4
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    rows["corr"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=time_ms(lambda: corr_ops.correlation_window(
            pre, post, tp0, tq0, ac0, aa0, lam=lam), 25),
        plain_ms=time_ms(lambda: correlation_window_ref(
            pre, post, tp0, tq0, ac0, aa0, lam=lam), 3))
    for name, r in rows.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[2] {name}: kernel_ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={lib} bound_ms="
            f"{r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err="
            f"{r['max_abs_err']:.3g}")
    return rows


def _to(tree, device):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(*(_to(v, device) for v in tree))


def phase_main_path():
    """The full-width §5 slice: 6 trials of 16 instances of the chip."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.bss2 import BSS2
    from repro_torch.core.hybrid import RSTDPConfig, make_experiment

    ecfg = RSTDPConfig(n_inputs=128, n_neurons=512, pattern_size=24,
                       trial_steps=128)
    kw = dict(cfg=BSS2, ecfg=ecfg, prefix=(16,), backend="blocked",
              sparse_mode="never")
    init, trial, meta = make_experiment(
        generator=torch.Generator().manual_seed(11), device="cuda", **kw)
    stims = [1, 2, 0, 1, 2, 0]
    draws = meta["draw"](torch.Generator().manual_seed(12), stims)
    state0 = init()

    kernels.reset_launches()
    times, states, metrics = [], [], []
    state = state0
    for i, stim in enumerate(stims):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trial(state, stim, draws.events[i], draws.xi[i])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        states.append(state)
        metrics.append(m)
    counts = dict(kernels.LAUNCHES)
    n = len(stims)
    want = {"synray": 2 * n, "neuron_scan": n, "corr": n}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")

    leaves = [x for x in _flatten(state)]
    for x in leaves:
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite state after the full-width run")
    for m in metrics:
        if not bool((m["rates"] == torch.round(m["rates"])).all()):
            raise AssertionError("rate counters are not whole numbers")
    total_spikes = float(sum(m["rates"].sum() for m in metrics))
    log(f"[3] full width 16 x 256 x 512, T=128: trial_ms="
        f"{sorted(times)[len(times) // 2]:.3f} (median of {n}; first "
        f"{times[0]:.3f}) launches={counts} spikes={total_spikes:.0f}")

    # the first trial again on the CPU (plain versions), same state/draws
    cpu = torch.device("cpu")
    init_c, trial_c, meta_c = make_experiment(
        inst=_to(meta["inst"], cpu), device="cpu", **kw)
    s_c, m_c = trial_c(_to(state0, cpu), stims[0],
                       draws.events[0].cpu(), draws.xi[0].cpu())
    core_g, core_c = meta["core"], meta_c["core"]
    addr = torch.zeros(draws.events[0].shape, dtype=torch.int8)
    _, out_g = core_g.run(state0.core, draws.events[0], addr.cuda(),
                          record_v=True)
    _, out_c = core_c.run(_to(state0.core, cpu), draws.events[0].cpu(), addr,
                          record_v=True)
    spk_g, spk_c = out_g["spikes"].cpu(), out_c["spikes"]
    # Spikes must agree, except that one may flip where the membrane of the
    # run that did not spike lies within rtol = atol = 1e-4 of the spike
    # threshold: the CPU's exp and the card's expf differ by an ulp, and
    # the synaptic sums run in another order. A flip changes only its own
    # column (no recurrent synapses): rate counter, reward, correlation
    # column and weights. Those columns are left out below; everything
    # else must be exact (weights within 1e-4 / one code at a .5 tie).
    flips = spk_g != spk_c
    p = meta_c["inst"]["neuron_params"]
    thr = p["v_thres"] + 2.0 * p["delta_t"]
    v_quiet = torch.where(spk_c == 0, out_c["v"], out_g["v"].cpu())
    near = (v_quiet - thr).abs() <= 1e-4 + 1e-4 * thr.abs()
    if bool((flips & ~near).any()):
        raise AssertionError("first trial: a spike differs between the card "
                             "and the CPU away from threshold")
    cols = flips.any(0)                                   # [N, C]
    if int(cols.sum()) > max(1, cols.numel() // 1000):
        raise AssertionError(f"first trial: {int(cols.sum())} columns with "
                             "spike flips")
    keep = ~cols
    m_g, s_g = metrics[0], states[0]
    if not torch.equal(m_g["rates"].cpu()[keep], m_c["rates"][keep]):
        raise AssertionError("first trial: rate counters differ")
    dws = (s_g.w_signed.cpu() - s_c.w_signed).abs()
    dw = float(dws.masked_fill(cols.unsqueeze(-2), 0).max())
    if dw > 1e-4:
        raise AssertionError(f"first trial: w_signed differs by {dw}")
    wq_g = s_g.core.syn.weights.cpu().to(torch.int32)
    wq_c = s_c.core.syn.weights.to(torch.int32)
    dq = (wq_g - wq_c).abs().masked_fill(cols.unsqueeze(-2), 0)
    if int(dq.max()) > 1:
        raise AssertionError("first trial: int8 weights differ by > 1 code")
    if int(dq.max()) == 1:
        w = s_c.w_signed
        rows = torch.stack([w.clamp(min=0), (-w).clamp(min=0)], dim=-2
                           ).reshape(wq_c.shape)
        frac = (rows - rows.floor() - 0.5).abs()
        if bool((frac[dq == 1] >= 1e-4).any()):
            raise AssertionError("first trial: a weight code differs away "
                                 "from a .5 rounding boundary")
    log(f"[3] first trial CPU vs card: {int(flips.sum())} of "
        f"{int(spk_c.sum())} spikes flipped at threshold ({int(cols.sum())} "
        f"columns left out), rates equal elsewhere, max |w_signed diff|="
        f"{dw:.3g}, weight codes differing={int((dq > 0).sum())}")
    phase_breakdown(meta["core"], state0.core, draws.events[0],
                    addr.cuda(), float(np.median(times)))
    return counts, float(np.median(times))


def phase_breakdown(core, st, ev, addr, trial_ms):
    """Where a full-width trial's time goes: CUDA events around each phase
    of ``AnnCore._run_windowed`` (median of 5), the rest being the PPU
    update and the trial's bookkeeping."""
    import torch
    from repro_torch.core import correlation

    def timed(fn):
        return time_ms(fn, 5)
    ie, ii = core._window_currents(st, ev, addr)[1:]
    spikes = core._neuron_window(st.neuron, st.rate_counters, ie, ii,
                                 False)[2][0]
    tau = core.cfg.neuron.tau_syn_exc
    t_cur = timed(lambda: core._window_currents(st, ev, addr))
    t_neu = timed(lambda: core._neuron_window(st.neuron, st.rate_counters,
                                              ie, ii, False))
    t_cor = timed(lambda: correlation.window(
        st.corr, ev, spikes, tau_pre=tau, tau_post=tau, dt=core.cfg.dt))
    torch.cuda.synchronize()
    log(f"[3] trial breakdown (ms): STP scan + 2 synray={t_cur:.3f}, "
        f"neuron window={t_neu:.3f}, corr window={t_cor:.3f}, PPU and "
        f"rest={trial_ms - t_cur - t_neu - t_cor:.3f} (of {trial_ms:.3f})")


def _flatten(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flatten(v)
    else:
        for v in tree:
            yield from _flatten(v)


def phase_closed_loop():
    """The §5 closed loop at 32 x 16 on the card (tests/test_rstdp.py)."""
    import numpy as np
    from repro_torch.core.hybrid import run_training
    t0 = time.perf_counter()
    out, _, meta = run_training(n_trials=450, seed=0, device="cuda")
    secs = time.perf_counter() - t0
    even = meta["even"].cpu().numpy() > 0
    ma = meta["mask_a"] > 0
    mr = out["mean_reward"]

    def trailing(sel, n=150):
        return float(np.mean(np.median(mr[-n:, sel], axis=1)))
    te, to = trailing(even), trailing(~even)
    w = out["w_signed_final"]
    gap = float(w[ma][:, even].mean() - w[ma][:, ~even].mean())
    log(f"[4] closed loop 32 x 16, 450 trials, seed 0: trailing <R> even="
        f"{te:.4f} odd={to:.4f}, A-channel weight gap={gap:.3f} "
        f"({secs:.1f} s, {1e3 * secs / 450:.2f} ms/trial)")
    if not (te > 0.75 and to > 0.75):
        raise AssertionError(f"the closed loop did not learn: {te}, {to}")


def main() -> int:
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_build()
    rows = phase_kernels()
    counts, trial_ms = phase_main_path()
    phase_closed_loop()

    kernels = []
    for name, (source, replaces) in SRC.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
