"""Phase-level timing for the emulation stack (``repro/obs/timing.py``).

Host-side instrumentation: PyTorch returns before the card finishes, so a
span on a CUDA device is timed with CUDA events on the current stream
(recorded around the body, read once the end event has completed); on
the CPU, where every operation has finished when it returns, with the
host clock.

``PhaseTimer``
    Accumulating named spans: ``with timer.span("synray"):`` times the
    body; ``time_fn`` times a function after unrecorded warm-up calls;
    ``summary()`` gives count/total/mean/best per phase.

``profile_phases``
    Times one AnnCore window phase by phase: the STP scan and synaptic
    currents (``_window_currents``), the neuron window
    (``_neuron_window``) and the correlation window
    (``correlation.window``), each called on its own, and the whole
    ``core.run`` (``total``, the ground truth: the split re-launches each
    phase, so it attributes time, it does not add up to a window).

``profiler_trace``
    A ``torch.profiler`` trace of the body into a directory (``None``: a
    no-op).

``eviction_storm``
    The reference's predicate on a specializer-cache delta, which the run
    report uses; the cache it watches (``repro/ppuvm/specialize.py``) is
    not ported (ROADMAP.md), so nothing here takes snapshots of it.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device


class PhaseTimer:
    """Accumulating named spans on ``device`` (``None`` means ``cuda`` and
    raises without a card): CUDA events there, the host clock on the
    CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.samples: Dict[str, List[float]] = {}

    @contextmanager
    def span(self, name: str):
        if self.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            b.synchronize()
            dt = a.elapsed_time(b) * 1e-3
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.samples.setdefault(name, []).append(dt)

    def time_fn(self, name: str, fn, *args, iters: int = 1, warmup: int = 1,
                **kw):
        """Time ``fn(*args, **kw)`` ``iters`` times (after ``warmup``
        unrecorded calls: kernel builds and lazy caches), one span per
        call. Returns the last result."""
        out = None
        for _ in range(warmup):
            out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for _ in range(iters):
            with self.span(name):
                out = fn(*args, **kw)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase {count, total_us, mean_us, best_us}."""
        out = {}
        for name, ts in self.samples.items():
            out[name] = dict(count=len(ts), total_us=sum(ts) * 1e6,
                             mean_us=sum(ts) / len(ts) * 1e6,
                             best_us=min(ts) * 1e6)
        return out


def profile_phases(core, state, row_spikes_t, row_addr_t, iters: int = 5,
                   timer: Optional[PhaseTimer] = None
                   ) -> Dict[str, Dict[str, float]]:
    """Per-phase timings of one AnnCore window on ``core``'s device and
    backend (``synray``, ``neuron``, ``corr``, ``total``; see the module
    docstring)."""
    from repro_torch.core import correlation
    timer = timer or PhaseTimer(core.device)
    cfg = core.cfg
    _, i_exc_t, i_inh_t, _ = timer.time_fn(
        "synray", core._window_currents, state, row_spikes_t, row_addr_t,
        iters=iters)
    timer.time_fn("neuron", core._neuron_window, state.neuron,
                  state.rate_counters, i_exc_t, i_inh_t, False, iters=iters)
    zero_sp = torch.zeros((*row_spikes_t.shape[:-1], cfg.n_cols),
                          dtype=torch.float32, device=core.device)
    timer.time_fn("corr", correlation.window, state.corr, row_spikes_t,
                  zero_sp, tau_pre=cfg.neuron.tau_syn_exc,
                  tau_post=cfg.neuron.tau_syn_exc, dt=cfg.dt, iters=iters)
    timer.time_fn("total", core.run, state, row_spikes_t, row_addr_t,
                  iters=iters)
    return timer.summary()


@contextmanager
def profiler_trace(logdir: Optional[str]):
    """Collect a ``torch.profiler`` trace of the body (CPU activity, and
    the card's where there is one) into ``logdir/trace.json`` (viewable in
    Perfetto). ``None`` makes this a no-op, so callers can thread the
    knob through unconditionally."""
    if logdir is None:
        yield
        return
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def eviction_storm(delta: dict) -> bool:
    """True when a cache-stats delta shows more misses than the LRU
    capacity: the working set cannot fit and every upload recompiles."""
    return delta.get("misses", 0) > delta.get("max_size", 0) > 0
