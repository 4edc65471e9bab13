"""Phase-level timing for the emulation stack (``repro/obs/timing.py``).

One recorder, ``PhaseTimer``: named spans, counters, and regions timed
inside a captured CUDA graph. Nothing in it waits for the card on the hot
path.

``PhaseTimer``
    Accumulating named spans: ``with timer.span("load"):`` times the body.
    On a CUDA device it records a start and an end ``torch.cuda.Event`` on
    the current stream and returns without waiting; the pair is folded
    into the samples once its end event has completed (``query()``), at
    the end of a later span (after the body has queued its work, so the
    reads overlap it) or in ``summary()``, which waits for the pending end
    events. ``span(name, host=True)`` times on the host clock on any
    device, for code that already synchronises or does only host work; on
    the CPU every span does. Every span also opens
    ``torch.profiler.record_function(name)``, so under a profiler it lands
    in the trace beside the device operations. ``count(name, n)`` adds to
    a counter; ``time_fn`` times a function after unrecorded warm-up
    calls; ``summary()`` gives count / total / mean / best per span and
    the counters. ``regions(names)`` makes a ``Regions`` for a loop body
    that a graph captures; ``take(regions)`` folds its times in once its
    last mark has completed; ``rearm(regions)``, called before its marks
    are recorded again, folds or drops a sample still pending.
    ``PhaseTimer(device, enabled=False)`` records nothing.

``Regions``
    ``k`` named regions between ``k + 1`` marks: ``mark(i)`` records event
    ``i`` on the current stream (``external=True``: under a capture each
    record becomes an event-record node, so every replay records it
    again; it is not a kernel). On the CPU a mark reads the host clock.

``PROCESS``
    The process-wide timer (host spans only) of what belongs to no
    experiment: the kernel library's build (``kernels.build``,
    ``kernels.built``, ``kernels.reused``) and the captures of loops
    given no timer (``graph.*``).

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
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import resolve_device


class Regions:
    """``k`` named regions between ``k + 1`` marks on ``device``: the
    region ``names[i]`` runs from mark ``i`` to mark ``i + 1``. On a CUDA
    device each mark is a timing event recorded on the current stream
    (``external``: as an event-record node when a graph captures it); on
    the CPU, where the body runs synchronously, the host clock."""

    def __init__(self, names: Sequence[str], device, external: bool = False):
        self.names = tuple(names)
        self.cuda = torch.device(device).type == "cuda"
        n = len(self.names) + 1
        self.marks = ([torch.cuda.Event(enable_timing=True, external=external)
                       for _ in range(n)] if self.cuda else [None] * n)

    def mark(self, i: int):
        if self.cuda:
            self.marks[i].record()
        else:
            self.marks[i] = time.perf_counter()

    def done(self) -> bool:
        """The last mark has completed (never waits)."""
        return not self.cuda or self.marks[-1].query()

    def wait(self):
        if self.cuda:
            self.marks[-1].synchronize()

    def read(self):
        """[(name, seconds)] of the regions, once ``done()``."""
        m = self.marks
        if self.cuda:
            return [(n, a.elapsed_time(b) * 1e-3)
                    for n, a, b in zip(self.names, m, m[1:])]
        return [(n, b - a) for n, a, b in zip(self.names, m, m[1:])]


class PhaseTimer:
    """Accumulating named spans and counters on ``device`` (``None`` means
    ``cuda`` and raises without a card): CUDA events there, read without
    waiting once they have completed; the host clock on the CPU and for
    ``host=True`` spans. ``enabled=False`` records nothing."""

    # spans and regions waiting for their end event; past this many the
    # oldest is dropped (counted in ``timer.dropped``), never waited for
    PENDING_MAX = 1024

    def __init__(self, device=None, enabled: bool = True):
        self.device = resolve_device(device)
        self.enabled = enabled
        self._samples: Dict[str, List[float]] = {}
        self.counters: Dict[str, int] = {}
        self._pending: List[Regions] = []

    @property
    def samples(self) -> Dict[str, List[float]]:
        """{span: [seconds, ...]}, every pending span folded in (waits)."""
        self._fold(wait=True)
        return self._samples

    def _fold(self, wait: bool = False):
        keep = []
        for p in self._pending:
            if wait:
                p.wait()
            if p.done():
                for name, dt in p.read():
                    self._samples.setdefault(name, []).append(dt)
            else:
                keep.append(p)
        self._pending = keep

    @contextmanager
    def span(self, name: str, host: bool = False):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(name):
            if self.device.type == "cuda" and not host:
                r = Regions((name,), self.device)
                r.mark(0)
                yield
                r.mark(1)
                self.take(r)
            else:
                t0 = time.perf_counter()
                yield
                self._samples.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def count(self, name: str, n: int = 1):
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def regions(self, names: Sequence[str]) -> Optional[Regions]:
        """A ``Regions`` of ``names`` for a body that a CUDA graph may
        capture, or ``None`` when the timer is off (the body then marks
        nothing and the graph holds no event node)."""
        if not self.enabled:
            return None
        return Regions(names, self.device, external=True)

    def take(self, regions: Regions):
        """Fold ``regions``' times in once its last mark has completed: now
        if it has, else at a later span or ``summary()``. A ``Regions``
        that a graph's replays record again is taken once per recording,
        with ``rearm`` before the replay that records it again: a sample
        still pending then is lost, and counted in ``timer.dropped``."""
        self._pending.append(regions)
        if len(self._pending) > self.PENDING_MAX:
            self._pending.pop(0)
            self.count("timer.dropped")
        self._fold()

    def rearm(self, regions: Regions):
        """Before ``regions`` is recorded again (a graph's next replay of
        its marks): its pending sample is folded in if it has completed,
        else dropped and counted in ``timer.dropped``, since the new
        records overwrite it. Never waits."""
        if regions in self._pending:
            self._fold()
            if regions in self._pending:
                self._pending.remove(regions)
                self.count("timer.dropped")

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
        """Per span {count, total_us, mean_us, best_us} (waits for the
        pending ones), and per counter {count}."""
        out = {}
        for name, ts in self.samples.items():
            out[name] = dict(count=len(ts), total_us=sum(ts) * 1e6,
                             mean_us=sum(ts) / len(ts) * 1e6,
                             best_us=min(ts) * 1e6)
        for name, n in self.counters.items():
            out[name] = dict(count=n)
        return out


PROCESS = PhaseTimer("cpu")


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

