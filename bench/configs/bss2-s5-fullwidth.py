"""The system under test for ``bss2-s5-fullwidth``: the port's §5
experiment on a fleet of full-size chips, driven through its public
entry points, and the comparison with the plain reference.

Set-up makes the fleet's instance and a pool of draws on the device from
the seed (``harness.traffic``), builds ``repro_torch.core.hybrid
.make_experiment(cfg, ecfg, inst=, prefix=(N,))`` and warms up its
``make_scanned_training`` call: the first call of the shape captures one
trial as a CUDA graph, every later call loads its state and draws into it
and replays it once a trial. A call runs ``trials_per_call`` trials; a
user's experiment is ``calls_per_experiment`` calls, each continuing from
the state the last one returned, and the next one starts from a fresh
``init()``. A call ends with its state and histories on the device.

``correct``: calls drawn from the seed are kept, and after the window the
reference (``reference.bss2_fleet``) runs each from the state it started
from: the reference's own initial state for the first call of an
experiment (so that the program's ``init()`` is checked with it), the
program's state for a continuing call. Trial by trial it compares the
rate counters, rewards, mean rewards, eligibilities and signed weights the
call returned, and then its final state, column by column (``compare``).
"""
from __future__ import annotations

import gc

import numpy as np

from harness import kernel_work, traffic
from reference.bss2_fleet import Fleet, at_threshold, stp_scale

RATE_METRIC = "instance_trials_per_s"
CALL_METRIC = "scan_call_ms_p95"
# per-column tolerance of the carried neuron state: ulps of currents
# summed in another order, far below any physical difference
STATE_ATOL, STATE_RTOL = 1e-3, 1e-4
W_ATOL = 1e-3


def _program_config(cfg: dict):
    """The port's ``BSS2Config`` and ``RSTDPConfig`` holding the numbers of
    the configuration file."""
    from repro_torch.configs.bss2 import (BSS2Config, MismatchParams,
                                          NeuronParams)
    from repro_torch.core.hybrid import RSTDPConfig
    chip = dict(cfg["chip"])
    neuron = NeuronParams(**chip.pop("neuron"))
    mism = MismatchParams(**chip.pop("mismatch"))
    return (BSS2Config(neuron=neuron, mismatch=mism, **chip),
            RSTDPConfig(**cfg["experiment"]))


def state_dict(st) -> dict:
    """An ``ExperimentState`` of the port as the reference's state."""
    c = st.core
    return dict(v=c.neuron.v, w_adapt=c.neuron.w, i_exc=c.neuron.i_exc,
                i_inh=c.neuron.i_inh, refrac=c.neuron.refrac, r=c.stp.r,
                trace_pre=c.corr.trace_pre, trace_post=c.corr.trace_post,
                a_causal=c.corr.a_causal, a_acausal=c.corr.a_acausal,
                weights=c.syn.weights, rates=c.rate_counters,
                w_signed=st.w_signed, mean_reward=st.mean_reward)


class System:
    def __init__(self, ctx):
        torch = ctx.torch
        self.torch, self.ctx = torch, ctx
        cfg, mix = ctx.config, ctx.mix
        chip, exp = cfg["chip"], cfg["experiment"]
        self.cfg = cfg
        self.N = int(mix["instances"])
        self.n = int(mix["trials_per_call"])
        self.per_experiment = int(mix["calls_per_experiment"])
        self.units_per_call = self.N * self.n
        self.T, self.I, self.C = (exp["trial_steps"], exp["n_inputs"],
                                  exp["n_neurons"])
        self.R = 2 * self.I
        gen = traffic.generator(ctx.seed, ctx.device)
        self.inst = traffic.instance(gen, chip, (self.N,), self.R, self.C)
        self.stims = traffic.stimuli(self.n, mix["stimulus_cycle"])
        self.pool = [traffic.s5_draws(gen, exp, self.stims, (self.N,))
                     for _ in range(int(mix["draw_pool_calls"]))]
        from repro_torch.core import hybrid
        self.hybrid = hybrid
        bcfg, ecfg = _program_config(cfg)
        self.init, _, self.meta = hybrid.make_experiment(
            cfg=bcfg, ecfg=ecfg, inst=self.inst, prefix=(self.N,),
            backend=cfg["backend"], device=ctx.device)
        self.scanned = hybrid.make_scanned_training(self.meta)
        chk = mix["check"]
        rng = np.random.default_rng(ctx.seed)
        below = int(chk["sample_below"])
        fresh = list(range(0, below, self.per_experiment))
        self.sample = set(int(k) for k in rng.choice(
            fresh, size=int(chk["fresh_calls"]), replace=False))
        if chk.get("continuing_calls", 0):
            self.sample |= set(traffic.pick(rng, 0, below,
                                            int(chk["continuing_calls"]),
                                            exclude=fresh))
        self.limits = chk["limits"]
        self.kept, self.state = {}, None
        self.spikes = None          # per-call spike totals while tracing

    def draws(self, k):
        ev, xi = self.pool[k % len(self.pool)]
        return self.hybrid.Draws(events=ev, xi=xi)

    def warmup(self):
        """The call's one shape: the capture at the first call."""
        st, hist = self.scanned(self.init(), self.stims, self.draws(0))
        del st, hist

    def call(self, k: int):
        st_in = (self.init() if k % self.per_experiment == 0
                 else self.state)
        st, hist = self.scanned(st_in, self.stims, self.draws(k))
        if k in self.sample:
            self.kept[k] = (st_in, st, hist)
        if self.spikes is not None:
            self.spikes.append(hist["rates"].sum())
        self.state = st

    def counters(self):
        """The port's [dense, sparse] route counter of the device."""
        from repro_torch.core import synapse
        return {"routes": synapse.route_counts(self.ctx.device).clone()}

    def release(self):
        """Drop the program's loop, graph and draws but what the kept
        calls need."""
        keep = {k % len(self.pool) for k in self.kept}
        self.pool = [p if i in keep else None
                     for i, p in enumerate(self.pool)]
        self.meta["scanned_training"].loops.clear()
        self.state = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- correct ----------------------------------------------------------
    def reference(self, precision="fp32"):
        return Fleet(self.cfg, self.inst, precision)

    def start_of(self, k, st_in, ref: Fleet):
        """The state call ``k`` started from, as the reference takes it:
        the reference's own initial state for an experiment's first call,
        the program's state for a continuing one."""
        if k % self.per_experiment == 0:
            return ref.init_state()
        return {key: v.clone() for key, v in state_dict(st_in).items()}

    def control_outputs(self, k, start, precision):
        """Call ``k`` computed by the reference in ``precision`` from
        ``start``, in the program's form: (final state, histories)."""
        ctrl = self.reference(precision)
        hist = {}

        def keep(i, m):
            for key, v in m.items():
                hist.setdefault(key, []).append(v)
        fin = ctrl.run(start, self.stims, *self.draws(k), each=keep)
        return fin, {key: self.torch.stack(v) for key, v in hist.items()}

    def compare(self, k, start, got, hist, ref: Fleet):
        """Run call ``k`` on ``ref`` from ``start`` and compare its outputs
        with the call's histories ``hist`` and final state ``got`` (the
        reference's form). A column is diverged from the first trial whose
        rate counter, reward, mean reward, eligibility or signed weights
        differ, or whose final state does. The first divergence of a
        column is explained only by a spike at the threshold: in that
        trial the reference's membrane came within ``at_threshold`` of
        it. Returns the readings of this call."""
        torch = self.torch
        bad = torch.zeros((self.N, self.C), dtype=torch.bool,
                          device=self.ctx.device)
        odd = torch.zeros_like(bad)

        def each(i, m):
            now = torch.zeros_like(bad)
            for key in ("rates", "reward", "mean_reward"):
                now |= hist[key][i] != m[key]
            for key in ("elig", "w"):
                now |= ((hist[key][i] - m[key]).abs() > W_ATOL).any(-2)
            odd.logical_or_(now & ~bad & ~at_threshold(m["closest"],
                                                       ref.p))
            bad.logical_or_(now)
        fin = ref.run({key: v.clone() for key, v in start.items()},
                      self.stims, *self.draws(k), each=each)
        now = torch.zeros_like(bad)
        for key in ("v", "w_adapt", "i_exc", "i_inh", "refrac",
                    "trace_post", "rates", "mean_reward"):
            now |= ((got[key] - fin[key]).abs()
                    > STATE_ATOL + STATE_RTOL * fin[key].abs())
        for key in ("weights", "a_causal", "a_acausal"):
            now |= (got[key] != fin[key]).any(-2)
        now |= ((got["w_signed"] - fin["w_signed"]).abs() > W_ATOL).any(-2)
        # the drivers' state (STP resources, pre traces) belongs to every
        # column of its instance
        rows = ((got["r"] != fin["r"]) | (got["trace_pre"]
                                         != fin["trace_pre"])).any(-1)
        now |= rows.unsqueeze(-1)
        odd |= now & ~bad
        bad |= now
        return dict(cols_diverged_pct=100.0 * float(bad.float().mean()),
                    unexplained_cols=float(odd.sum()))

    def check(self, control=None):
        """Readings of every kept call against the reference. Returns
        ``(readings, n_failed, n_missing)``: for each number its worst
        over the kept calls beside its limit, the kept calls that read
        over a limit, and the sampled calls the window never ran. With
        ``control`` (a precision of the reference) the reference computed
        in it stands in the program's place."""
        ref = self.reference()
        missing = len(self.sample - set(self.kept))
        worst, failed = {}, 0
        for k in sorted(self.kept):
            st_in, st_out, hist = self.kept.pop(k)
            start = self.start_of(k, st_in, ref)
            if control is None:
                out = state_dict(st_out)
            else:
                out, hist = self.control_outputs(k, start, control)
            got = self.compare(k, start, out, hist, ref)
            del st_in, st_out, hist, out, start
            failed += any(v > self.limits[n] for n, v in got.items())
            for n, v in got.items():
                worst[n] = max(worst.get(n, 0.0), v)
        return ({n: (v, self.limits[n]) for n, v in worst.items()},
                int(failed), missing)

    # -- what the per-layer readers count -----------------------------------
    def trace_begin(self):
        self.spikes = []

    def trace_end(self):
        n_post = float(sum(float(s) for s in self.spikes))
        self.spikes = None
        return n_post

    def kernel_work(self, calls, n_post):
        """{kernel: (flops, bytes)} of the port's kernels over ``calls``,
        ``n_post`` output spikes among them: per trial one census-form STP
        scan over all rows, the two Dale halves' products (each half
        computed by one of its two route kernels, as the census decided:
        the FMAs its events need and the smaller of the two routes'
        bytes), the neuron window and the correlation window."""
        T, N, R, C, n = self.T, self.N, self.R, self.C, self.n
        pos = (stp_scale(self.inst) > 0).to(self.torch.float32)   # [N, R]
        tot = {}

        def add(name, fb, times=1.0):
            f, b = tot.get(name, (0.0, 0.0))
            tot[name] = (f + fb[0] * times, b + fb[1] * times)
        for k in calls:
            ev, _ = self.pool[k % len(self.pool)]
            for h in (0, 1):
                n_ev = float((ev[..., h::2] * pos[:, h::2]).sum())
                dense = kernel_work.synray(T, N, R // 2, C, n_ev / n)
                sparse = kernel_work.synray_sparse(T, N, R // 2, C, n_ev / n)
                add("synray+synray_sparse", (dense[0], min(dense[1],
                                                           sparse[1])), n)
            add("stp_scan", kernel_work.stp_scan(T, N, R), n)
            add("neuron_scan", kernel_work.neuron_scan(T, N, C), n)
            add("corr", kernel_work.corr(T, N, R, C, float(ev.sum()) / n,
                                         0.0), n)
        f, b = tot["corr"]
        tot["corr"] = (f + 3 * R * n_post, b)
        return tot

    def trials(self, calls):
        return self.n * len(calls)

    def model_flops(self, calls):
        return (kernel_work.s5_model_flops(self.R, self.C, self.T)
                * self.N * self.n * len(calls))


def setup(ctx):
    return System(ctx)
