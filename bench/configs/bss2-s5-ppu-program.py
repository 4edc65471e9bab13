"""The system under test for ``bss2-s5-ppu-program``: the port's §5
experiment on a fleet of full-size chips with its rule's vector part as
the PPU-VM program ``signed_dw_program`` (``make_experiment(...,
rule_impl="vm")``: one ``ppuvm_exec`` launch a trial inside the captured
trial graph), and the comparison with the plain reference
``reference.bss2_fleet_ppu``.

Everything but the rule is ``bss2-s5-fullwidth``'s (the module beside
this one): the instance and draws made from the seed, the calls, the
sampled calls and how a call is compared with the reference
(``cols_diverged_pct``, ``unexplained_cols``). The comparison adds two
exact readings on the columns whose rule inputs (rate counters, rewards,
mean rewards and CADC codes, as the eligibilities show them) never
parted from the reference's up to a trial:

- ``dw_q88_lanes_wrong``: synapses of the excitatory rows whose Q8.8 dw
  in that trial differs from the reference's. The program's dw is read
  back from its signed weights: ``w_i = (w_{i-1} + dw) + xi`` in float32
  off the +-45 rails, so ``round(256 (w_i - w_{i-1} - xi))`` in float64
  is its Q8.8 integer (the two roundings are below 2^-16, a 512th of a
  Q8.8 step); a weight on a rail tells nothing of its dw and is skipped.
- ``weight_code_lanes_wrong``: 6-bit weight codes of both Dale rows that
  differ from the reference's: every trial's (the rows of its signed
  weights, through the reference's store) and the stored array the call
  returned.
"""
from __future__ import annotations

import sys
from pathlib import Path

from harness import ppu_work, runner
from reference.bss2_fleet import at_threshold, weight_rows
from reference.bss2_fleet_ppu import FleetPPU

base = runner.load_module(Path(__file__).with_name("bss2-s5-fullwidth.py"),
                          "bench_config_bss2_s5_fullwidth")

RATE_METRIC = base.RATE_METRIC
CALL_METRIC = base.CALL_METRIC
RAIL = 45.0
# words of signed_dw_program: two planes per lane (the CADC codes) and two
# modulator slots (R - <R>, R)
N_PLANES, N_MOD = 2, 2


class System(base.System):
    def __init__(self, ctx):
        super().__init__(ctx)
        # the base builds the python rule's experiment; this configuration
        # runs the vm rule's in its place (nothing of the first has run:
        # the capture is at the warm-up)
        bcfg, ecfg = base._program_config(self.cfg)
        self.init, _, self.meta = self.hybrid.make_experiment(
            cfg=bcfg, ecfg=ecfg, inst=self.inst, prefix=(self.N,),
            backend=self.cfg["backend"], device=ctx.device, rule_impl="vm")
        self.scanned = self.hybrid.make_scanned_training(self.meta)
        self.ppu_before = None

    def warmup(self):
        """The capture, and the ``ppuvm_exec`` launches of each captured
        trial on standard error (one a trial: the program runs in the
        graph, no trial runs eagerly)."""
        super().warmup()
        graphs = [getattr(step, "__self__", None)
                  for _, _, steps in self.meta["scanned_training"]
                  .loops.values() for step in dict.fromkeys(steps)]
        counts = [g.launches.get("ppuvm_exec", 0) for g in graphs
                  if hasattr(g, "launches")]
        if counts:
            print(f"ppuvm_exec launches a replay, each captured trial: "
                  f"{counts}", file=sys.stderr, flush=True)

    # -- correct ----------------------------------------------------------
    def reference(self, precision="fp32"):
        return FleetPPU(self.cfg, self.inst, precision)

    def compare(self, k, start, got, hist, ref):
        """``bss2-s5-fullwidth``'s comparison of call ``k`` (the same
        readings, on the same terms) and the two exact ones."""
        torch = self.torch
        bad = torch.zeros((self.N, self.C), dtype=torch.bool,
                          device=self.ctx.device)
        odd = torch.zeros_like(bad)
        apart = torch.zeros_like(bad)       # rule inputs parted (sticky)
        _, xi = self.draws(k)
        w_prev = [start["w_signed"]]
        wrong = dict(dw_q88_lanes_wrong=0.0, weight_code_lanes_wrong=0.0)

        def each(i, m):
            now = torch.zeros_like(bad)
            for key in ("rates", "reward", "mean_reward"):
                now |= hist[key][i] != m[key]
            apart.logical_or_(now | (hist["elig"][i] != m["elig"]).any(-2))
            for key in ("elig", "w"):
                now |= ((hist[key][i] - m[key]).abs() > base.W_ATOL).any(-2)
            odd.logical_or_(now & ~bad & ~at_threshold(m["closest"],
                                                       ref.p))
            bad.logical_or_(now)
            same = ~apart.unsqueeze(-2)
            w = hist["w"][i]
            dw = torch.round((w.double() - w_prev[0].double()
                              - xi[i].double()) * 256.0).to(torch.int64)
            off_rail = w.abs() < RAIL
            wrong["dw_q88_lanes_wrong"] += float(
                ((dw != m["dw_q88"]) & off_rail & same).sum())
            codes = weight_rows(w) != weight_rows(m["w"])
            wrong["weight_code_lanes_wrong"] += float((codes & same).sum())
            w_prev[0] = w
        fin = ref.run({key: v.clone() for key, v in start.items()},
                      self.stims, *self.draws(k), each=each)
        now = torch.zeros_like(bad)
        for key in ("v", "w_adapt", "i_exc", "i_inh", "refrac",
                    "trace_post", "rates", "mean_reward"):
            now |= ((got[key] - fin[key]).abs()
                    > base.STATE_ATOL + base.STATE_RTOL * fin[key].abs())
        for key in ("weights", "a_causal", "a_acausal"):
            now |= (got[key] != fin[key]).any(-2)
        now |= ((got["w_signed"] - fin["w_signed"]).abs()
                > base.W_ATOL).any(-2)
        rows = ((got["r"] != fin["r"]) | (got["trace_pre"]
                                         != fin["trace_pre"])).any(-1)
        now |= rows.unsqueeze(-1)
        odd |= now & ~bad
        bad |= now
        wrong["weight_code_lanes_wrong"] += float(
            ((got["weights"] != fin["weights"]) & ~apart.unsqueeze(-2)).sum())
        return dict(cols_diverged_pct=100.0 * float(bad.float().mean()),
                    unexplained_cols=float(odd.sum()), **wrong)

    # -- what the per-layer readers count -----------------------------------
    def ppu_counts(self):
        """The program's host counters of the PPU program: runs and
        instructions (0 where the program keeps none)."""
        s = self.meta["timer"].counters
        return {k: s.get(f"ppu.{k}", 0) for k in ("programs",
                                                  "instructions")}

    def trace_begin(self):
        super().trace_begin()
        self.ppu_before = self.ppu_counts()

    def trace_end(self):
        """The traced calls' output spikes and the programs and
        instructions the program counted over them."""
        after = self.ppu_counts()
        out = {k: after[k] - self.ppu_before[k] for k in after}
        return dict(out, n_post=super().trace_end())

    def kernel_work(self, calls, counted):
        """``bss2-s5-fullwidth``'s kernels and ``ppuvm_exec``: a program
        run's bytes (``harness.ppu_work``, int8 weights) times the runs the
        program counted, its operations the instructions it counted; left
        out where the program counts none."""
        tot = super().kernel_work(calls, counted["n_post"])
        if counted["programs"] and counted["instructions"]:
            _, nbytes = ppu_work.ppuvm_exec(self.N, self.R, self.C,
                                            ppu_work.SIGNED_DW_WORDS,
                                            N_PLANES, N_MOD)
            tot["ppuvm_exec"] = (float(counted["instructions"]),
                                 nbytes * counted["programs"])
        return tot


def setup(ctx):
    return System(ctx)
