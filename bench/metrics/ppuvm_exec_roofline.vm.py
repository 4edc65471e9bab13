"""``ppuvm_exec``'s share of its roofline in the traced slice: the least
time the card could take for the programs the slice ran (the larger of
the instructions the program counted over the float32 peak and the
bytes of ``harness.ppu_work`` over the memory bandwidth) over the
kernel's traced device time, in percent. Nothing where the program
counts no programs or the trace holds no ``ppuvm_exec``."""
from harness import kernel_work
from harness.readers import seconds_by_kernel, summary


def read(run):
    s = summary(run)
    if s is None or run.peaks is None:
        return None
    work = run.system.kernel_work(run.trace["calls"],
                                  run.trace["counted"]).get("ppuvm_exec")
    t = seconds_by_kernel(s).get("ppuvm_exec", 0.0)
    if work is None or t <= 0:
        return None
    return 100.0 * kernel_work.roofline_s(*work, run.peaks) / t
