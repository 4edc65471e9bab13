"""The port's hand-written kernels in the traced slice of a fleet cell:
the sum of each kernel's roofline time (``harness.kernel_work``: the
larger of its FLOPs over the float32 peak and its bytes over the memory
bandwidth, counted from the shapes and the inputs) over the sum of their
traced device time, in percent. Each kernel's own share is kept on the
run (``kernel_shares``) for the result line."""
from harness import kernel_work
from harness.readers import seconds_by_kernel, summary


def read(run):
    s = summary(run)
    if s is None or run.peaks is None:
        return None
    secs = seconds_by_kernel(s)
    work = run.system.kernel_work(run.trace["calls"], run.trace["counted"])
    shares, best, spent = {}, 0.0, 0.0
    for key, (flops, nbytes) in work.items():
        t = sum(secs.get(k, 0.0) for k in key.split("+"))
        if t <= 0:
            return None
        r = kernel_work.roofline_s(flops, nbytes, run.peaks)
        shares[key] = 100.0 * r / t
        best, spent = best + r, spent + t
    run.kernel_shares = shares
    return 100.0 * best / spent
