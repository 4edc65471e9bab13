"""Device time a trial (all instances of the fleet together) spends in
operations that are not the port's hand-written kernels: PyTorch's copies,
elementwise and indexing kernels of the trial graph and the rule, in ms,
from the traced slice."""
from harness.readers import seconds_by_kernel, summary


def read(run):
    s = summary(run)
    if s is None:
        return None
    trials = run.system.trials(run.trace["calls"])
    return 1e3 * seconds_by_kernel(s).get(None, 0.0) / trials
