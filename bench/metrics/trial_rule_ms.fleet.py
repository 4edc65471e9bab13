"""Device time of one trial's reward and PPU rule (all instances of the
fleet together; ``_reward``, ``ppu.apply_rule(_signed_rule)`` with its
6-bit write-back, ``count_dw``), in ms: the mean of the program's
``trial.rule`` region, timed by event-record nodes inside the captured
trial graph on the last trial of every call."""
from harness.spans import span_mean_ms


def read(run):
    return span_mean_ms(run, "trial.rule")
